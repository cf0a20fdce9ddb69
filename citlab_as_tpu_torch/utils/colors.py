"""Article colour palette (port of ``citlab_as_tpu/utils/colors.py``;
reference: python_util/plot/colors.py).

A fixed 52-colour palette for article visualisation, extended by the
shuffled CSS4 colour names so arbitrarily many articles stay
distinguishable. The JAX module extends it from matplotlib's tables when
matplotlib is importable; the port keeps its own copy of those tables
(matplotlib's BASE, TABLEAU ``tab:*`` and CSS4 name -> colour maps) and of
matplotlib's ``rgb_to_hsv``, so :data:`COLORS` is the same list, in the same
order, that the JAX module builds with matplotlib present. :func:`to_rgba`
is the name -> RGBA lookup that the port's raster plots draw with.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

DEFAULT_COLOR = "k"

COLORS = [
    "darkgreen", "red", "darkviolet", "darkblue",
    "gold", "darkorange", "brown", "yellowgreen", "darkcyan",

    "darkkhaki", "firebrick", "darkorchid", "deepskyblue",
    "peru", "orangered", "rosybrown", "burlywood", "cadetblue",

    "olivedrab", "palevioletred", "plum", "slateblue",
    "tan", "coral", "sienna", "yellow", "mediumaquamarine",

    "forestgreen", "indianred", "blueviolet", "steelblue",
    "silver", "salmon", "darkgoldenrod", "greenyellow", "darkturquoise",

    "mediumseagreen", "crimson", "rebeccapurple", "navy",
    "darkgray", "saddlebrown", "maroon", "lawngreen", "royalblue",

    "springgreen", "tomato", "violet", "azure",
    "goldenrod", "chocolate", "chartreuse", "teal",
]

# matplotlib's colour tables (matplotlib/_color_data.py), by value
BASE_COLORS = {
    "b": (0, 0, 1), "g": (0, 0.5, 0), "r": (1, 0, 0), "c": (0, 0.75, 0.75),
    "m": (0.75, 0, 0.75), "y": (0.75, 0.75, 0), "k": (0, 0, 0), "w": (1, 1, 1),
}
TABLEAU_COLORS = {
    "tab:blue": "#1f77b4",
    "tab:orange": "#ff7f0e",
    "tab:green": "#2ca02c",
    "tab:red": "#d62728",
    "tab:purple": "#9467bd",
    "tab:brown": "#8c564b",
    "tab:pink": "#e377c2",
    "tab:gray": "#7f7f7f",
    "tab:olive": "#bcbd22",
    "tab:cyan": "#17becf",
}
CSS4_COLORS = {
    "aliceblue": "#F0F8FF", "antiquewhite": "#FAEBD7", "aqua": "#00FFFF",
    "aquamarine": "#7FFFD4", "azure": "#F0FFFF", "beige": "#F5F5DC",
    "bisque": "#FFE4C4", "black": "#000000", "blanchedalmond": "#FFEBCD",
    "blue": "#0000FF", "blueviolet": "#8A2BE2", "brown": "#A52A2A",
    "burlywood": "#DEB887", "cadetblue": "#5F9EA0", "chartreuse": "#7FFF00",
    "chocolate": "#D2691E", "coral": "#FF7F50", "cornflowerblue": "#6495ED",
    "cornsilk": "#FFF8DC", "crimson": "#DC143C", "cyan": "#00FFFF",
    "darkblue": "#00008B", "darkcyan": "#008B8B", "darkgoldenrod": "#B8860B",
    "darkgray": "#A9A9A9", "darkgreen": "#006400", "darkgrey": "#A9A9A9",
    "darkkhaki": "#BDB76B", "darkmagenta": "#8B008B", "darkolivegreen": "#556B2F",
    "darkorange": "#FF8C00", "darkorchid": "#9932CC", "darkred": "#8B0000",
    "darksalmon": "#E9967A", "darkseagreen": "#8FBC8F", "darkslateblue": "#483D8B",
    "darkslategray": "#2F4F4F", "darkslategrey": "#2F4F4F",
    "darkturquoise": "#00CED1", "darkviolet": "#9400D3", "deeppink": "#FF1493",
    "deepskyblue": "#00BFFF", "dimgray": "#696969", "dimgrey": "#696969",
    "dodgerblue": "#1E90FF", "firebrick": "#B22222", "floralwhite": "#FFFAF0",
    "forestgreen": "#228B22", "fuchsia": "#FF00FF", "gainsboro": "#DCDCDC",
    "ghostwhite": "#F8F8FF", "gold": "#FFD700", "goldenrod": "#DAA520",
    "gray": "#808080", "green": "#008000", "greenyellow": "#ADFF2F",
    "grey": "#808080", "honeydew": "#F0FFF0", "hotpink": "#FF69B4",
    "indianred": "#CD5C5C", "indigo": "#4B0082", "ivory": "#FFFFF0",
    "khaki": "#F0E68C", "lavender": "#E6E6FA", "lavenderblush": "#FFF0F5",
    "lawngreen": "#7CFC00", "lemonchiffon": "#FFFACD", "lightblue": "#ADD8E6",
    "lightcoral": "#F08080", "lightcyan": "#E0FFFF",
    "lightgoldenrodyellow": "#FAFAD2", "lightgray": "#D3D3D3",
    "lightgreen": "#90EE90", "lightgrey": "#D3D3D3", "lightpink": "#FFB6C1",
    "lightsalmon": "#FFA07A", "lightseagreen": "#20B2AA", "lightskyblue": "#87CEFA",
    "lightslategray": "#778899", "lightslategrey": "#778899",
    "lightsteelblue": "#B0C4DE", "lightyellow": "#FFFFE0", "lime": "#00FF00",
    "limegreen": "#32CD32", "linen": "#FAF0E6", "magenta": "#FF00FF",
    "maroon": "#800000", "mediumaquamarine": "#66CDAA", "mediumblue": "#0000CD",
    "mediumorchid": "#BA55D3", "mediumpurple": "#9370DB",
    "mediumseagreen": "#3CB371", "mediumslateblue": "#7B68EE",
    "mediumspringgreen": "#00FA9A", "mediumturquoise": "#48D1CC",
    "mediumvioletred": "#C71585", "midnightblue": "#191970", "mintcream": "#F5FFFA",
    "mistyrose": "#FFE4E1", "moccasin": "#FFE4B5", "navajowhite": "#FFDEAD",
    "navy": "#000080", "oldlace": "#FDF5E6", "olive": "#808000",
    "olivedrab": "#6B8E23", "orange": "#FFA500", "orangered": "#FF4500",
    "orchid": "#DA70D6", "palegoldenrod": "#EEE8AA", "palegreen": "#98FB98",
    "paleturquoise": "#AFEEEE", "palevioletred": "#DB7093", "papayawhip": "#FFEFD5",
    "peachpuff": "#FFDAB9", "peru": "#CD853F", "pink": "#FFC0CB", "plum": "#DDA0DD",
    "powderblue": "#B0E0E6", "purple": "#800080", "rebeccapurple": "#663399",
    "red": "#FF0000", "rosybrown": "#BC8F8F", "royalblue": "#4169E1",
    "saddlebrown": "#8B4513", "salmon": "#FA8072", "sandybrown": "#F4A460",
    "seagreen": "#2E8B57", "seashell": "#FFF5EE", "sienna": "#A0522D",
    "silver": "#C0C0C0", "skyblue": "#87CEEB", "slateblue": "#6A5ACD",
    "slategray": "#708090", "slategrey": "#708090", "snow": "#FFFAFA",
    "springgreen": "#00FF7F", "steelblue": "#4682B4", "tan": "#D2B48C",
    "teal": "#008080", "thistle": "#D8BFD8", "tomato": "#FF6347",
    "turquoise": "#40E0D0", "violet": "#EE82EE", "wheat": "#F5DEB3",
    "white": "#FFFFFF", "whitesmoke": "#F5F5F5", "yellow": "#FFFF00",
    "yellowgreen": "#9ACD32",
}


def to_rgba(color: str, alpha: Optional[float] = None
            ) -> Tuple[float, float, float, float]:
    """matplotlib's ``to_rgba`` for the names of the tables above, ``"none"``
    and ``#rrggbb[aa]``: floats in [0, 1]; ``alpha`` replaces the colour's
    own alpha (except for ``"none"``, which is always transparent)."""
    if color.lower() == "none":
        return (0.0, 0.0, 0.0, 0.0)
    if color in BASE_COLORS:
        rgba = tuple(float(v) for v in BASE_COLORS[color]) + (1.0,)
    else:
        hexval = TABLEAU_COLORS.get(color) or CSS4_COLORS.get(color.lower()) or color
        if not (hexval.startswith("#") and len(hexval) in (7, 9)):
            raise ValueError(f"unknown colour {color!r}")
        rgba = tuple(int(hexval[i:i + 2], 16) / 255 for i in range(1, len(hexval), 2))
        if len(rgba) == 3:
            rgba += (1.0,)
    if alpha is not None:
        rgba = rgba[:3] + (float(alpha),)
    return rgba


def rgb_to_hsv(arr) -> np.ndarray:
    """matplotlib's ``rgb_to_hsv``: float RGB in [0, 1] (..., 3) -> HSV."""
    arr = np.asarray(arr)
    if arr.shape[-1] != 3:
        raise ValueError("Last dimension of input array must be 3; "
                         f"shape {arr.shape} was found.")
    in_shape = arr.shape
    arr = np.array(arr, dtype=np.promote_types(arr.dtype, np.float32), ndmin=2)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    if np.any(arr_max > 1) or arr.min() < 0:
        raise ValueError("Input array must be in the range [0, 1].")
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    # red is max
    idx = (arr[..., 0] == arr_max) & ipos
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    # green is max
    idx = (arr[..., 1] == arr_max) & ipos
    out[idx, 0] = 2. + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    # blue is max
    idx = (arr[..., 2] == arr_max) & ipos
    out[idx, 0] = 4. + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out.reshape(in_shape)


def _extend_with_css4() -> None:
    base = dict(BASE_COLORS)
    base.pop(DEFAULT_COLOR, None)
    all_colors = dict(base, **CSS4_COLORS)
    by_hsv = sorted((tuple(rgb_to_hsv(to_rgba(name)[:3])), name) for name in all_colors)
    sorted_names = [name for _, name in by_hsv]
    rng = random.Random(501)
    rng.shuffle(sorted_names)
    for color in sorted_names:
        if color not in COLORS:
            COLORS.append(color)


_extend_with_css4()


def get_article_color(index: int) -> str:
    return COLORS[index % len(COLORS)]
