"""Geometry kernel of the port: host (numpy-vectorized) implementations of
the geometry primitives, copied from ``citlab_as_tpu/geometry``. The JAX
package's optional host C library (``geometry/native.py``) is not ported:
every function here takes the numpy path."""
from citlab_as_tpu_torch.geometry.rectangle import Rectangle
from citlab_as_tpu_torch.geometry.polygon import (
    Polygon,
    blow_up,
    thin_out,
    norm_poly_dists,
    calc_reg_line_stats,
    string_to_poly,
    poly_to_string,
)

__all__ = [
    "Rectangle",
    "Polygon",
    "blow_up",
    "thin_out",
    "norm_poly_dists",
    "calc_reg_line_stats",
    "string_to_poly",
    "poly_to_string",
]
