"""Point-in-ring test (port copy of ``citlab_as_tpu/geometry/booleans.py::
point_in_ring``), used to group contour holes with their exteriors."""
from __future__ import annotations

import numpy as np


def point_in_ring(point, ring) -> bool:
    """Even-odd ray cast."""
    arr = np.asarray(ring, dtype=np.float64)
    px, py = float(point[0]), float(point[1])
    x, y = arr[:, 0], arr[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    crosses = (y > py) != (yp > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_at = (xp - x) * (py - y) / (yp - y) + x
    return bool(np.count_nonzero(crosses & (px < x_at)) % 2)
