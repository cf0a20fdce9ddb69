"""Geometry kernel of the port: host implementations of the geometry
primitives, copied from ``citlab_as_tpu/geometry``. The later stages'
heavy functions (interline distances, cluster features, normed polygon
distances, alpha shapes) go through the port's host C++ library
(``csrc/geometry_host.cpp``, loaded by ``geometry/native.py``); their
numpy versions stay as the plain versions the tests hold it against."""
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
