"""Integer rectangle (port copy of ``citlab_as_tpu/geometry/rectangle.py``).

Semantics follow python_util/geometry/rectangle.py:4-229 (x, y = upper-left
corner; ``intersection`` may return negative width/height, which encodes an
empty intersection — callers rely on this encoding, e.g. the DBSCAN
neighborhood rule).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Rectangle:
    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0

    def __post_init__(self):
        self.x = int(self.x)
        self.y = int(self.y)
        self.width = int(self.width)
        self.height = int(self.height)

    # -- accessors ---------------------------------------------------------
    def get_bounds(self) -> "Rectangle":
        return Rectangle(self.x, self.y, self.width, self.height)

    def set_bounds(self, x: int, y: int, width: int, height: int) -> None:
        self.x, self.y, self.width, self.height = int(x), int(y), int(width), int(height)

    def get_vertices(self):
        """Corner vertices clockwise from the upper-left."""
        return [
            (self.x, self.y),
            (self.x + self.width, self.y),
            (self.x + self.width, self.y + self.height),
            (self.x, self.y + self.height),
        ]

    @property
    def x2(self) -> int:
        return self.x + self.width

    @property
    def y2(self) -> int:
        return self.y + self.height

    # -- predicates --------------------------------------------------------
    def contains_point(self, point) -> bool:
        """Strict interior test (boundary excluded), as in the reference."""
        px, py = point[0], point[1]
        return self.x < px < self.x + self.width and self.y < py < self.y + self.height

    def contains_point_on_boundary(self, point) -> bool:
        px, py = point[0], point[1]
        on_v = (px == self.x or px == self.x + self.width) and self.y <= py <= self.y + self.height
        on_h = (py == self.y or py == self.y + self.height) and self.x <= px <= self.x + self.width
        return on_v and on_h

    def contains_rectangle(self, r: "Rectangle") -> bool:
        return all(
            self.contains_point(v) or self.contains_point_on_boundary(v)
            for v in r.get_vertices()
        )

    def lies_above_of(self, r: "Rectangle") -> bool:
        return self.y + self.height < r.y

    def lies_below_of(self, r: "Rectangle") -> bool:
        return self.y < r.y + r.height

    def lies_left_of(self, r: "Rectangle") -> bool:
        return self.x > r.x + r.width

    def lies_right_of(self, r: "Rectangle") -> bool:
        return self.x + self.width < r.x

    # -- transforms --------------------------------------------------------
    def translate(self, dx: int, dy: int) -> None:
        self.x += int(dx)
        self.y += int(dy)

    def rescale(self, scaling_factor: float):
        if scaling_factor * self.width < 1 or scaling_factor * self.height < 1:
            return None
        self.x = int(scaling_factor * self.x)
        self.y = int(scaling_factor * self.y)
        self.width = int(scaling_factor * self.width)
        self.height = int(scaling_factor * self.height)
        return self

    def intersection(self, r: "Rectangle") -> "Rectangle":
        """Intersection rectangle; negative width/height means empty.

        Mirrors rectangle.py:132-169 — the (possibly negative) extents carry
        gap information used by ``get_gap_to``.
        """
        tx1 = max(self.x, r.x)
        ty1 = max(self.y, r.y)
        tx2 = min(self.x + self.width, r.x + r.width)
        ty2 = min(self.y + self.height, r.y + r.height)
        return Rectangle(tx1, ty1, tx2 - tx1, ty2 - ty1)

    def get_gap_to(self, r: "Rectangle") -> "Rectangle":
        """Rectangle spanning the gap between two disjoint rectangles
        (rectangle.py:211-224); zero rect if they overlap."""
        inter = self.intersection(r)
        if inter.width > 0 and inter.height > 0:
            return Rectangle(0, 0, 0, 0)
        if inter.width > 0:
            return Rectangle(inter.x, inter.y - abs(inter.height), inter.width, abs(inter.height))
        if inter.height > 0:
            return Rectangle(inter.x - abs(inter.width), inter.y, abs(inter.width), inter.height)
        return Rectangle(
            inter.x - abs(inter.width), inter.y - abs(inter.height),
            abs(inter.width), abs(inter.height),
        )


def merge_rectangles(rectangle_list) -> Rectangle:
    """Minimal rectangle containing all rectangles (geometry/util.py:12-25)."""
    min_x = min(r.x for r in rectangle_list)
    max_x = max(r.x + r.width for r in rectangle_list)
    min_y = min(r.y for r in rectangle_list)
    max_y = max(r.y + r.height for r in rectangle_list)
    return Rectangle(min_x, min_y, max_x - min_x, max_y - min_y)
