"""Numeric helpers (port copy of ``citlab_as_tpu/utils/mathutil.py``).

Reference semantics: python_util/math/rounding.py:20-43 and
python_util/math/measure.py:5-29. Half-up rounding matters: Python's builtin
round() does banker's rounding, while the geometry kernels (blow_up etc.)
require round-half-up to stay in lockstep with the reference / Java kernel.
"""
from __future__ import annotations

import numpy as np


def round_half_up(x):
    """Round scalar to nearest integer, ties away from zero toward +inf.

    Matches python_util/math/rounding.py:20-31 (``round_to_nearest_integer``):
    ``x % 1 >= 0.5 -> int(x) + 1 else int(x)``. Note for negative x, Python's
    ``%`` is non-negative, and ``int()`` truncates toward zero — we replicate
    that exactly.
    """
    if x % 1 >= 0.5:
        return int(x) + 1
    return int(x)


def round_half_up_array(x):
    """Vectorized round_half_up over a numpy array (float -> int64).

    For any x, reference computes ``int(x)+1 if x%1>=0.5 else int(x)``.
    ``x % 1`` in numpy matches Python semantics (result has sign of divisor,
    i.e. non-negative for divisor 1), and ``np.trunc`` matches ``int()``.
    """
    x = np.asarray(x, dtype=np.float64)
    frac = np.mod(x, 1.0)
    base = np.trunc(x)
    return np.where(frac >= 0.5, base + 1, base).astype(np.int64)


def round_by_base(x, prec: int = 2, base: float = 1.0):
    """Round ``x`` to the nearest multiple of ``base`` with precision ``prec``.

    Matches python_util/math/rounding.py:34-43 (used for the 50-px grid
    rounding before Delaunay triangulation in GNN feature generation).
    """
    return (base * (np.array(x) / base).round()).round(prec)


def safe_div(numerator, denominator):
    """Element-wise division returning 0 where denominator <= 0.

    numpy analog of python_util/math/rounding.py:5-18 (TF original).
    """
    numerator = np.asarray(numerator, dtype=np.float64)
    denominator = np.asarray(denominator, dtype=np.float64)
    out = np.zeros_like(numerator, dtype=np.float64)
    np.divide(numerator, denominator, out=out, where=denominator > 0)
    return out


def f_measure(precision: float, recall: float) -> float:
    """Harmonic mean of precision and recall (python_util/math/measure.py:5-18)."""
    if precision == 0 and recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def f1_score(true_pos: float, false_pos: float, false_neg: float) -> float:
    """F1 from counts (python_util/math/measure.py:21-29)."""
    denom = 2.0 * true_pos + false_pos + false_neg
    if denom == 0:
        return 0.0
    return 2.0 * true_pos / denom
