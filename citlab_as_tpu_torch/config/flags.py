"""Dict-valued flag parsing (port copy of ``parse_dict_flag`` and its
helpers from ``citlab_as_tpu/config/flags.py``; the flag registry itself is
not ported: the port's CLI uses argparse directly)."""
from __future__ import annotations

from typing import Any, Dict


def _coerce_scalar(v: str) -> Any:
    """bool/int/float/str coercion used by dict-valued flags (flags.py:229-287)."""
    if v.lower() in ("true", "t"):
        return True
    if v.lower() in ("false", "f"):
        return False
    try:
        f = float(v)
        i = int(f)
        return i if i == f else f
    except ValueError:
        return v


def _parse_dict_value(val: str) -> Any:
    s = val.strip()
    if len(s) >= 2 and s[0] == "[" and s[-1] == "]":
        out = []
        for element in s[1:-1].split(","):
            element = element.strip()
            if element == "":
                continue
            out.append(_coerce_scalar(element))
        return out
    return _coerce_scalar(s)


def parse_dict_flag(spec: str) -> Dict[str, Any]:
    """Parse a single 'key=value[,key=value...]' string into a coerced dict
    (the one-argument form of the reference's dict flags; a list value
    holds one element at most, since the comma separates the pairs)."""
    out: Dict[str, Any] = {}
    for kv in spec.split(","):
        kv = kv.strip()
        if not kv:
            continue
        key, sep, val = kv.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {kv!r}")
        out[key.strip()] = _parse_dict_value(val)
    return out
