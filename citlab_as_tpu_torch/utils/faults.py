"""Per-page fault isolation: the log-and-skip contract (port copy of
``citlab_as_tpu/utils/faults.py::page_guard``).

A failing page is logged and skipped, never fatal to the batch, when the
caller passes an ``on_page_error(key, stage, exc)`` callback; without one
the error propagates.
"""
from __future__ import annotations

from typing import Callable, Optional


def page_guard(on_page_error: Optional[Callable], key: str, stage: str,
               fn: Callable, default=None):
    """Run ``fn()``. With ``on_page_error=None`` errors raise through; with a
    callback they are reported to it and ``default`` is returned."""
    if on_page_error is None:
        return fn()
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the skip contract
        on_page_error(key, stage, e)
        return default
