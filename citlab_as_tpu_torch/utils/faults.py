"""Per-page fault isolation: the log-and-skip contract (port copy of
``citlab_as_tpu/utils/faults.py``: ``SkippedPages`` and ``page_guard``).

A failing page is logged and skipped, never fatal to the batch, when the
caller passes an ``on_page_error(key, stage, exc)`` callback; without one
the error propagates. The workflow driver threads a :class:`SkippedPages`
registry through the stages, so one corrupt XML or truncated image drops
that page out of every later stage instead of ending the run.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional

logger = logging.getLogger(__name__)


class SkippedPages:
    """Registry of pages dropped by per-page guards.

    Keys are image paths (the workflow's canonical page identity). Each
    entry records the first stage that failed for the page; later stages
    never see it (the drivers filter their waves by :meth:`__contains__`).
    """

    def __init__(self):
        self._entries: List[dict] = []
        self._keys = set()

    def record(self, key: str, stage: str, exc: BaseException) -> None:
        logger.error("skipping page %r at stage %s: %s: %s",
                     key, stage, type(exc).__name__, exc)
        if key not in self._keys:
            self._keys.add(key)
            self._entries.append({"page": key, "stage": stage,
                                  "error": f"{type(exc).__name__}: {exc}"})

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def as_list(self) -> List[dict]:
        return list(self._entries)

    def guard(self, key: str, stage: str, fn: Callable, default=None):
        """Run ``fn()``; on any exception record (key, stage) and return
        ``default`` instead of propagating."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - the skip contract
            self.record(key, stage, e)
            return default


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
