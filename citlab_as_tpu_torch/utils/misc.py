"""Small list / batching helpers (port of ``citlab_as_tpu/utils/misc.py``;
reference: python_util/basic/{misc,list_util}.py). ``split_list`` lives in
``utils/workers.py``, which shards pages with it, and is imported here
under its JAX module path."""
from __future__ import annotations

from typing import Iterable, List, Sequence, TypeVar

from citlab_as_tpu_torch.utils.workers import split_list  # noqa: F401

T = TypeVar("T")


def chunk_list(lst: Sequence[T], max_chunk: int) -> List[List[T]]:
    """Split ``lst`` into chunks of at most ``max_chunk`` items (reference
    run_net_post_processing.py:61-71 shards image lists into <=50-item sublists)."""
    if max_chunk <= 0:
        raise ValueError("max_chunk must be positive")
    return [list(lst[i:i + max_chunk]) for i in range(0, len(lst), max_chunk)]


def filter_by_attribute(objects: Iterable[T], attr: str, value) -> List[T]:
    """Return objects whose ``attr`` equals ``value``."""
    return [o for o in objects if getattr(o, attr, None) == value]


def group_by_attribute(objects: Iterable[T], attr: str) -> dict:
    """Group objects into {attr value: [objects]} (the reference's
    list_util.filter_by_attribute semantics, python_util/basic/list_util.py:4)."""
    out: dict = {}
    for o in objects:
        out.setdefault(getattr(o, attr, None), []).append(o)
    return out


def flatten(nested: Iterable[Iterable[T]]) -> List[T]:
    return [x for sub in nested for x in sub]
