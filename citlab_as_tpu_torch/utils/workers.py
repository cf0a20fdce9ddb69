"""Host-process fan-out for GIL-bound pipeline stages (port copy of
``citlab_as_tpu/utils/workers.py``: ``split_list``, ``run_sharded``,
``PersistentPool``).

Device work runs in the parent, but the pure-Python geometry and PAGE-XML
stages hold the interpreter lock, so a process pool over item shards is the
host side's parallelism. Results and skipped items come back as values.

Workers are spawned, never forked: the parent usually holds a CUDA context
and threads (the workflow's device thread), and a forked child of such a
process is broken. A worker starts a fresh interpreter and imports what its
callable needs (torch included, about two seconds), so a pool pays off only
when the work per item times the items per worker well exceeds that.
"""
from __future__ import annotations

import logging
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

_WORKER_FN: Optional[Callable] = None


def split_list(lst: Sequence[T], n: int) -> List[List[T]]:
    """Split ``lst`` into ``n`` nearly equal contiguous chunks (lengths
    differ by at most one); empty chunks are dropped."""
    if n <= 0:
        raise ValueError("n must be positive")
    k, m = divmod(len(lst), n)
    out = [list(lst[i * k + min(i, m):(i + 1) * k + min(i + 1, m)]) for i in range(n)]
    return [c for c in out if c]


def _init_worker(fn_builder: Callable[[], Callable]) -> None:
    """Each worker builds its callable once. Nothing here touches
    ``torch.cuda``: the host stages run on the CPU."""
    global _WORKER_FN
    _WORKER_FN = fn_builder()


def _started() -> None:
    """A no-op task: its only effect is that a worker exists to run it."""


def _run_shard(items: Sequence) -> Tuple[List, List]:
    done, skipped = [], []
    for item in items:
        try:
            done.append((item, _WORKER_FN(item)))
        except Exception as e:  # noqa: BLE001 - the log-and-skip contract
            logger.error("worker skipping %r: %s", item, e)
            skipped.append(item)
    return done, skipped


def _spawn_pool(fn_builder: Callable[[], Callable], num_workers: int
                ) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(
        max_workers=num_workers, initializer=_init_worker,
        initargs=(fn_builder,), mp_context=multiprocessing.get_context("spawn"))


def _map_shards(pool: ProcessPoolExecutor, shards) -> Tuple[List, List]:
    results, skipped = [], []
    for done, skip in pool.map(_run_shard, [s for s in shards if s]):
        results.extend(done)
        skipped.extend(skip)
    return results, skipped


def run_sharded(fn_builder: Callable[[], Callable], items: Sequence,
                num_workers: int = 0, max_shard: int = 50):
    """Apply ``fn_builder()(item)`` to every item.

    ``num_workers`` <= 1 runs in-process (an error skips the item). Otherwise
    shards of at most ``max_shard`` items go over a spawned process pool.
    Returns (results, skipped): results are (item, value) pairs in shard
    order, skipped the items whose call raised."""
    if num_workers <= 1:
        _init_worker(fn_builder)
        return _run_shard(items)
    shards = split_list(list(items), max(
        num_workers, (len(items) + max_shard - 1) // max_shard))
    with _spawn_pool(fn_builder, num_workers) as pool:
        return _map_shards(pool, shards)


class PersistentPool:
    """A spawned worker pool that lives across calls: the pipelined workflow
    driver maps each wave's host tail over it, and paying the workers'
    start-up per wave (as :func:`run_sharded` would) would erase the gain.
    Workers build their callable once through ``fn_builder`` (the contract
    of :func:`run_sharded`) and process items under the log-and-skip
    contract."""

    def __init__(self, fn_builder: Callable[[], Callable], num_workers: int):
        self.num_workers = num_workers
        self._pool = _spawn_pool(fn_builder, num_workers)
        # the executor spawns a worker per submitted task while none is idle:
        # one no-op each starts them all now, so that their start-up
        # overlaps the caller's first waves instead of its first map
        for _ in range(num_workers):
            self._pool.submit(_started)

    def map_items(self, items: Sequence) -> Tuple[List, List]:
        """Apply the worker callable to every item, in one contiguous shard
        per worker. Returns (results, skipped) as :func:`run_sharded`."""
        if not items:
            return [], []
        return _map_shards(self._pool, split_list(list(items), self.num_workers))

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
