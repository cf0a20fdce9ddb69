"""The JAX package's native geometry library, held loaded for the port's
oracles.

``citlab_as_tpu.geometry.native`` builds ``native/libgeometry_kernel.so``
with ``make`` at its first use, without a lock, the linker writing straight
into the final path, and loads any file that exists; a failed load is
remembered for the life of the process (``_load_attempted``). Test workers
that import ``tests/test_native.py`` together all build the library, and a
worker that loads it half-written runs the package's numpy fallback for the
whole session. That fallback is not bit-identical to the native path (the
port follows the native one), so a port test would then compare against
another oracle.

Importing this module repairs that in its process: it waits, up to
:data:`LOAD_TIMEOUT` seconds, until the library's file stops changing and
loads, clearing a failed load the package recorded; the package's own
switch (``CITLAB_AS_TPU_NATIVE=0``) is honoured and leaves the fallback on.
:func:`jax_native` is the fixture of every port test whose oracle runs the
JAX package's geometry through that library: it fails the test by name,
without comparing, where the oracle would run the fallback.
"""
from __future__ import annotations

import os
import time

import pytest

import citlab_as_tpu.geometry.native as jn
from citlab_as_tpu.config import runtime

LOAD_TIMEOUT = 120.0
_SETTLE = 0.5   # seconds the library's file must stay unchanged before a load


def native_switched_off() -> bool:
    return not runtime.get("native_geometry")


def _settled(path: str) -> bool:
    try:
        before = os.stat(path)
        time.sleep(_SETTLE)
        after = os.stat(path)
    except OSError:
        return False
    return (before.st_size, before.st_mtime_ns, before.st_ino) == (
        after.st_size, after.st_mtime_ns, after.st_ino) and after.st_size > 0


def restore_native(timeout: float = LOAD_TIMEOUT) -> bool:
    """Load the JAX package's native library in this process, waiting while
    another process writes it; True once it is loaded. A failed load the
    package recorded is retried; nothing is loaded where the package's
    switch turns the library off."""
    if native_switched_off():
        return False
    deadline = time.monotonic() + timeout
    built = False
    while jn._lib is None:
        absent = not os.path.exists(jn._LIB_PATH)
        if absent and built:
            break          # this process's own build made no library
        if absent or _settled(jn._LIB_PATH):
            jn._load_attempted = False
            jn.get_lib()   # builds it where no file exists
            built |= absent
        if jn._lib is not None or time.monotonic() > deadline:
            break
        time.sleep(_SETTLE)
    return jn._lib is not None


def require_native() -> None:
    """Fail the calling test by name unless the JAX package's geometry runs
    its native path in this process."""
    if jn._lib is None and not restore_native():
        why = ("CITLAB_AS_TPU_NATIVE=0 switches it off" if native_switched_off()
               else f"{jn._LIB_PATH} did not load within {LOAD_TIMEOUT:.0f} s")
        pytest.fail("the JAX package's native geometry library is not loaded in this "
                    f"process ({why}): its numpy fallback is not bit-identical to the "
                    "native path the port follows, so this oracle is not compared",
                    pytrace=False)


@pytest.fixture
def jax_native():
    require_native()


restore_native()
