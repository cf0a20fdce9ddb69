"""The port's JAX oracles run the JAX package's native geometry path: the
repair of ``tests/torch_jax_native.py`` (imported here, after
``tests/test_native.py`` in every worker's collection and before any test
runs) and its fixture, which fails a test by name where the oracle would
run the numpy fallback."""
import numpy as np
import pytest

import citlab_as_tpu.geometry.native as jn
from citlab_as_tpu.geometry.polygon import Polygon as JPolygon
from tests.torch_jax_native import native_switched_off, require_native, restore_native


def _distances():
    rng = np.random.RandomState(3)
    polys = [JPolygon([10, 500, 990], [40 + 60 * i + int(rng.randint(-5, 5))] * 3)
             for i in range(6)]
    return jn.interline_distances_raw_native(polys, 5, 500)


def test_collection_left_the_native_library_loaded(monkeypatch):
    """Importing the repair left this worker on the native path."""
    monkeypatch.delenv("CITLAB_AS_TPU_NATIVE", raising=False)
    assert restore_native()
    assert jn._lib is not None and jn.native_available()


def test_repair_restores_a_lost_native_library(monkeypatch):
    """The state a worker is left in when it loaded the library half
    written (no library, the failed load remembered) is repaired: the
    library loads again and the native path gives its results."""
    monkeypatch.delenv("CITLAB_AS_TPU_NATIVE", raising=False)
    assert restore_native()
    want = _distances()
    monkeypatch.setattr(jn, "_lib", None)
    monkeypatch.setattr(jn, "_load_attempted", True)
    assert jn.get_lib() is None and not jn.native_available()
    assert restore_native(timeout=10)
    assert jn.get_lib() is not None and jn._load_attempted
    assert np.array_equal(_distances(), want)


def test_fixture_repairs_before_it_judges(monkeypatch):
    monkeypatch.delenv("CITLAB_AS_TPU_NATIVE", raising=False)
    assert restore_native()
    monkeypatch.setattr(jn, "_lib", None)
    monkeypatch.setattr(jn, "_load_attempted", True)
    require_native()
    assert jn._lib is not None


def test_fixture_fails_by_name_where_the_oracle_would_fall_back(monkeypatch):
    """With the library switched off (CITLAB_AS_TPU_NATIVE=0) a test that
    needs the native oracle fails naming it; the repair honours the
    switch and loads nothing."""
    monkeypatch.setenv("CITLAB_AS_TPU_NATIVE", "0")
    assert native_switched_off()
    monkeypatch.setattr(jn, "_lib", None)
    monkeypatch.setattr(jn, "_load_attempted", True)
    assert not restore_native(timeout=1)
    with pytest.raises(pytest.fail.Exception, match="native geometry library is not loaded"):
        require_native()
    assert jn._lib is None
