"""The port's training recipes (``citlab_as_tpu_torch/scripts/``) against
the JAX repository's scripts, on the CPU: their schedule and optimizer and
their page and graph generators.

- ``cosine_decay_schedule`` bit-equal to optax's function at every step of
  a 400-step schedule and past its end; ``adam`` over it follows optax's
  trajectory over 5 steps of random gradients to 1e-6 relative;
- ``synth_page_graph``: the JSON text equal to the JAX script's for 20
  seeds (``delaunay_edges`` and ``fully_connected_edges`` are the port's);
- ``make_article_page`` and ``make_hard_article_page`` at 600 x 800: the
  PNG pixels equal to the PIL-written ones and the PAGE-XML bytes equal
  (the clock frozen on both sides), for 3 seeds each.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from citlab_as_tpu.pagexml import page as jpage
from citlab_as_tpu_torch.pagexml import page as tpage
from citlab_as_tpu_torch.scripts import hard_corpus, train_pipeline_gnn, train_synthetic_gnn
from citlab_as_tpu_torch.train import optimizer as topt
from citlab_as_tpu_torch.utils.io import load_image


def test_cosine_decay_schedule_bit_equal_optax():
    for lr, steps, alpha in ((1e-3, 400, 0.1), (3e-4, 37, 0.0)):
        want = optax.cosine_decay_schedule(lr, steps, alpha=alpha)
        got = topt.cosine_decay_schedule(lr, steps, alpha=alpha)
        for count in range(steps + 3):
            w = np.asarray(want(jnp.int32(count)))
            assert w.dtype == np.float32
            assert np.float32(got(count)).tobytes() == w.tobytes(), count
    with pytest.raises(ValueError):
        topt.cosine_decay_schedule(1e-3, 0)


def test_adam_over_cosine_schedule_follows_optax():
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jopt = optax.adam(optax.cosine_decay_schedule(0.1, 4, alpha=0.1))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    opt = topt.adam(topt.cosine_decay_schedule(0.1, 4, alpha=0.1))
    params = {k: torch.tensor(v) for k, v in init.items()}
    state = opt.init(params)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(params, {k: torch.tensor(v) for k, v in g.items()}, state)
        for k in shapes:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7)
    assert state["count"] == 5


def test_synth_page_graph_json_equal_jax():
    from scripts.train_synthetic_gnn import synth_page_graph as jsynth
    for seed in range(20):
        want_rng, got_rng = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(3):          # a seed's stream draws several pages
            want, got = jsynth(want_rng), train_synthetic_gnn.synth_page_graph(got_rng)
            assert json.dumps(got) == json.dumps(want), seed
    assert np.array_equal(want_rng.get_state()[1], got_rng.get_state()[1])


@pytest.fixture
def frozen_clock(monkeypatch):
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")


def _pixels(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("L"))


def _same_page(got, want):
    """Equal pixels, equal page bytes, equal returned values."""
    assert got[0].endswith(".png") and want[0].endswith(".png")
    np.testing.assert_array_equal(np.asarray(load_image(got[0], "L")), _pixels(want[0]))
    with open(got[1], "rb") as g, open(want[1], "rb") as w:
        assert g.read() == w.read()
    assert got[2:] == want[2:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_article_page_equal_jax(tmp_path, seed):
    from scripts.train_pipeline_gnn import make_article_page as jmake
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jmake(str(tmp_path / "jax"), "p", np.random.RandomState(seed), w=600, h=800)
    got = train_pipeline_gnn.make_article_page(str(tmp_path / "port"), "p",
                                               np.random.RandomState(seed), w=600, h=800)
    _same_page(got, want)


@pytest.mark.parametrize("seed,dense,rule_grey", [(0, False, None), (1, True, None),
                                                  (2, False, 200)])
def test_make_hard_article_page_equal_jax(tmp_path, frozen_clock, seed, dense, rule_grey):
    from scripts.hard_corpus import make_hard_article_page as jmake
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    kw = dict(w=600, h=800, dense=dense, rule_grey=rule_grey)
    want = jmake(str(tmp_path / "jax"), "p", np.random.RandomState(seed), **kw)
    got = hard_corpus.make_hard_article_page(str(tmp_path / "port"), "p",
                                             np.random.RandomState(seed), **kw)
    _same_page(got, want)
    assert abs(got[3]) > 0
