"""The port's Inception v3 backbone and the Inception visual relation GNN
against the JAX package's, on the CPU.

- every conv unit shape of the net ((1, 7), (7, 1), (1, 3), (3, 1), 5x5 and
  3x3 SAME at stride 1, 3x3 VALID at strides 1 and 2, 1x1) and the pools:
  the port's symmetric padding equals flax's ``SAME``;
- ``InceptionV3`` at two odd input sizes (1 x 107 x 107 x 1 and
  2 x 139 x 171 x 3) with seeded parameters and non-trivial batch
  statistics: every end point and the final map within 1e-4 of the
  output's scale;
- ``weights.py`` both ways, ``params`` and ``batch_stats``, bare and inside
  ``GraphRelation(image_input=True, visual_backbone="inception_v3")``;
- that ``GraphRelation``'s confidences on a 3-graph group at 128 x 128
  within 1e-5 of flax's, and ``RelationPredictor`` serving it.

The flax variables are seeded numpy arrays on ``jax.eval_shape``'s tree
(flax's own init of Inception takes 13-28 s on the CPU and is not under
test); the JAX forwards run once per module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import traverse_util

from citlab_as_tpu.inference import RelationPredictor as JRelationPredictor
from citlab_as_tpu.models import inception_v3 as jinception
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu_torch.inference import RelationPredictor
from citlab_as_tpu_torch.models import inception_v3 as tinception
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.weights import (
    gnn_flax_from_state_dict, gnn_state_dict_from_flax, inception_flax_from_state_dict,
    inception_state_dict_from_flax,
)

END_POINT_TOL = 1e-4      # of the output's scale
CONF_TOL = 1e-5
SHAPES = [(1, 107, 107, 1), (2, 139, 171, 3)]
VISUAL_KW = dict(image_input=True, visual_backbone="inception_v3",
                 image_min_dimension=96, image_max_dimension=128)


def seeded_variables(shapes, seed):
    """Flat float32 variables on a flax variable tree's shapes: conv and
    dense kernels lecun-normal, biases, BatchNorm scales and batch
    statistics random but plausible (not flax's 0 / 1 starts)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes, sep="/").items():
        shape = leaf.shape
        if path.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            value = rng.randn(*shape) / np.sqrt(fan_in)
        elif path.endswith(("scale", "var")):
            value = rng.rand(*shape) * 0.5 + 0.75
        else:                                   # bias, mean
            value = rng.randn(*shape) * 0.1
        flat[path] = value.astype(np.float32)
    return flat


def unflat(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


@pytest.fixture(scope="module")
def flax_runs():
    """Per input shape: (input, flat variables, final map, end points) of
    the JAX package's InceptionV3."""
    model = jinception.InceptionV3()
    apply = jax.jit(model.apply)
    runs = {}
    for i, shape in enumerate(SHAPES):
        x = np.random.RandomState(10 + i).rand(*shape).astype(np.float32)
        flat = seeded_variables(
            jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x)), i)
        final, end_points = apply(unflat(flat), jnp.asarray(x))
        runs[shape] = (x, flat, np.asarray(final),
                       {k: np.asarray(v) for k, v in end_points.items()})
    return runs


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("kernel,strides,padding", [
    ((1, 7), (1, 1), "SAME"), ((7, 1), (1, 1), "SAME"), ((1, 3), (1, 1), "SAME"),
    ((3, 1), (1, 1), "SAME"), ((5, 5), (1, 1), "SAME"), ((3, 3), (1, 1), "SAME"),
    ((1, 1), (1, 1), "SAME"), ((3, 3), (1, 1), "VALID"), ((3, 3), (2, 2), "VALID"),
    ((1, 1), (1, 1), "VALID")])
def test_conv_unit_matches_flax(kernel, strides, padding):
    """One conv + BatchNorm + ReLU unit at an odd size: shape and values."""
    rng = np.random.RandomState(sum(kernel) + strides[0])
    x = rng.rand(2, 13, 10, 5).astype(np.float32)
    jmod = jinception.ConvUnit(6, kernel, strides=strides, padding=padding)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    flat = seeded_variables(shapes, 7)
    want = np.asarray(jmod.apply(unflat(flat), jnp.asarray(x)))
    unit = tinception.ConvUnit(5, 6, kernel, strides, padding)
    state = inception_state_dict_from_flax({
        k.replace("params/", "params/u/").replace("batch_stats/", "batch_stats/u/"): v
        for k, v in flat.items()})
    unit.load_state_dict({k[2:]: v for k, v in state.items()})
    with torch.no_grad():
        got = unit(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _close(got, want, END_POINT_TOL, "ConvUnit")


def test_pools_match_flax():
    """flax's avg_pool(SAME) counts the pad, as count_include_pad=True; the
    VALID stride-2 max pool floors the size."""
    x = np.random.RandomState(3).randn(2, 11, 8, 4).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1), padding="SAME"))
    got = tinception._avg_pool_same(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="VALID"))
    got = tinception._max_pool_valid(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_inception_end_points_match_flax(flax_runs, shape):
    x, flat, final, end_points = flax_runs[shape]
    model = tinception.InceptionV3(cin=shape[-1])
    model.load_state_dict(inception_state_dict_from_flax(flat))
    with torch.no_grad():
        got_final, got_ends = model(torch.from_numpy(x))
    assert list(got_ends) == list(end_points)
    for name, want in end_points.items():
        assert got_ends[name].shape[-1] == model.endpoint_channels(name), name
        _close(got_ends[name].numpy(), want, END_POINT_TOL, name)
    _close(got_final.numpy(), final, END_POINT_TOL, "final map")


def test_inception_weights_round_trip(flax_runs):
    """flax variables -> state_dict -> flax variables, bit for bit; every
    leaf consumed once; the parameter count is Inception v3's."""
    _, flat, _, _ = flax_runs[SHAPES[0]]
    state = inception_state_dict_from_flax(flat)
    model = tinception.InceptionV3(cin=1)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    back = inception_flax_from_state_dict(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    n_params = sum(v.size for k, v in flat.items() if k.startswith("params/"))
    assert n_params == sum(p.numel() for p in model.parameters())
    assert sum(k.endswith("Conv_0/kernel") for k in flat) == 94
    with pytest.raises(KeyError):
        inception_state_dict_from_flax({"params/Mixed_5b/Dense_0/kernel": np.zeros(1)})


def _graph(rng, n, extent=(700, 500)):
    edges = np.stack([rng.randint(0, n, 3 * n), rng.randint(0, n, 3 * n)], 1)
    regions = []
    for _ in range(n):
        x0, y0 = rng.rand() * extent[1] * 0.8, rng.rand() * extent[0] * 0.8
        x1, y1 = x0 + rng.rand() * 90 + 5, y0 + rng.rand() * 60 + 5
        regions.append([[x0, x1, x1, x0], [y0, y0, y1, y1]])
    return {"num_nodes": n,
            "node_features": rng.rand(n, 15).astype(np.float32).tolist(),
            "interacting_nodes": edges.tolist(),
            "edge_features": rng.randint(0, 2, (3 * n, 2)).astype(float).tolist(),
            "visual_regions_nodes": regions,
            "num_points_visual_regions_nodes": [4] * n}


@pytest.fixture(scope="module")
def visual_run():
    """A group of three pages with their images through the JAX package's
    visual predictor inputs (128 x 128 padded images) and flax's
    ``GraphRelation`` with the Inception backbone: (graphs, images, batch,
    flat variables, confidences)."""
    rng = np.random.RandomState(4)
    graphs = [_graph(rng, n) for n in (5, 9, 3)]
    images = [rng.randint(0, 256, (700, 500)).astype(np.uint8) for _ in graphs]
    jpred = JRelationPredictor(**VISUAL_KW)
    batch, _ = jpred._batch_inputs(graphs, images)
    jmodel = JGraphRelation(image_input=True, visual_backbone="inception_v3")
    flat = seeded_variables(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch), 5)
    logits = jax.jit(jmodel.apply)(unflat(flat), batch)
    conf = np.asarray(jax.nn.softmax(logits, axis=-1)[..., 1])
    return graphs, images, batch, flat, conf


def test_visual_graph_relation_matches_flax(visual_run):
    _, _, batch, flat, want = visual_run
    assert batch["image"].shape[1:3] == (128, 128)
    model = GraphRelation(15, 2, image_input=True, visual_backbone="inception_v3")
    state = gnn_state_dict_from_flax(flat)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    back = gnn_flax_from_state_dict(model.state_dict())
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], v) for k, v in flat.items())
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("interacting_nodes", "relations_to_consider"):
        inputs[k] = inputs[k].long()
    with torch.no_grad():
        got = model.predict_confidences(inputs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CONF_TOL)


def test_relation_predictor_serves_the_inception_net(visual_run, tmp_path):
    """The port's predictor at the same sizes, from an .npz of the flax
    variables: per-page confidences equal the flax forward's."""
    graphs, images, _, flat, want = visual_run
    path = tmp_path / "inception_visual.npz"
    np.savez(path, **flat)
    pred = RelationPredictor(str(path), device="cpu", **VISUAL_KW)
    got = pred.confidences_batch(graphs, images)
    for i, (g, conf) in enumerate(zip(graphs, got)):
        n = g["num_nodes"]
        np.testing.assert_allclose(conf, want[i, :n * n].reshape(n, n), rtol=0,
                                   atol=CONF_TOL)
