"""The port's height-sharded ARU-Net forward (``parallel/spatial.py``, the
``model`` axis of ``parallel/mesh.py``) on the CPU.

- against the JAX package's ``spatial_sharding`` forward over its 8
  virtual CPU devices (``conftest.py``), with the same flax parameters:
  f32 within 1e-4, the JAX docstring's figure;
- against the port's own unsharded forward over shapes that stress the
  row partition: heights that are no multiple of the alignment, fewer
  rows than ``A x model``, remainder shards, the U and RU graphs, ``mvn``,
  three classes, a shallower graph whose alignment the attention net
  sets; K1's conv (its plain version here) runs 69 times per shard. In
  float64 the sharded forward equals the unsharded one bit for bit: every
  layer computes each output from the same rows in the same order. In
  float32 it does wherever oneDNN picks the same convolution algorithm
  for a shard as for the page; for a batch of one page it picks another
  for some heights, and the first conv's outputs (Cin 1) already differ
  in the last bit, up to 2.7e-5 at the logits (1.3e-6 of their largest):
  float32 is held to 1e-5 of the logits' scale (:func:`_assert_f32_close`;
  the data-parallel tests hold it to 1e-5 for the same reason,
  ``test_torch_parallel.py``);
- the halo exchange against slicing the page (hypothesis);
- ``ShardedSegmentationPredictor`` over a (data=2, model=2) mesh against
  the JAX package's over ``make_mesh(jax.devices()[:4], data=2, model=2)``,
  and the pipelined workflow over a (2, 2) mesh against the unsharded one.

A CPU mesh names the CPU once per shard, as the JAX tests get eight CPU
devices; each shard still runs on its own rows.
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from hypothesis import given, settings, strategies as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from citlab_as_tpu_torch.inference import (  # noqa: E402
    RelationPredictor, SegmentationPredictor, ShardedSegmentationPredictor,
)
from citlab_as_tpu_torch.models import arunet as tarunet  # noqa: E402
from citlab_as_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from citlab_as_tpu_torch.parallel import spatial  # noqa: E402
from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The forwards here run hundreds of small CPU ops per shard: with the
    test workers of a parallel run each spinning up every core's thread
    for them, they run a hundred times slower than in one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(variables), sep="/").items()}


def _sharded(net, k):
    return spatial.SpatialARU({CPU: net}, [CPU] * k)


def _assert_f32_close(got, want):
    """Within 1e-5 of the output scale (the largest logit)."""
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# ---------------------------------------------------------------- partition

@pytest.mark.parametrize("height,shards,align,sizes", [
    (1500, 4, 64, [384, 384, 384, 348]),
    (1536, 4, 64, [384] * 4),
    (9984, 4, 64, [2496] * 4),
    (256, 8, 64, [64] * 4),
    (300, 2, 64, [128, 172]),
    (1000, 5, 64, [192, 192, 192, 192, 232]),
    (63, 4, 64, [63]),
    (64, 1, 64, [64]),
])
def test_row_partition(height, shards, align, sizes):
    parts = tmesh.row_partition(height, shards, align)
    assert [stop - start for start, stop in parts] == sizes
    assert parts[0][0] == 0 and parts[-1][1] == height
    assert all(start % align == 0 for start, _ in parts)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("gp,align", [
    ({}, 64),                                            # the committed nets
    ({"graph": "U"}, 16), ({"graph": "RU"}, 16),
    ({"num_scales_att": 2}, 32),
    ({"scale_space_num": 3}, 64),      # the attention net's 4 x 4 conv at 1/32
    ({"graph": "RU", "scale_space_num": 6}, 32),
])
def test_row_alignment_from_the_graph(gp, align):
    assert tarunet.row_alignment(dict(tarunet.DEFAULT_GRAPH_PARAMS, **gp)) == align


# ---------------------------------------------------------------- halo

@settings(max_examples=60, deadline=None)
@given(st.data())
def test_exchange_rows_equals_slicing_the_page(data):
    top = data.draw(st.integers(0, 3))
    bottom = data.draw(st.integers(0, 3))
    heights = data.draw(st.lists(st.integers(max(top, bottom, 1), 9), min_size=1,
                                 max_size=6))
    width = data.draw(st.integers(1, 4))
    page = torch.arange(sum(heights) * width * 2, dtype=torch.float32).reshape(
        2, sum(heights), width, 1)
    shards = list(torch.split(page, heights, dim=1))
    padded = torch.cat([torch.zeros(2, top, width, 1), page,
                        torch.zeros(2, bottom, width, 1)], dim=1)
    start = 0
    for i, (above, below) in enumerate(spatial.exchange_rows(shards, top, bottom)):
        assert (above is None) == (top == 0 or i == 0)
        assert (below is None) == (bottom == 0 or i == len(shards) - 1)
        ext = torch.cat([torch.zeros(2, top, width, 1) if above is None else above,
                         shards[i],
                         torch.zeros(2, bottom, width, 1) if below is None else below], dim=1)
        assert torch.equal(ext, padded[:, start:start + heights[i] + top + bottom])
        start += heights[i]


def test_exchange_rows_refuses_a_short_neighbour():
    shards = [torch.zeros(1, 3, 2, 1), torch.zeros(1, 1, 2, 1), torch.zeros(1, 3, 2, 1)]
    with pytest.raises(ValueError, match="cannot give 2"):
        spatial.exchange_rows(shards, 1, 2)


# ---------------------------------------------------------------- forward

def test_sharded_forward_matches_jax_spatial_sharding():
    """The JAX package's recipe (``tests/test_parallel.py``): the default
    ARU-Net in f32 with ``model.init(PRNGKey(0))``'s parameters, a seeded
    1 x 512 x 128 page placed with ``spatial_sharding`` over a (1, 8) mesh;
    the port runs the same parameters over 8 CPU shards of 64 rows."""
    from citlab_as_tpu.models.arunet import ARUNet as FlaxARUNet
    from citlab_as_tpu.parallel.mesh import make_mesh, replicate, spatial_sharding
    mesh = make_mesh(data=1, model=8)
    model = FlaxARUNet(n_classes=2, dtype=jnp.float32)
    # jitted: flax's eager init of the ARU-Net takes three times as long
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    x = np.random.RandomState(0).rand(1, 512, 128, 1).astype(np.float32)
    fwd = jax.jit(lambda v, x: model.apply(v, x)[0])
    want = np.asarray(fwd(replicate(mesh, variables),
                          jax.device_put(jnp.asarray(x), spatial_sharding(mesh))))

    net = tarunet.ARUNet(n_classes=2).eval()
    net.load_state_dict(arunet_state_dict_from_flax(_flat(variables)))
    sharded = _sharded(net, 8)
    assert [p.shape[1] for p in sharded.shard(torch.from_numpy(x)).parts] == [64] * 8
    with torch.no_grad():
        got = sharded(torch.from_numpy(x))
        plain = net(torch.from_numpy(x))
        net64 = net.to(torch.float64)
        got64 = _sharded(net64, 8)(torch.from_numpy(x))
        plain64 = net64(torch.from_numpy(x))
    assert got.shape == plain.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    _assert_f32_close(got, plain)
    assert torch.equal(got64, plain64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("gp,shape,k,n_shards,n_classes", [
    ({}, (2, 300, 100), 2, 2, 2),
    ({}, (1, 1000, 72), 5, 5, 2),
    ({}, (1, 256, 64), 8, 4, 2),                # fewer rows than A x model
    ({}, (1, 63, 40), 3, 1, 2),                 # fewer rows than A
    ({}, (1, 700, 50), 3, 3, 2),                # 256 / 192 / 252
    ({}, (1, 451, 33), 4, 4, 2),                # odd heights at every level
    ({"graph": "U"}, (2, 300, 100), 3, 3, 2),
    ({"graph": "RU"}, (1, 300, 100), 4, 4, 2),
    ({"mvn": True}, (2, 300, 100), 3, 3, 2),
    ({}, (1, 300, 100), 3, 3, 3),
    ({"scale_space_num": 3}, (1, 200, 60), 3, 3, 2),
], ids=["300x100-k2", "1000x72-k5", "256-over-8", "63-over-3", "remainder-k3",
        "odd-451-k4", "U", "RU", "mvn", "3-classes", "ssn3"])
def test_sharded_forward_matches_the_unsharded_forward(monkeypatch, gp, shape, k,
                                                       n_shards, n_classes, dtype):
    """Every shape equal to the unsharded forward bit for bit in float64,
    within 1e-5 of the logits' scale in float32 (see the module's docstring); the 3 x 3 convs
    of Cout 8 / 16 / 32 go through K1's entry on every shard (69 per shard
    for an ARU graph)."""
    net = tarunet.ARUNet(n_classes=n_classes, graph_params=gp).init_random(3).eval()
    net = net.to(dtype)
    x = torch.from_numpy(np.random.RandomState(1).rand(*shape, 1)).to(dtype)
    calls = []
    conv3x3 = tarunet.conv3x3

    def counting(*args, **kw):
        calls.append(args[0].shape[1])
        return conv3x3(*args, **kw)
    monkeypatch.setattr(tarunet, "conv3x3", counting)
    sharded = _sharded(net, k)
    assert len(sharded.shard(x).parts) == n_shards
    with torch.no_grad():
        want = net(x)
        per_forward = len(calls)
        calls.clear()
        got = sharded(x)
    assert got.shape == want.shape
    if dtype == torch.float64:
        assert torch.equal(got, want)
    else:
        _assert_f32_close(got, want)
    assert len(calls) == n_shards * per_forward
    if gp.get("graph", "ARU") == "ARU" and "scale_space_num" not in gp:
        assert per_forward == 69


def test_sharded_forward_casts_once_to_the_compute_dtype():
    """A float64 net with ``compute_dtype=float32``, as the trainer holds
    f32 weights under a bf16 compute dtype: the sharded forward computes in
    the compute dtype from the same one cast as the unsharded one (the
    replicas on other devices cast theirs once per forward), and equals it
    on a batch of two pages, where oneDNN picks one algorithm for both."""
    net = tarunet.ARUNet(n_classes=2, compute_dtype=torch.float32).init_random(2)
    net = net.to(torch.float64).eval()
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 200, 64, 1))
    seen = []
    conv3x3 = tarunet.conv3x3

    def recording(x, weight, *args, **kw):
        seen.append(weight.dtype)
        return conv3x3(x, weight, *args, **kw)
    tarunet.conv3x3 = recording
    try:
        with torch.no_grad():
            want = net(x)
            got = _sharded(net, 3)(x)
    finally:
        tarunet.conv3x3 = conv3x3
    assert got.dtype == want.dtype == torch.float32
    assert set(seen) == {torch.float32} and len(seen) == 69 * 4
    _assert_f32_close(got, want)


# ---------------------------------------------------------------- mesh

def test_model_axis_places_as_the_jax_mesh():
    """Over (data=2, model=2): the data shards lie on each row's first
    device, as the JAX batch sharding (replicated over 'model') holds data
    row i on ``devices[i, :]``; the row shards of ``place_rows`` on the
    row's devices, in page order."""
    from citlab_as_tpu.parallel.mesh import make_mesh as jmake_mesh, shard_batch as jshard
    jmesh = jmake_mesh(jax.devices()[:4], data=2, model=2)
    mesh = tmesh.make_mesh(["cpu"] * 4, data=2, model=2)
    assert mesh.devices.shape == jmesh.devices.shape and mesh.shape == dict(jmesh.shape)
    x = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    jx = jshard(jmesh, jnp.asarray(x))
    got = tmesh.shard_batch(mesh, x)
    for i in range(2):
        assert mesh.data_devices[i] == mesh.devices[i, 0]
        assert mesh.model_devices(i) == list(mesh.devices[i])
        on_row = [s for s in jx.addressable_shards if s.device in set(jmesh.devices[i])]
        assert len(on_row) == 2
        for s in on_row:
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(s.data))
    spec = tmesh.spatial_sharding(mesh)
    assert (spec.ndim, spec.h_axis, spec.devices(1)) == (4, 1, mesh.model_devices(1))
    page = torch.arange(200 * 3, dtype=torch.float32).reshape(1, 200, 3, 1)
    parts = tmesh.place_rows(spec, page, 64, row=1)
    assert [p.shape[1] for p in parts] == [128, 72]
    assert torch.equal(torch.cat(parts, dim=1), page)
    with pytest.raises(ValueError, match="3-axis"):
        tmesh.place_rows(spec, page[0], 64)
    net = torch.nn.Linear(2, 2)
    rows = tmesh.replicate(mesh, net, over_model=True)
    assert [list(r) for r in rows] == [[CPU], [CPU]]
    assert rows[0][CPU] is not rows[1][CPU]


def _images(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(150 + 40 * i, 90 - 10 * i).astype(np.float32) for i in range(n)]


def test_sharded_predictor_over_data_and_model_matches_jax(tmp_path):
    """``ShardedSegmentationPredictor`` over (data=2, model=2) CPU shards and
    the JAX package's over 4 of its CPU devices in the same layout: the
    same weights (a seeded f32 ``.frozen``), 3 pages of unequal size,
    within 1e-4; and within 1e-6 of the port's unsharded predictor."""
    from citlab_as_tpu.inference import ShardedSegmentationPredictor as JSharded
    from citlab_as_tpu.parallel.mesh import make_mesh as jmake_mesh
    from citlab_as_tpu_torch.train.export import export_frozen
    gp = {"featRoot": 4, "scale_space_num": 3, "res_depth": 1}
    frozen = export_frozen(str(tmp_path / "aru.frozen"), "arunet",
                           tarunet.ARUNet(graph_params=gp).init_random(7),
                           {"graph_params": gp, "dtype": torch.float32})
    images = _images()
    jpred = JSharded(model_dir=frozen, pad_multiple=32,
                     mesh=jmake_mesh(jax.devices()[:4], data=2, model=2))
    mesh = tmesh.make_mesh(["cpu"] * 4, data=2, model=2)
    tpred = ShardedSegmentationPredictor(frozen, mesh=mesh, pad_multiple=32)
    assert tpred.n_data == 2 and len(tpred.shards()) == 2
    assert all(isinstance(s.model, spatial.SpatialARU) for s in tpred.shards())
    plain = SegmentationPredictor(frozen, pad_multiple=32, device="cpu")
    got = tpred.predict_batch(images)
    for a, b, c in zip(got, jpred.predict_batch(images), plain.predict_batch(images)):
        assert a.shape == b.shape == c.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-6)
    again = ShardedSegmentationPredictor.from_predictor(tpred, mesh)
    for a, b in zip(again.predict_batch(images), got):
        np.testing.assert_array_equal(a, b)


def test_relation_predictor_over_a_model_axis_keeps_one_replica_per_row():
    rng = np.random.RandomState(5)
    graphs = [{"num_nodes": n, "node_features": rng.rand(n, 15).astype(np.float32).tolist(),
               "interacting_nodes": np.stack([rng.randint(0, n, 3 * n),
                                              rng.randint(0, n, 3 * n)], 1).tolist(),
               "edge_features": rng.randint(0, 2, (3 * n, 2)).astype(float).tolist()}
              for n in (3, 12, 7)]
    npz = os.path.join(REPO, "models_ckpt_torch", "gnn.npz")
    plain = RelationPredictor(npz, device="cpu")
    view = plain.over_mesh(tmesh.make_mesh(["cpu"] * 4, data=2, model=2))
    for a, b in zip(view.confidences_batch(graphs), plain.confidences_batch(graphs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert len(view._mesh_replicas()) == 2 and view._group_bucket == 4


def _normalized(path):
    with open(path, "rb") as f:
        return re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>", f.read())


def test_pipelined_workflow_over_data_and_model_writes_the_unsharded_files(tmp_path):
    """3 demo pages in groups of 1: unsharded, and over a (2, 2) CPU mesh
    (each data row's pages through the height-sharded forward over its 2
    shards, the GNN once per row): every written page and clustered file
    byte-equal, ``LastChange`` normalised."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu_torch.cli import run_full_workflow as workflow
    npz = os.path.join(REPO, "models_ckpt_torch")
    runs = {}
    for name, mesh in (("plain", None),
                       ("mesh", tmesh.make_mesh(["cpu"] * 4, data=2, model=2))):
        root = str(tmp_path / name)
        os.makedirs(root)
        rng = np.random.RandomState(7)
        images = [make_demo_page(root, f"p{i}", rng, w=500, h=700)[0] for i in range(3)]
        res = workflow.run_full_workflow_pipelined(
            images, out_dir=os.path.join(root, "out"), mesh=mesh,
            separator_predictor=SegmentationPredictor(
                os.path.join(npz, "separator.npz"), dtype=torch.float32, device="cpu"),
            heading_predictor=SegmentationPredictor(
                os.path.join(npz, "heading.npz"), dtype=torch.float32, device="cpu"),
            gnn_predictor=RelationPredictor(os.path.join(npz, "gnn.npz"), device="cpu"),
            separator_fixed_height=512, heading_fixed_height=384, batch_size=1,
            device="cpu")
        assert res["skipped"] == [] and len(res["clustered"]) == 3
        runs[name] = (root, res)
    (root_a, a), (root_b, b) = runs["plain"], runs["mesh"]
    for i in range(3):
        rel = os.path.join("page", f"p{i}.xml.xml")
        assert _normalized(os.path.join(root_a, rel)) == _normalized(os.path.join(root_b, rel))
    for pa, pb in zip(a["clustered"], b["clustered"]):
        assert _normalized(pa) == _normalized(pb), pb
