"""The port's data-parallel path on the CPU (``parallel/mesh.py``,
``ShardedSegmentationPredictor``, ``RelationPredictor(mesh=...)``, the
pipelined workflow's ``mesh``, ``--data_parallel``, ``--sharded``,
``initialize_multihost``), against the JAX package on its 8 virtual CPU
devices (``conftest.py``) and against the port's unsharded paths.

A CPU mesh names the CPU once per shard, as the JAX tests get eight CPU
devices; each shard still runs on its own replica. The CPU's convolutions
may pick another algorithm at another batch size, so sharded against
unsharded is held to 1e-5 in f32 here and bit for bit only on the card
(``chip_smoke.py`` parallel phase)."""
import os
import re
import socket
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from citlab_as_tpu_torch.inference import (  # noqa: E402
    RelationPredictor, SegmentationPredictor, ShardedSegmentationPredictor,
)
from citlab_as_tpu_torch.parallel import mesh as tmesh  # noqa: E402

GP = {"featRoot": 4, "scale_space_num": 3, "res_depth": 1, "num_scales_att": 2}
CPU8 = ["cpu"] * 8


def _images(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(40 + 2 * i, 50).astype(np.float32) for i in range(n)]


def _normalized(path):
    with open(path, "rb") as f:
        return re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>", f.read())


# ---------------------------------------------------------------- mesh

def test_make_mesh_shapes_and_errors_match_jax():
    from citlab_as_tpu.parallel.mesh import make_mesh as jmake_mesh
    assert len(jax.devices()) == 8
    for kw in ({}, {"data": 4, "model": 2}, {"data": 2, "model": 4}, {"model": 8}):
        want = jmake_mesh(**kw)
        got = tmesh.make_mesh(CPU8, **kw)
        assert got.devices.shape == want.devices.shape
        assert got.shape == dict(want.shape)
    for kw in ({"data": 3, "model": 2}, {"data": 8, "model": 2}):
        with pytest.raises(ValueError) as want:
            jmake_mesh(**kw)
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(CPU8, **kw)
        assert str(got.value) == str(want.value)
    assert tmesh.make_mesh(CPU8).data_devices == [torch.device("cpu")] * 8
    # the model axis: a data shard lies on its row's first device, the
    # row's devices carry the height shards (tests/test_torch_spatial.py),
    # in the JAX mesh's grid
    jmesh = jmake_mesh(jax.devices()[:4], data=2, model=2)
    names = ["cpu:0", "cpu:1", "cpu:2", "cpu:3"]   # one name per JAX device
    mesh = tmesh.make_mesh(["cpu", "cpu", "cpu", "cpu"], data=2, model=2)
    grid = np.vectorize(lambda d: names[d.id])(jmesh.devices)
    labelled = np.asarray(names, dtype=object).reshape(2, 2)
    assert (grid == labelled).all() and mesh.devices.shape == grid.shape
    assert mesh.data_devices == list(mesh.devices[:, 0]) == [torch.device("cpu")] * 2
    assert [mesh.model_devices(i) for i in range(2)] == [list(row) for row in mesh.devices]
    pieces = tmesh.shard_batch(mesh, torch.arange(4.0).reshape(4, 1))
    assert [p.tolist() for p in pieces] == [[[0.0], [1.0]], [[2.0], [3.0]]]


def test_make_mesh_defaults_to_the_cards():
    """make_mesh() takes every CUDA device; with none it raises rather than
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()


def test_shard_batch_and_replicate_round_trip():
    mesh = tmesh.make_mesh(["cpu"] * 4)
    rng = np.random.RandomState(0)
    batch = {"x": rng.rand(8, 4, 4, 1).astype(np.float32),
             "y": [np.arange(8, dtype=np.int32), torch.arange(16).reshape(8, 2)]}
    shards = tmesh.shard_batch(mesh, batch)
    assert len(shards) == 4 and all(s["x"].shape == (2, 4, 4, 1) for s in shards)
    np.testing.assert_array_equal(torch.cat([s["x"] for s in shards]).numpy(), batch["x"])
    np.testing.assert_array_equal(torch.cat([s["y"][0] for s in shards]).numpy(),
                                  batch["y"][0])
    assert torch.equal(torch.cat([s["y"][1] for s in shards]), batch["y"][1])
    cols = tmesh.shard_batch(mesh, torch.arange(24).reshape(3, 8), batch_axis=1)
    assert torch.equal(torch.cat(cols, dim=1), torch.arange(24).reshape(3, 8))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(mesh, np.zeros((6, 2)))

    net = torch.nn.Linear(3, 2)
    replicas = tmesh.replicate(mesh, net)
    assert len(replicas) == 4 and len({id(r) for r in replicas} | {id(net)}) == 5
    for r in replicas:
        for a, b in zip(r.parameters(), net.parameters()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    state = tmesh.replicate(mesh, {"w": torch.ones(2)})
    assert [s["w"].tolist() for s in state] == [[1.0, 1.0]] * 4
    spec = tmesh.batch_sharding(mesh, ndim=3, batch_axis=1)
    assert (spec.ndim, spec.batch_axis, spec.devices) == (3, 1, mesh.data_devices)


def test_data_parallel_sum():
    mesh = tmesh.make_mesh(CPU8)
    x = tmesh.shard_batch(mesh, torch.arange(16, dtype=torch.float32).reshape(8, 2))
    total = tmesh.data_parallel_jit(lambda t: t.sum())(x)
    assert float(sum(total)) == float(np.arange(16).sum())


# ---------------------------------------------------------------- ARU

def test_sharded_segmentation_predictor_matches_single_device(monkeypatch):
    """8 shards over 10 pages of uneven size (16 padded pages, 2 per shard)
    against one forward of the 10, f32 within 1e-5; one page through
    __call__ too, and a batch past the chunk size."""
    images = _images()
    single = SegmentationPredictor(None, graph_params=GP, pad_multiple=32, seed=7,
                                   dtype=torch.float32, device="cpu")
    monkeypatch.setattr(ShardedSegmentationPredictor, "MAX_SHARD_BATCH", 1)
    sharded = ShardedSegmentationPredictor(None, mesh=tmesh.make_mesh(CPU8),
                                           graph_params=GP, pad_multiple=32, seed=7,
                                           dtype=torch.float32)
    assert sharded.n_data == 8 and sharded.MAX_DEVICE_BATCH == 8
    want = single.predict_batch(images)
    got = sharded.predict_batch(images)        # chunks of 8 and 2
    assert [g.shape for g in got] == [w.shape for w in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sharded(images[0]), want[0], rtol=0, atol=1e-5)
    shards = sharded.shards()
    assert len(shards) == 8 and len({id(s.model) for s in shards}) == 8


def test_sharded_segmentation_predictor_matches_jax(tmp_path):
    """The JAX ShardedSegmentationPredictor on 8 CPU devices and the port's
    on an 8-shard CPU mesh, with the same weights carried across by
    ``arunet_state_dict_from_flax``: f32 within 1e-4. (The JAX predictor
    loads a seeded net from a ``.frozen`` artifact: flax's own init of the
    ARU-Net takes longer than the rest of the test.)"""
    from citlab_as_tpu.inference import ShardedSegmentationPredictor as JSharded
    from citlab_as_tpu_torch.models.arunet import ARUNet
    from citlab_as_tpu_torch.train.export import export_frozen
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax
    images = _images()
    frozen = export_frozen(str(tmp_path / "aru.frozen"), "arunet",
                           ARUNet(graph_params=GP).init_random(7),
                           {"graph_params": GP, "dtype": torch.float32})
    jpred = JSharded(model_dir=frozen, pad_multiple=32)
    assert jpred.n_data == 8
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(jpred.variables), sep="/").items()}
    tpred = ShardedSegmentationPredictor(None, mesh=tmesh.make_mesh(CPU8),
                                         graph_params=GP, pad_multiple=32,
                                         dtype=torch.float32)
    tpred.model.load_state_dict(arunet_state_dict_from_flax(flat))
    tpred = ShardedSegmentationPredictor.from_predictor(tpred, tmesh.make_mesh(CPU8))
    for a, b in zip(tpred.predict_batch(images), jpred.predict_batch(images)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- GNN

def _random_graph(rng, n, n_edges=None):
    n_edges = 3 * n if n_edges is None else n_edges
    edges = np.stack([rng.randint(0, n, n_edges), rng.randint(0, n, n_edges)], 1)
    return {"num_nodes": n,
            "node_features": rng.rand(n, 15).astype(np.float32).tolist(),
            "interacting_nodes": edges.tolist(),
            "edge_features": rng.randint(0, 2, (n_edges, 2)).astype(float).tolist()}


def test_relation_predictor_mesh_matches_jax():
    """Both predictors over a mesh of 8 (JAX: its CPU devices), two groups:
    the group bucket rounds up to 8 on both sides, the confidences agree
    within 1e-5, and equal the port's unsharded predictor's."""
    from citlab_as_tpu.inference import RelationPredictor as JRelation
    from citlab_as_tpu.parallel.mesh import make_mesh as jmake_mesh
    rng = np.random.RandomState(5)
    groups = [[_random_graph(rng, n) for n in (3, 12, 7)],
              [_random_graph(rng, n) for n in (20, 5, 9, 11, 4, 6, 8, 10, 13)]]
    npz = os.path.join(REPO, "models_ckpt_torch", "gnn.npz")
    jpred = JRelation(os.path.join(REPO, "models_ckpt", "gnn", "best", "f1"),
                      mesh=jmake_mesh())
    tpred = RelationPredictor(npz, mesh=tmesh.make_mesh(CPU8))
    plain = RelationPredictor(npz, device="cpu")
    for graphs in groups:
        want = jpred.confidences_batch(graphs)
        got = tpred.confidences_batch(graphs)
        assert tpred._group_bucket == jpred._group_bucket
        assert tpred._group_bucket % 8 == 0
        for a, b, c in zip(got, want, plain.confidences_batch(graphs)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)
    assert tpred._group_bucket == 16 and len(tpred._mesh_replicas()) == 8


# ---------------------------------------------------------------- workflow

def _demo_corpus(root, n=3, seed=7):
    from scripts.bench_e2e import make_demo_page
    os.makedirs(root)
    rng = np.random.RandomState(seed)
    return [make_demo_page(root, f"p{i}", rng, w=500, h=700)[0] for i in range(n)]


def _nets():
    npz = os.path.join(REPO, "models_ckpt_torch")
    return dict(
        separator_predictor=SegmentationPredictor(
            os.path.join(npz, "separator.npz"), dtype=torch.float32, device="cpu"),
        heading_predictor=SegmentationPredictor(
            os.path.join(npz, "heading.npz"), dtype=torch.float32, device="cpu"),
        gnn_predictor=RelationPredictor(os.path.join(npz, "gnn.npz"), device="cpu"))


def test_pipelined_workflow_on_a_two_shard_mesh_writes_the_unsharded_files(
        tmp_path, monkeypatch):
    """3 pages in groups of 1: unsharded 3 groups; over a 2-shard CPU mesh
    2 groups of 2 and 1 page, split into the same per-shard groups of 1.
    Every written page and clustered file is byte-equal (``LastChange``
    normalised), and the GNN ran sharded, through a view that leaves the
    caller's predictor as it was."""
    kw = dict(separator_fixed_height=512, heading_fixed_height=384, batch_size=1,
              device="cpu")
    from citlab_as_tpu_torch.cli import run_full_workflow as workflow
    batch_inputs, gnn_groups = RelationPredictor._batch_inputs, []

    def recording(self, graphs, images=None):
        out = batch_inputs(self, graphs, images)
        gnn_groups[-1].append((self.n_data, self._group_bucket))
        return out
    monkeypatch.setattr(RelationPredictor, "_batch_inputs", recording)
    runs = {}
    for name, mesh in (("plain", None), ("mesh", tmesh.make_mesh(["cpu", "cpu"]))):
        root = str(tmp_path / name)
        images = _demo_corpus(root)
        nets = _nets()
        gnn_groups.append([])
        res = workflow.run_full_workflow_pipelined(
            images, out_dir=os.path.join(root, "out"), mesh=mesh, **nets, **kw)
        assert res["skipped"] == [] and len(res["clustered"]) == 3
        runs[name] = (root, res, nets["gnn_predictor"])
    (root_a, a, gnn_a), (root_b, b, gnn_b) = runs["plain"], runs["mesh"]
    assert gnn_groups[0] and all(g == (1, 1) for g in gnn_groups[0])
    assert gnn_groups[1] and all(g == (2, 2) for g in gnn_groups[1])
    assert gnn_a.mesh is None and gnn_b.mesh is None and gnn_b._group_bucket == 1
    for i in range(3):
        name = os.path.join("page", f"p{i}.xml.xml")
        assert _normalized(os.path.join(root_a, name)) == \
            _normalized(os.path.join(root_b, name)), name
    assert [os.path.basename(p) for p in a["clustered"]] == \
        [os.path.basename(p) for p in b["clustered"]]
    for pa, pb in zip(a["clustered"], b["clustered"]):
        assert _normalized(pa) == _normalized(pb), pb


def test_cli_data_parallel(monkeypatch):
    """--data_parallel with one device runs the --pipelined driver with the
    same arguments and no mesh; with more than one CUDA device (simulated)
    it passes a mesh over all of them."""
    from citlab_as_tpu_torch.cli import run_full_workflow as workflow
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return {"timings": {"total": 1.0}}
    monkeypatch.setattr(workflow, "run_full_workflow_pipelined", record)
    monkeypatch.setattr(workflow, "load_list_file", lambda path: ["a.png"])
    base = ["--path_to_image_list", "x.lst", "--batch_size", "3"]
    workflow.main(base + ["--pipelined", "--device", "cpu"])
    workflow.main(base + ["--data_parallel", "--device", "cpu"])
    assert calls[0] == calls[1] and calls[1][1]["mesh"] is None
    fake = tmesh.make_mesh(["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(tmesh, "make_mesh", lambda *a, **k: fake)
    workflow.main(base + ["--data_parallel"])
    assert calls[2][1]["mesh"] is fake and calls[2][1]["device"] == "cuda"


@pytest.mark.parametrize("mode", ["separator", "heading"])
def test_cli_sharded_writes_the_unsharded_files(tmp_path, monkeypatch, mode):
    """run_net_post_processing --sharded over a 2-shard CPU mesh, page by
    page and in groups of 2 per shard, writes the unsharded CLI's files."""
    from citlab_as_tpu_torch.cli import run_net_post_processing as cli
    monkeypatch.setattr(cli, "_mesh_for", lambda device: tmesh.make_mesh(["cpu", "cpu"]))
    npz = os.path.join(REPO, "models_ckpt_torch", f"{mode}.npz")
    outputs = {}
    for name, extra in (("plain", []), ("sharded", ["--sharded"]),
                        ("plain_b", ["--batch_size", "2"]),
                        ("sharded_b", ["--sharded", "--batch_size", "2"])):
        root = str(tmp_path / name)
        images = _demo_corpus(root, n=5)
        lst = os.path.join(root, "images.lst")
        with open(lst, "w") as f:
            f.write("\n".join(images) + "\n")
        written = cli.main(["--path_to_image_list", lst, "--mode", mode, "--model", npz,
                            "--fixed_height", "256", "--device", "cpu"] + extra)
        assert len(written) == 5 and all(w is not None for w in written)
        outputs[name] = [_normalized(os.path.join(root, "page", f"p{i}.xml.xml"))
                         for i in range(5)]
    assert outputs["sharded"] == outputs["plain"]
    assert outputs["sharded_b"] == outputs["plain_b"]


# ---------------------------------------------------------------- multi-process

def test_initialize_multihost(monkeypatch):
    """No coordinator: False and nothing starts. With torchrun's variables
    (world size 1, localhost): a gloo group comes up, a second call is a
    no-op, an all-reduce runs, and the group is torn down."""
    import torch.distributed as dist
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_multihost() is False
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert tmesh.initialize_multihost(backend="gloo") is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert tmesh.initialize_multihost() is True
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()
