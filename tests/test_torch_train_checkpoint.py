"""The port's checkpoints (``train/checkpoint.py``) and its weight bridge
both ways (``weights.py``) against the JAX package, on the CPU.

- weights: a flax init of the ARU-Net, the relation GNN and the visual
  relation GNN goes into the port and back bit for bit, and a port
  ``state_dict`` goes to flax paths and back bit for bit;
- checkpoints: round trip, prune to 2, best export and restore, epoch info,
  ``is_better`` in both directions (equal to the JAX function on every
  case), EMA (equal to the JAX function to float32 rounding), warm start
  with regex renames and an include pattern (equal to the JAX package's on
  the same tree), a template that does not fit raises;
- a stale ``current_epoch.info`` (best metrics but no numbered checkpoint)
  does not suppress a fresh run's best export;
- a best export (an orbax checkpoint of the net's variables) loads
  through ``SegmentationPredictor`` and ``RelationPredictor`` and gives the
  exported net's outputs;
- every directory the port writes is an orbax checkpoint and holds no
  ``checkpoint.npz``, and an earlier port run's ``checkpoint.npz``
  directory still restores, and resumes the GNN trainer.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.train import checkpoint as jckpt
from citlab_as_tpu_torch.train import checkpoint as tckpt
from citlab_as_tpu_torch.train import orbax
from citlab_as_tpu_torch import weights

TINY_GP = {"graph": "ARU", "featRoot": 4, "scale_space_num": 3, "res_depth": 1,
           "num_scales_att": 2}


def _flat(variables):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(variables, sep="/").items()}


def _assert_same_flat(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_arunet_weights_round_trip_both_ways():
    from citlab_as_tpu.models.arunet import ARUNet as JARUNet
    from citlab_as_tpu_torch.models.arunet import ARUNet
    flat = _flat(jax.jit(JARUNet(n_classes=3, graph_params=TINY_GP).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1))))
    model = ARUNet(n_classes=3, graph_params=TINY_GP)
    model.load_state_dict(weights.arunet_state_dict_from_flax(flat))
    _assert_same_flat(weights.arunet_flax_from_state_dict(model.state_dict()), flat)
    model.init_random(5)
    back = weights.arunet_state_dict_from_flax(
        weights.arunet_flax_from_state_dict(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("visual", [False, True])
def test_gnn_weights_round_trip_both_ways(visual):
    from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    kw = dict(image_input=True, visual_backbone="ARU_cutted_v1") if visual else {}
    rng = np.random.RandomState(0)
    n, e = 4, 6
    batch = {"num_nodes": np.full((1,), n, np.int32),
             "node_features": rng.rand(1, n, 15).astype(np.float32),
             "interacting_nodes": rng.randint(0, n, (1, e, 2)).astype(np.int32),
             "num_interacting_nodes": np.full((1,), e, np.int32),
             "edge_features": rng.rand(1, e, 2).astype(np.float32),
             "relations_to_consider": rng.randint(0, n, (1, 8, 2)).astype(np.int32)}
    if visual:
        batch.update(image=rng.rand(1, 64, 64, 1).astype(np.float32),
                     image_shape=np.array([[64, 64]], np.int32),
                     visual_regions_nodes=rng.rand(1, n, 2, 4).astype(np.float32) * 60,
                     num_points_visual_regions_nodes=np.full((1, n), 4, np.int32))
    flat = _flat(jax.jit(JGraphRelation(num_classes=2, **kw).init)(
        jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()}))
    model = GraphRelation(15, 2, **kw)
    model.load_state_dict(weights.gnn_state_dict_from_flax(flat))
    _assert_same_flat(weights.gnn_flax_from_state_dict(model.state_dict()), flat)
    back = weights.gnn_state_dict_from_flax(
        weights.gnn_flax_from_state_dict(model.state_dict()))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_checkpoint_round_trip_and_prune(tmp_path):
    state = {"params": {"w": torch.ones(3, 3), "b": np.arange(4, dtype=np.float32)},
             "count": 5}
    for step in range(3):
        tckpt.save_checkpoint(str(tmp_path), step, state)
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    assert tckpt.latest_checkpoint_step(str(tmp_path)) == 2
    restored, step = tckpt.restore_checkpoint(str(tmp_path))
    assert step == 2
    assert np.array_equal(restored["params"]["w"], np.ones((3, 3), np.float32))
    assert np.array_equal(restored["params"]["b"], np.arange(4, dtype=np.float32))
    assert int(restored["count"]) == 5
    # a template selects paths and checks shapes
    sub, _ = tckpt.restore_checkpoint(str(tmp_path), {"params": {"w": np.zeros((3, 3))}})
    assert list(sub) == ["params"] and list(sub["params"]) == ["w"]
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(str(tmp_path), {"params": {"w": np.zeros((2, 3))}})
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(str(tmp_path), {"params": {"nope": np.zeros(1)}})
    template = {"x": 1}
    assert tckpt.restore_checkpoint(str(tmp_path / "empty"), template) == (template, None)


def test_prune_keeps_the_same_steps_as_jax(tmp_path):
    for pkg, d in ((jckpt, tmp_path / "j"), (tckpt, tmp_path / "t")):
        for step in (0, 3, 1, 7, 2):
            pkg.save_checkpoint(str(d), step, {"w": np.full((2,), step, np.float32)})
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))


def test_best_export_restore_and_epoch_info(tmp_path):
    state = {"w": np.full((2,), 7.0, np.float32)}
    path = tckpt.export_best(str(tmp_path), "f1", state)
    assert path == tckpt.best_path(str(tmp_path), "f1") == str(tmp_path / "best" / "f1")
    assert orbax.is_orbax_checkpoint(path)
    assert tckpt.CHECKPOINT_FILE not in os.listdir(path)
    assert (tckpt.restore_best(str(tmp_path), "f1")["w"] == 7.0).all()
    tckpt.write_epoch_info(str(tmp_path), 5, extra={"best_metrics": {"f1": 0.5}})
    jinfo = jckpt.read_epoch_info(str(tmp_path))
    assert tckpt.read_epoch_info(str(tmp_path)) == jinfo == {
        "current_epoch": 5, "best_metrics": {"f1": 0.5}}
    assert tckpt.read_epoch_info(str(tmp_path / "none")) is None


@pytest.mark.parametrize("name,new,best", [
    ("f1", 0.5, None), ("f1", 0.9, 0.5), ("f1", 0.4, 0.5), ("f1", 0.5, 0.5),
    ("loss", 0.1, 0.5), ("loss", 0.9, 0.5), ("eval_loss", 0.1, 0.5),
    ("eval_loss", 0.9, 0.5), ("auc_roc", 0.7, 0.6), ("accuracy", 0.2, 0.3),
    ("lossy", 0.1, 0.5)])
def test_is_better_equals_jax(name, new, best):
    assert tckpt.is_better(name, new, best) == jckpt.is_better(name, new, best)


def test_ema_equals_jax():
    rng = np.random.RandomState(0)
    ema = {"w": rng.randn(5, 3).astype(np.float32)}
    params = {"w": rng.randn(5, 3).astype(np.float32)}
    want = jckpt.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                            {k: jnp.asarray(v) for k, v in params.items()}, decay=0.9)
    shadow = tckpt.ema_init({"w": torch.tensor(ema["w"])})
    got = tckpt.ema_update(shadow, {"w": torch.tensor(params["w"])}, decay=0.9)
    assert got["w"] is shadow["w"]
    np.testing.assert_allclose(shadow["w"].numpy(), np.asarray(want["w"]), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("include", [None, r"/kernel$"])
def test_warmstart_with_renames_equals_jax(tmp_path, include):
    src = {"old_scope": {"dense": {"kernel": np.full((2, 2), 3.0, np.float32),
                                   "bias": np.full((2,), 4.0, np.float32)}},
           "shape_mismatch": {"w": np.ones((3,), np.float32)}}
    jckpt.save_checkpoint(str(tmp_path / "j"), 0, src)
    tckpt.save_checkpoint(str(tmp_path / "t"), 0, src)
    fresh = {"new_scope": {"dense": {"kernel": np.zeros((2, 2), np.float32),
                                     "bias": np.zeros((2,), np.float32)}},
             "shape_mismatch": {"w": np.zeros((4,), np.float32)},
             "other": {"b": np.zeros((4,), np.float32)}}
    renames = {r"^old_scope": "new_scope"}
    want = jckpt.warmstart_params(fresh, str(tmp_path / "j"), src,
                                  rename_map=renames, include_pattern=include)
    got = tckpt.warmstart_params(fresh, str(tmp_path / "t"), rename_map=renames,
                                 include_pattern=include)
    _assert_same_flat(tckpt.flatten(got), _flat(want))
    assert (got["new_scope"]["dense"]["kernel"] == 3.0).all()
    assert (got["new_scope"]["dense"]["bias"] == (0.0 if include else 4.0)).all()
    # tensor leaves keep their dtype and come back as tensors
    tfresh = {"new_scope/dense/kernel": torch.zeros(2, 2, dtype=torch.float64)}
    tgot = tckpt.warmstart_params(tfresh, str(tmp_path / "t"), rename_map=renames)
    assert tgot["new_scope/dense/kernel"].dtype == torch.float64
    assert (tgot["new_scope/dense/kernel"] == 3.0).all()


def test_stale_info_does_not_suppress_best_export(tmp_path):
    """A model_dir holding a leftover current_epoch.info (with a high
    best_metrics) but no numbered checkpoints is a fresh run: the phantom
    best must not suppress best/<metric> exports."""
    from tests.test_training import _write_graph_jsons
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    (tmp_path / "data").mkdir()
    graphs = _write_graph_jsons(tmp_path / "data", n_graphs=6)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    with open(model_dir / "current_epoch.info", "w") as f:
        json.dump({"current_epoch": 40, "best_metrics": {"f1": 0.999}}, f)
    trainer = TrainerGNN(
        str(model_dir), graphs[:4], graphs[4:],
        flags={"epochs": 1, "samples_per_epoch": 8, "batch_size": 2,
               "eval_every_n": 1, "best_export_metrics": ["f1"], "num_classes": 2},
        input_params={"sample_num_relations_to_consider": 16,
                      "node_buckets": [8], "edge_buckets": [32]},
        seed=0, device="cpu")
    result = trainer.train()
    assert result["history"][0]["epoch"] == 0          # fresh, not resumed
    assert "f1" in result["best_metrics"]              # export happened
    assert orbax.is_orbax_checkpoint(tckpt.best_path(str(model_dir), "f1"))


def test_exported_npz_loads_into_the_predictors(tmp_path):
    """A best export's directory loads into both predictors and gives the
    exported net's outputs; frozen by ``export_checkpoint_frozen``, the
    segmentation export predicts the same."""
    from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
    from citlab_as_tpu_torch.models.arunet import ARUNet
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.train.export import export_checkpoint_frozen
    from citlab_as_tpu_torch.train.trainer import init_gnn_params
    from tests.test_training import _write_graph_jsons

    net = ARUNet(n_classes=2, graph_params=TINY_GP).init_random(11)
    best = tckpt.export_best(
        str(tmp_path), "accuracy",
        tckpt.variables(weights.arunet_flax_from_state_dict(net.state_dict())))
    pred = SegmentationPredictor(best, graph_params=TINY_GP, dtype=torch.float32,
                                 pad_multiple=16, device="cpu")
    frozen = export_checkpoint_frozen(best, str(tmp_path / "seg.frozen"), "arunet",
                                      {"n_classes": 2, "graph_params": TINY_GP})
    frozen_pred = SegmentationPredictor(frozen, pad_multiple=16, device="cpu")
    image = np.random.RandomState(0).rand(40, 48).astype(np.float32)
    padded = np.zeros((1, 48, 48, 1), np.float32)     # the predictor's pad to 16
    padded[0, :40, :, 0] = image
    with torch.no_grad():
        want = torch.softmax(net(torch.from_numpy(padded)), -1)[0, :40]
    np.testing.assert_allclose(pred(image), want.numpy(), atol=1e-6)
    np.testing.assert_array_equal(frozen_pred(image), pred(image))

    gnn = init_gnn_params(GraphRelation(15, 2), seed=4)
    tckpt.export_best(str(tmp_path), "f1",
                      tckpt.variables(weights.gnn_flax_from_state_dict(gnn.state_dict())))
    rel = RelationPredictor(tckpt.best_path(str(tmp_path), "f1"), device="cpu")
    graph = json.load(open(_write_graph_jsons(tmp_path, n_graphs=1)[0]))
    conf = rel.confidences(graph)
    rel2 = RelationPredictor(None, device="cpu")
    rel2._ensure_params({"node_features": torch.zeros(1, 1, 15),
                         "edge_features": torch.zeros(1, 1, 2)})
    rel2.model.load_state_dict(gnn.state_dict())
    np.testing.assert_array_equal(conf, rel2.confidences(graph))


def _write_npz_dir(path, flat):
    """A checkpoint directory as earlier port runs wrote it: one
    ``checkpoint.npz`` of ``/``-joined paths."""
    os.makedirs(path)
    np.savez(os.path.join(path, tckpt.CHECKPOINT_FILE), **flat)


def test_an_earlier_npz_checkpoint_still_restores_and_resumes(tmp_path):
    """A model_dir of an earlier port run (``checkpoint.npz`` per step, the
    port's flat optimizer layout) restores, and the GNN trainer resumes it:
    its live state equals the saved one, and the step it writes next is an
    orbax checkpoint."""
    from tests.test_training import _write_graph_jsons
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    (tmp_path / "data").mkdir()
    graphs = _write_graph_jsons(tmp_path / "data", n_graphs=6)
    flags = {"epochs": 1, "samples_per_epoch": 4, "batch_size": 2, "eval_every_n": 1,
             "best_export_metrics": ["f1"], "num_classes": 2}
    inputs = {"sample_num_relations_to_consider": 16, "node_buckets": [8],
              "edge_buckets": [32]}
    first = TrainerGNN(str(tmp_path / "a"), graphs[:4], graphs[4:], flags=flags,
                       input_params=inputs, seed=0, device="cpu").train()["state"]
    flat = {f"params/{k}": v
            for k, v in weights.gnn_flax_from_state_dict(first["params"]).items()}
    opt = first["opt_state"]
    flat["opt_state/count"] = np.int32(opt["count"])
    for slot in ("mu", "nu"):
        flat.update({f"opt_state/{slot}/{k}": v for k, v in
                     weights.gnn_flax_from_state_dict(opt[slot]).items()})
    model_dir = tmp_path / "old"
    _write_npz_dir(str(model_dir / "0"), flat)
    tckpt.write_epoch_info(str(model_dir), 1, extra={"best_metrics": {"f1": 0.0}})
    saved, step = tckpt.restore_checkpoint(str(model_dir))
    assert step == 0 and sorted(tckpt.flatten(saved)) == sorted(flat)
    variables, where = tckpt.checkpoint_variables(str(model_dir))
    assert where == str(model_dir / "0")
    assert sorted(variables) == sorted(k[len("params/"):] for k in flat if
                                       k.startswith("params/"))

    resumed = TrainerGNN(str(model_dir), graphs[:4], graphs[4:], flags=flags,
                         input_params=inputs, seed=0, device="cpu").train()
    assert resumed["history"] == []
    _assert_same_flat({f"params/{k}": v for k, v in
                       weights.gnn_flax_from_state_dict(resumed["state"]["params"]).items()},
                      {k: v for k, v in flat.items() if k.startswith("params/")})
    assert resumed["state"]["opt_state"]["count"] == int(opt["count"])
    cont = TrainerGNN(str(model_dir), graphs[:4], graphs[4:], flags=dict(flags, epochs=2),
                      input_params=inputs, seed=0, device="cpu").train()
    assert [r["epoch"] for r in cont["history"]] == [1]
    assert orbax.is_orbax_checkpoint(str(model_dir / "1"))
    assert tckpt.CHECKPOINT_FILE not in os.listdir(model_dir / "1")
