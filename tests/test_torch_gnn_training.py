"""The port's relation-GNN training (``models/gnn/graph.py::
sample_relations``, ``models/gnn/loss.py``, ``train/augmentation.py``,
``train/input_pipeline.py``, ``train/trainer.py``, ``train/lav.py``, the
GNN's train mode) and the three training CLIs against the JAX package, on
the CPU.

Tolerances:
- sampled relations, augmented features, batches (every array, the index
  arrays int32 as in the JAX package), bucket sizes, file orders: bit for
  bit, with the random streams left in the same state; the visual batch's
  resized page within 1e-5 (the port's resize sums a few float32 ulps from
  XLA's, ``ops/image_utils.py``), its regions and counts bit for bit;
- ``relation_loss`` with weight decay and its gradient for every parameter
  and for the node features, against ``jax.grad``: 1e-5 relative to each
  gradient's largest entry, on a graph whose max aggregation has tied
  maxima (both split the gradient evenly over the tied entries);
- ``relation_metrics`` (AUC-PR and AUC-ROC on scores with ties) against
  sklearn and the JAX function: 1e-12; ``relation_curves`` and
  ``lav_relation``: 1e-5 (the same confidences to float32 rounding);
- ``TrainerGNN`` over 2 epochs and a resumed third, from the same init
  (weight decay, EMA, gradient accumulation, augmentation, curve export):
  the per-epoch losses within 1e-5 relative, the eval metrics, the curve
  points and the EMA weights within 1e-5 of the JAX trainer's.
"""
import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.models.gnn import graph as jgraph
from citlab_as_tpu.models.gnn import loss as jloss
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu.train import augmentation as jaug
from citlab_as_tpu.train import input_pipeline as jinput
from citlab_as_tpu.train.lav import lav_relation as jlav
from citlab_as_tpu.train.trainer import TrainerGNN as JTrainerGNN
from citlab_as_tpu_torch.models.gnn import graph as tgraph
from citlab_as_tpu_torch.models.gnn import loss as tloss
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.train import augmentation as taug
from citlab_as_tpu_torch.train import input_pipeline as tinput
from citlab_as_tpu_torch.train.lav import lav_relation
from citlab_as_tpu_torch.train.trainer import TrainerGNN
from citlab_as_tpu_torch.weights import gnn_flax_from_state_dict, gnn_state_dict_from_flax
from tests.test_training import _write_graph_jsons

RTOL = 1e-5


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _assert_same_batch(a, b, float_atol=0.0, exact_keys=()):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if float_atol and a[k].dtype == np.float32 and k not in exact_keys:
            np.testing.assert_allclose(a[k], b[k], atol=float_atol, rtol=0, err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n,n_gt,sample_num,classes,seed", [
    (5, 9, 20, 2, 0), (12, 40, 300, 2, 1), (30, 0, 64, 2, 2), (3, 4, 300, 2, 3),
    (8, 20, 30, 3, 4)])
def test_sample_relations_equal_jax(n, n_gt, sample_num, classes, seed):
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.randint(1, classes, (n_gt, 1)),
                         rng.randint(0, n, (n_gt, 2))], axis=1).astype(np.int32)
    jr, tr = random.Random(seed), random.Random(seed)
    want = jgraph.sample_relations(n, gt if n_gt else None, sample_num, classes, 2, jr)
    got = tgraph.sample_relations(n, gt if n_gt else None, sample_num, classes, 2, tr)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    assert jr.getstate() == tr.getstate()


@pytest.mark.parametrize("config,dim", [
    (["scaling", "rotation", "translation"], 15), (["rotation"], 16),
    (["scaling"], 16), (["translation", "scaling"], 8)])
def test_augmentation_equals_jax(config, dim):
    jr, tr = np.random.RandomState(7), np.random.RandomState(7)
    feats = np.random.RandomState(1).rand(6, dim).astype(np.float32)
    for _ in range(6):
        want = jaug.augment_geometric_features(feats.copy(), config, jr)
        got = taug.augment_geometric_features(feats.copy(), config, tr)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(jr.get_state()[1], tr.get_state()[1])


def test_file_iterator_and_buckets_equal_jax():
    files = [f"f{i}" for i in range(7)]
    j, t = jinput.FileListIterablor(files, seed=3), tinput.FileListIterablor(files, seed=3)
    assert [next(j) for _ in range(20)] == [next(t) for _ in range(20)]
    for v in (0, 1, 16, 17, 255, 256, 900):
        assert tinput._bucket(v, [16, 32, 256]) == jinput._bucket(v, [16, 32, 256])


def _graphs(tmp_path, n_graphs=6, n_nodes=5, seed=0):
    tmp_path.mkdir(exist_ok=True)
    return _write_graph_jsons(tmp_path, n_graphs=n_graphs, n_nodes=n_nodes, seed=seed)


INPUT_PARAMS = {"sample_num_relations_to_consider": 16, "node_buckets": [8, 16],
                "edge_buckets": [32, 128], "augmentation_config": ["scaling", "rotation",
                                                                  "translation"],
                "node_input_feature_mask": [1] * 12 + [0, 1, 1]}


def test_input_gnn_batches_equal_jax(tmp_path):
    paths = (_graphs(tmp_path / "a", 3, 5) + _graphs(tmp_path / "b", 2, 11, seed=1)
             + _graphs(tmp_path / "c", 1, 1, seed=2))        # a 1-node graph is skipped
    j = jinput.InputGNN(INPUT_PARAMS, seed=4)
    t = tinput.InputGNN(INPUT_PARAMS, seed=4)
    for _ in range(2):      # two epochs: a new file iterator each
        for jb, tb in zip(j.train_batches(paths, 3, 3), t.train_batches(paths, 3, 3)):
            _assert_same_batch(tb, jb)
    for (jb, jp, jg), (tb, tp, tg) in zip(j.eval_batches(paths), t.eval_batches(paths)):
        assert jp == tp and jg == tg
        _assert_same_batch(tb, jb)
    assert len(list(t.eval_batches(paths))) == 5
    assert np.array_equal(j._rng.get_state()[1], t._rng.get_state()[1])
    assert j._py_rng.getstate() == t._py_rng.getstate()


def test_input_gnn_visual_batches_equal_jax(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    n = 3
    regions = [[[20 + 50 * i, 60 + 50 * i, 60 + 50 * i, 20 + 50 * i],
                [20, 20, 100, 100]] for i in range(n)]
    graph = {"num_nodes": n, "interacting_nodes": [[0, 1], [1, 2]],
             "num_interacting_nodes": 2, "node_features": rng.rand(n, 15).tolist(),
             "edge_features": rng.rand(2, 2).tolist(), "visual_regions_nodes": regions,
             "num_points_visual_regions_nodes": [4] * n,
             "gt_relations": [[1, 0, 1], [1, 1, 0]], "gt_num_relations": 2}
    (tmp_path / "json").mkdir()
    jp = tmp_path / "json" / "g.json"
    jp.write_text(json.dumps(graph))
    Image.fromarray((rng.rand(200, 240) * 255).astype(np.uint8)).save(tmp_path / "g.png")
    params = {"image_input": True, "resize_min_dim": 64, "resize_max_dim": 96,
              "node_buckets": [8], "sample_num_relations_to_consider": 16}
    jb = next(jinput.InputGNN(params, seed=0).train_batches([str(jp)], 2, 1))
    tb = next(tinput.InputGNN(params, seed=0).train_batches([str(jp)], 2, 1))
    assert tb["image"].shape == (2, 96, 96, 1)
    _assert_same_batch(tb, jb, float_atol=1e-5,
                       exact_keys=("node_features", "edge_features", "visual_regions_nodes"))
    tt = tinput.torch_batch(tb, "cpu")
    assert tt["relations_to_consider"].dtype == torch.int64
    assert tt["interacting_nodes"].dtype == torch.int64
    assert tt["num_relations_to_consider"].dtype == torch.int32


def _tied_batch():
    """Nodes 1 and 2 carry the same features and edges into node 0 with the
    same edge features, so node 0's max aggregation ties at every
    transition; node 1 also sends to node 3, node 2 does not."""
    rng = np.random.RandomState(0)
    n, dn = 6, 15
    nodes = rng.rand(1, 8, dn).astype(np.float32)
    nodes[0, 2] = nodes[0, 1]
    edges = np.array([[1, 0], [2, 0], [1, 3], [4, 5], [5, 4], [3, 4]], np.int32)
    ef = rng.rand(len(edges), 2).astype(np.float32)
    ef[1] = ef[0]
    pad = lambda a, m: np.concatenate([a, np.zeros((m - len(a),) + a.shape[1:], a.dtype)])
    rels = np.array([[i, j] for i in range(n) for j in range(n)], np.int32)
    gt = np.array([int((i < 3) == (j < 3)) for i in range(n) for j in range(n)], np.int32)
    return {"num_nodes": np.array([n], np.int32), "node_features": nodes,
            "interacting_nodes": pad(edges, 8)[None],
            "num_interacting_nodes": np.array([len(edges)], np.int32),
            "edge_features": pad(ef, 8)[None],
            "relations_to_consider": pad(rels, 40)[None],
            "num_relations_to_consider": np.array([len(rels)], np.int32),
            "relations_to_consider_gt": pad(gt, 40)[None]}


@pytest.mark.parametrize("aggregation", ["max", "sum"])
def test_relation_loss_and_gradients_with_weight_decay_equal_jax(aggregation):
    batch = _tied_batch()
    mp = {"aggregation_type": aggregation}
    jmodel = JGraphRelation(num_classes=2, message_params=mp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jb)

    def jloss_fn(v, node_features):
        inputs = dict(jb, node_features=node_features)
        logits = jmodel.apply(v, inputs, train=True)
        return jloss.relation_loss(logits, jb["relations_to_consider_gt"],
                                   jb["num_relations_to_consider"],
                                   params=v.get("params"), weight_decay=0.01)

    want_loss, (want_g, want_gx) = jax.jit(jax.value_and_grad(jloss_fn, argnums=(0, 1)))(
        variables, jb["node_features"])
    model = GraphRelation(15, 2, message_params=mp)
    model.load_state_dict(gnn_state_dict_from_flax(_flat(variables)))
    tb = tinput.torch_batch(batch, "cpu")
    tb["node_features"].requires_grad_(True)
    params = dict(model.named_parameters())
    logits = model(tb, train=True)
    loss = tloss.relation_loss(logits, tb["relations_to_consider_gt"],
                               tb["num_relations_to_consider"], params=params,
                               weight_decay=0.01)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=RTOL)
    got = gnn_flax_from_state_dict({k: p.grad for k, p in params.items()})
    want = _flat(want_g)
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) / scale <= RTOL, k
    gx, want_gx = tb["node_features"].grad.numpy(), np.asarray(want_gx)
    assert float(np.abs(gx - want_gx).max()) / float(np.abs(want_gx).max()) <= RTOL
    if aggregation == "max":      # the tie split the gradient between nodes 1 and 2
        assert not np.allclose(gx[0, 1], gx[0, 2])


def test_node_feature_dropout_in_train_mode():
    batch = tinput.torch_batch(_tied_batch(), "cpu")
    model = GraphRelation(15, 2, gnn_params={"dropout_rate_node_features": 0.5})
    with torch.no_grad():
        base = model(batch)
        again = model(batch, train=False)
        a = model(batch, train=True, generator=torch.Generator().manual_seed(1))
        b = model(batch, train=True, generator=torch.Generator().manual_seed(1))
        c = model(batch, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(base, again) and torch.equal(a, b)
    assert not torch.equal(a, base) and not torch.equal(a, c)


def test_relation_metrics_with_ties_equal_sklearn_and_jax():
    from sklearn.metrics import average_precision_score, roc_auc_score
    rng = np.random.RandomState(0)
    for trial in range(6):
        conf = np.round(rng.rand(3, 40), 1 + trial % 3).astype(np.float32)   # many ties
        gt = (rng.rand(3, 40) < 0.4).astype(np.int32)
        num = np.array([40, 25, 7])
        want = jloss.relation_metrics(conf, gt, num)
        got = tloss.relation_metrics(conf, gt, num)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
        mask = np.arange(40)[None, :] < num[:, None]
        assert got["auc_pr"] == pytest.approx(
            average_precision_score(gt[mask], conf[mask]), abs=1e-12)
        assert got["auc_roc"] == pytest.approx(roc_auc_score(gt[mask], conf[mask]),
                                               abs=1e-12)
    one_class = tloss.relation_metrics(conf, np.zeros_like(gt), num)
    assert "auc_pr" not in one_class and "auc_roc" not in one_class


def test_relation_curves_equal_jax():
    rng = np.random.RandomState(1)
    conf, gt = rng.rand(2, 50).astype(np.float32), rng.randint(0, 2, (2, 50))
    num = np.array([50, 31])
    for nt in (201, 11):
        want = jloss.relation_curves(conf, gt, num, nt)
        got = tloss.relation_curves(conf, gt, num, nt)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


def test_lav_relation_equals_jax(tmp_path):
    graphs = _graphs(tmp_path, 3)
    jmodel = JGraphRelation(num_classes=2)
    batch_np, _, _ = next(iter(jinput.InputGNN().eval_batches(graphs)))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     {k: jnp.asarray(v) for k, v in batch_np.items()})
    want = jlav(jmodel, variables, graphs, num_p_r_thresholds=10)
    model = GraphRelation(15, 2)
    model.load_state_dict(gnn_state_dict_from_flax(_flat(variables)))
    got = lav_relation(model, graphs, num_p_r_thresholds=10)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RTOL, err_msg=k)


TRAINER_FLAGS = {"epochs": 2, "samples_per_epoch": 8, "batch_size": 2, "eval_every_n": 1,
                 "best_export_metrics": ["f1", "loss"], "num_classes": 2,
                 "weight_decay": 1e-3, "ema_decay": 0.5, "grad_accum_steps": 2,
                 "export_curves": True}
TRAINER_INPUT = {"sample_num_relations_to_consider": 16, "node_buckets": [8],
                 "edge_buckets": [32], "augmentation_config": ["scaling", "rotation"]}


def test_trainer_two_epochs_and_resume_equal_jax(tmp_path):
    graphs = _graphs(tmp_path / "data", 6)
    batch_np = next(jinput.InputGNN(TRAINER_INPUT, seed=0).train_batches(graphs[:4], 2, 1))
    init = _flat(jax.jit(JGraphRelation(num_classes=2).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch_np.items()}))
    runs = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        for epochs in (2, 3):
            flags = dict(TRAINER_FLAGS, epochs=epochs)
            if name == "jax":
                trainer = JTrainerGNN(d, graphs[:4], graphs[4:], flags=flags,
                                      input_params=TRAINER_INPUT, seed=0)
            else:
                trainer = TrainerGNN(d, graphs[:4], graphs[4:], flags=flags,
                                     input_params=TRAINER_INPUT, seed=0, device="cpu",
                                     init_params=init)
            runs[(name, epochs)] = trainer.train()
    for epochs in (2, 3):
        want, got = runs[("jax", epochs)], runs[("port", epochs)]
        assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]]
        for w, g in zip(want["history"], got["history"]):
            assert sorted(g) == sorted(w)
            assert g["loss"] == pytest.approx(w["loss"], rel=RTOL)
            for k in w:
                assert g[k] == pytest.approx(w[k], abs=RTOL), (k, g, w)
        assert got["best_metrics"] == pytest.approx(want["best_metrics"], abs=RTOL)
    assert runs[("port", 3)]["history"][0]["epoch"] == 2
    for epoch in range(3):
        name = os.path.join("curves", f"epoch_{epoch:04d}.json")
        want = json.load(open(tmp_path / "jax" / name))
        got = json.load(open(tmp_path / "port" / name))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=RTOL, err_msg=k)
    ema = gnn_flax_from_state_dict(runs[("port", 3)]["state"]["ema"])
    jema = _flat(runs[("jax", 3)]["state"]["ema"])
    for k in jema:
        scale = max(float(np.abs(jema[k]).max()), 1e-30)
        assert float(np.abs(ema[k] - jema[k]).max()) / scale <= RTOL, k


def _list(path, items):
    with open(path, "w") as f:
        f.write("\n".join(items) + "\n")
    return str(path)


def test_training_clis_run_on_the_cpu(tmp_path):
    from citlab_as_tpu_torch.cli import run_lav, run_train_gnn, run_train_segmentation
    from citlab_as_tpu_torch.train.checkpoint import CHECKPOINT_FILE, best_path
    from citlab_as_tpu_torch.train.orbax import is_orbax_checkpoint
    from tests.test_seg_training import PAGE
    graphs = _graphs(tmp_path / "data", 4)
    train, evl = _list(tmp_path / "train.lst", graphs[:3]), _list(tmp_path / "eval.lst",
                                                                   graphs[3:])
    out = run_train_gnn.main(["--model_dir", str(tmp_path / "gnn"), "--train_list", train,
                              "--eval_list", evl, "--epochs", "1", "--samples_per_epoch",
                              "4", "--batch_size", "2", "--sample_num_relations", "16",
                              "--optimizer_params", "learning_rate=0.01",
                              "--device", "cpu"])
    assert len(out["history"]) == 1 and is_orbax_checkpoint(best_path(str(tmp_path / "gnn"), "f1"))
    for written in (best_path(str(tmp_path / "gnn"), "f1"), str(tmp_path / "gnn" / "0")):
        assert is_orbax_checkpoint(written) and CHECKPOINT_FILE not in os.listdir(written)
    lav_json = tmp_path / "lav.json"
    res = run_lav.main(["--model_dir", str(tmp_path / "gnn"), "--eval_list", evl,
                        "--num_p_r_thresholds", "5", "--out_json", str(lav_json),
                        "--device", "cpu"])
    assert np.isfinite(res["best_f1"]) and json.load(open(lav_json)) == res
    with pytest.raises(FileNotFoundError):
        run_lav.main(["--model_dir", str(tmp_path / "none"), "--eval_list", evl,
                      "--device", "cpu"])

    from citlab_as_tpu.stages.ground_truth import RegionGroundTruthGenerator
    from PIL import Image
    img = np.full((200, 200), 255, np.uint8)
    img[30:60, 30:170] = 0
    Image.fromarray(img).save(tmp_path / "a.png")
    (tmp_path / "page").mkdir()
    (tmp_path / "page" / "a.xml").write_text(PAGE.format(name="a"))
    RegionGroundTruthGenerator([str(tmp_path / "a.png")],
                               region_types=["TextRegion", "SeparatorRegion"]
                               ).run_ground_truth_generation(str(tmp_path / "gt"))
    out = run_train_segmentation.main([
        "--model_dir", str(tmp_path / "seg"), "--train_gt_dir", str(tmp_path / "gt"),
        "--eval_gt_dir", str(tmp_path / "gt"), "--epochs", "1", "--steps_per_epoch", "1",
        "--batch_size", "1", "--crop_size", "64", "64", "--n_classes", "3",
        "--graph", "RU", "--device", "cpu"])
    assert np.isfinite(out["history"][0]["loss"])
    assert is_orbax_checkpoint(best_path(str(tmp_path / "seg"), "accuracy"))
    assert CHECKPOINT_FILE not in os.listdir(best_path(str(tmp_path / "seg"), "accuracy"))
