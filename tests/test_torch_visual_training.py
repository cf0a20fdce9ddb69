"""Training the visual relation GNN (the 'v' nets) in the port against the
JAX package, on the CPU, with the ``ARU_cutted_v1`` backbone (the full
``ARU_v1`` is held in ``test_torch_visual_training_aru.py``).

- ``TrainerGNN(model=GraphRelation(15, 2, image_input=True, ...))`` from
  the JAX trainer's own init (converted) over the same visual batches
  (96 x 96 images, node bucket 8, 16 relations, EMA, weight decay 1e-6):
  each of the 3 step losses within 1e-5, every parameter and EMA leaf
  within 1e-5 of its scale after them, the eval metrics equal;
- the L2 term of ``relation_loss`` over the visual tree (backbone included)
  equals JAX's; ``region_max_pool``'s gradient on tied cells equals
  ``jax.grad``'s (equal shares);
- checkpoints cross both ways: the JAX trainer resumes the port's run
  directory and the port resumes the JAX trainer's, one epoch more each,
  and the two resumed runs agree;
- the port's ``best/f1`` export, and its ``.frozen``, serve in both
  packages' ``RelationPredictor(image_input=True)`` with equal confidences.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.models.gnn import loss as jloss
from citlab_as_tpu.models.gnn import visual as jvisual
from citlab_as_tpu.models.gnn.graph import fully_connected_edges
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu.train.trainer import TrainerGNN as JTrainerGNN
from citlab_as_tpu_torch.models.gnn import loss as tloss
from citlab_as_tpu_torch.models.gnn import visual as tvisual
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.train.trainer import TrainerGNN
from citlab_as_tpu_torch.utils.io import save_png
from citlab_as_tpu_torch.weights import gnn_flax_from_state_dict, gnn_state_dict_from_flax

TOL = 1e-5
INPUT = {"sample_num_relations_to_consider": 16, "node_buckets": [8], "edge_buckets": [64],
         "image_input": True, "resize_min_dim": 64, "resize_max_dim": 96}
FLAGS = {"epochs": 1, "samples_per_epoch": 6, "batch_size": 2, "eval_every_n": 1,
         "weight_decay": 1e-6, "ema_decay": 0.5, "export_curves": True}
PREDICT_KW = dict(image_input=True, image_min_dimension=64, image_max_dimension=96)


def write_visual_graphs(root, n_graphs=4, n_nodes=6, seed=0, size=(90, 72)):
    """``n_graphs`` page graphs (two articles each) with node regions, as
    ``json/g<i>.json`` beside their random grey images ``g<i>.png``."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "json"), exist_ok=True)
    paths = []
    for g in range(n_graphs):
        h, w = size
        save_png(os.path.join(root, f"g{g}.png"), (rng.rand(h, w) * 255).astype(np.uint8))
        edges = fully_connected_edges(n_nodes)
        gt = [[1, i, j] for i in range(n_nodes) for j in range(n_nodes)
              if (i < 3) == (j < 3)]
        regions = []
        for _ in range(n_nodes):
            x0, y0 = rng.randint(0, w - 20), rng.randint(0, h - 20)
            x1, y1 = x0 + rng.randint(5, 20), y0 + rng.randint(5, 20)
            regions.append([[x0, x1, x1, x0], [y0, y0, y1, y1]])
        graph = {"num_nodes": n_nodes, "interacting_nodes": edges.tolist(),
                 "num_interacting_nodes": len(edges),
                 "node_features": rng.rand(n_nodes, 15).tolist(),
                 "edge_features": rng.rand(len(edges), 2).tolist(),
                 "visual_regions_nodes": regions,
                 "num_points_visual_regions_nodes": [4] * n_nodes,
                 "gt_relations": gt, "gt_num_relations": len(gt)}
        path = os.path.join(root, "json", f"g{g}.json")
        with open(path, "w") as f:
            json.dump(graph, f)
        paths.append(path)
    return paths


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def jax_trainer(model_dir, paths, backbone, flags, record):
    """The JAX trainer with its init and each step's loss recorded."""
    trainer = JTrainerGNN(model_dir, paths[:3], paths[3:], flags=flags, input_params=INPUT,
                          model=JGraphRelation(num_classes=2, image_input=True,
                                               visual_backbone=backbone), seed=0)
    init_state, make_step = trainer._init_state, trainer._make_train_step

    def recording_init(batch):
        state = init_state(batch)
        record.setdefault("init", flat(state["params"]))
        return state

    def recording_step():
        step = make_step()

        def run(state, batch):
            state, loss = step(state, batch)
            record.setdefault("losses", []).append(float(loss))
            return state, loss
        return run

    trainer._init_state, trainer._make_train_step = recording_init, recording_step
    return trainer


def port_trainer(model_dir, paths, backbone, flags, record, init=None):
    """The port's trainer with each step's loss recorded."""
    trainer = TrainerGNN(model_dir, paths[:3], paths[3:], flags=flags, input_params=INPUT,
                         seed=0, device="cpu", init_params=init,
                         model=GraphRelation(15, 2, image_input=True,
                                             visual_backbone=backbone))
    make_step = trainer._make_train_step

    def recording_step():
        step = make_step()

        def run(params, opt_state, batch):
            loss = step(params, opt_state, batch)
            record.setdefault("losses", []).append(float(loss))
            return loss
        return run

    trainer._make_train_step = recording_step
    return trainer


def train_both(root, backbone, flags):
    """Train the JAX package's and the port's trainer from the JAX init on
    the same files; returns the graphs and both runs' records."""
    paths = write_visual_graphs(os.path.join(root, "data"))
    runs = {"jax": {}, "port": {}}
    runs["jax"]["result"] = jax_trainer(os.path.join(root, "jax"), paths, backbone, flags,
                                        runs["jax"]).train()
    runs["port"]["result"] = port_trainer(os.path.join(root, "port"), paths, backbone, flags,
                                          runs["port"], init=runs["jax"]["init"]).train()
    return paths, runs


def assert_close_leaves(got_flat, want_flat, tol=TOL, norm=False):
    """Every leaf's largest difference within ``tol`` of its largest value,
    or with ``norm`` the difference's norm within ``tol`` of the leaf's."""
    assert sorted(got_flat) == sorted(want_flat)
    for k, want in want_flat.items():
        diff = got_flat[k] - want
        if norm:
            assert np.linalg.norm(diff) <= tol * max(np.linalg.norm(want), 1e-30), k
        else:
            assert float(np.abs(diff).max()) <= tol * max(float(np.abs(want).max()), 1e-30), k


def assert_same_runs(got, want):
    """Per-step losses within TOL, the eval metrics equal (AUCs within TOL)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL, atol=0)
    for g, w in zip(got["result"]["history"], want["result"]["history"]):
        assert sorted(g) == sorted(w)
        assert g["epoch"] == w["epoch"]
        for k in ("accuracy", "precision", "recall", "f1"):
            assert g[k] == w[k], (k, g, w)
        for k in ("loss", "auc_pr", "auc_roc"):
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=TOL, abs=TOL), (k, g, w)


@pytest.fixture(scope="module")
def cutted_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("visual_train"))
    paths, runs = train_both(root, "ARU_cutted_v1", FLAGS)
    return root, paths, runs


def test_visual_trainer_steps_equal_jax(cutted_runs):
    _, _, runs = cutted_runs
    assert len(runs["port"]["losses"]) == 3
    assert_same_runs(runs["port"], runs["jax"])
    state, jstate = runs["port"]["result"]["state"], runs["jax"]["result"]["state"]
    assert any(k.startswith("visual.backbone.res_block_") for k in state["params"])
    assert_close_leaves(gnn_flax_from_state_dict(state["params"]), flat(jstate["params"]))
    assert_close_leaves(gnn_flax_from_state_dict(state["ema"]), flat(jstate["ema"]))
    for name in ("jax", "port"):
        assert os.path.isfile(os.path.join(cutted_runs[0], name, "curves", "epoch_0000.json"))


def test_visual_l2_term_equals_jax(cutted_runs):
    """The weight-decay term over every non-bias leaf, the backbone's
    included, named by flax path."""
    init = cutted_runs[2]["jax"]["init"]
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 16, 2).astype(np.float32)
    targets = rng.randint(0, 2, (2, 16)).astype(np.int32)
    num = np.asarray([16, 11], np.int32)
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                              for k, v in init.items()})
    want = [float(jloss.relation_loss(jnp.asarray(logits), jnp.asarray(targets),
                                      jnp.asarray(num), params=variables["params"],
                                      weight_decay=wd)) for wd in (0.0, 1e-6)]
    model = GraphRelation(15, 2, image_input=True, visual_backbone="ARU_cutted_v1")
    model.load_state_dict(gnn_state_dict_from_flax(init))
    got = [float(tloss.relation_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                     torch.from_numpy(num), params=dict(model.named_parameters()),
                                     weight_decay=wd)) for wd in (0.0, 1e-6)]
    assert want[1] > want[0]
    assert got[1] - got[0] == pytest.approx(want[1] - want[0], rel=1e-5)
    assert got == pytest.approx(want, rel=1e-6)


def test_region_max_pool_tied_gradient_equals_jax():
    """Tied maxima share the gradient equally, in both of the pooling's
    reductions, as ``jnp.max``'s gradient does."""
    fm = np.zeros((2, 6, 5, 3), np.float32)
    fm[0, 1:4, 1:3, 0] = 2.0           # a plateau of tied maxima
    fm[0, 2, 4, 1] = 1.5
    fm[0, 4, 0, 1] = 1.5               # tied across rows and columns
    fm[1] = np.random.RandomState(0).rand(6, 5, 3).round(1)   # many ties
    bounds = [np.asarray([[0.1, 0.0, 0.5], [0.2, 0.0, 0.9]], np.float32),
              np.asarray([[0.9, 0.99, 0.6], [0.7, 0.5, 0.99]], np.float32),
              np.asarray([[0.1, 0.0, 0.4], [0.0, 0.3, 0.5]], np.float32),
              np.asarray([[0.8, 0.99, 0.5], [0.99, 0.6, 0.99]], np.float32)]
    weights = np.random.RandomState(1).rand(2, 3, 3).astype(np.float32)

    def jfn(x):
        return jnp.sum(jvisual.region_max_pool(x, *map(jnp.asarray, bounds)) * weights)
    want = np.asarray(jax.grad(jfn)(jnp.asarray(fm)))
    x = torch.from_numpy(fm).requires_grad_(True)
    (tvisual.region_max_pool(x, *map(torch.from_numpy, bounds))
     * torch.from_numpy(weights)).sum().backward()
    assert (want > 0).sum() > (weights > 0).sum()      # shares were split
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=1e-7)


def test_visual_checkpoints_cross_both_ways(cutted_runs):
    """The JAX trainer resumes the port's orbax step and the port resumes
    the JAX trainer's, one more epoch each, from the same data: the two
    resumed runs agree."""
    root, paths, runs = cutted_runs
    flags = dict(FLAGS, epochs=2)
    resumed = {}
    for trainer_kind, source in (("jax", "port"), ("port", "jax")):
        model_dir = os.path.join(root, f"{trainer_kind}_from_{source}")
        shutil.copytree(os.path.join(root, source), model_dir)
        make = jax_trainer if trainer_kind == "jax" else port_trainer
        resumed[trainer_kind] = record = {}
        record["result"] = make(model_dir, paths, "ARU_cutted_v1", flags, record).train()
        assert [r["epoch"] for r in record["result"]["history"]] == [1]
    assert_same_runs(resumed["port"], resumed["jax"])
    assert_close_leaves(gnn_flax_from_state_dict(resumed["port"]["result"]["state"]["params"]),
                        flat(resumed["jax"]["result"]["state"]["params"]))


def test_visual_best_export_serves_in_both_predictors(cutted_runs, tmp_path):
    from citlab_as_tpu.inference import RelationPredictor as JRelationPredictor
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.train.checkpoint import best_path
    from citlab_as_tpu_torch.train.export import export_checkpoint_frozen
    from citlab_as_tpu_torch.utils.io import get_img_from_json_path, load_image
    root, paths, _ = cutted_runs
    best = best_path(os.path.join(root, "port"), "f1")
    frozen = export_checkpoint_frozen(
        best, str(tmp_path / "visual.frozen"), "graph_relation",
        model_kwargs={"num_classes": 2, "image_input": True,
                      "visual_backbone": "ARU_cutted_v1"})
    graphs = [json.load(open(p)) for p in paths[2:]]
    images = [np.asarray(load_image(get_img_from_json_path(p), "L")) for p in paths[2:]]
    kw = dict(PREDICT_KW, visual_backbone="ARU_cutted_v1")
    want = JRelationPredictor(best, **kw).confidences_batch(graphs, images)
    for model in (best, frozen):
        got = RelationPredictor(model, device="cpu", **kw).confidences_batch(graphs, images)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (6, 6)
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    got = JRelationPredictor(frozen, **kw).confidences_batch(graphs, images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
