"""The port's relation GNN against the JAX package's, on the CPU.

- graph helpers (``models/gnn/graph.py``): equal results on random graphs;
- ``GraphRelation`` logits against flax within 1e-5 absolute, with random
  weights, for every non-visual option of the JAX module (attention with
  concat / average heads, ``max`` aggregation with a node that has no
  in-edges, node-feature compression, the three output types, no
  transitions) and on a padded group;
- the converted ``gnn`` and ``gnn_pipeline`` weights on feature JSONs
  written by the feature stage, and ``RelationPredictor.confidences_batch``
  within 1e-5 on a group of pages of different node counts, one of them
  past the last node bucket.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.inference import RelationPredictor as JRelationPredictor
from citlab_as_tpu.models.gnn import graph as jgraph
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu_torch.inference import RelationPredictor
from citlab_as_tpu_torch.models.gnn import graph as tgraph
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.weights import gnn_state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _random_graph(rng, n, dn=15, de=2, n_edges=None):
    n_edges = 3 * n if n_edges is None else n_edges
    edges = np.stack([rng.randint(0, n, n_edges), rng.randint(0, n, n_edges)], 1)
    return {"num_nodes": n,
            "node_features": rng.rand(n, dn).astype(np.float32).tolist(),
            "interacting_nodes": edges.tolist(),
            "edge_features": rng.randint(0, 2, (n_edges, de)).astype(float).tolist()}


@pytest.mark.parametrize("seed", range(4))
def test_graph_helpers_equal(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(2, 30)
    assert np.array_equal(tgraph.fully_connected_edges(n), jgraph.fully_connected_edges(n))
    edges = rng.randint(0, n, (4 * n, 2)).astype(np.int32)
    feats = rng.rand(4 * n, 3).astype(np.float32)
    for undirected in (True, False):
        te, tf = tgraph.correct_edges(edges, feats, n, undirected)
        je, jf = jgraph.correct_edges(edges, feats, n, undirected)
        assert np.array_equal(te, je) and np.array_equal(tf, jf)
    gt = np.array([[1, 0, 1], [1, 1, 0]], np.int32) if n > 1 else None
    for a, b in zip(tgraph.build_full_relations(n, gt), jgraph.build_full_relations(n, gt)):
        assert np.array_equal(a, b)
    rels, _, gtm = tgraph.build_full_relations(n, None)
    tp = tgraph.pad_graph(n, feats[:n], te, tf, rels, gtm, 64, 256, 4096)
    jp = jgraph.pad_graph(n, feats[:n], je, jf, rels, gtm, 64, 256, 4096)
    tb, jb = tgraph.batch_graphs([tp, tp]), jgraph.batch_graphs([jp, jp])
    assert tb.keys() == jb.keys()
    for k in tb:
        assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k


OPTIONS = {
    "default": ({}, {}, {}),
    "attention_concat": ({}, {"use_attention": True, "num_attention_heads": 2,
                              "multihead_attention_merge_type": "concat"}, {}),
    "attention_average": ({}, {"use_attention": True, "num_attention_heads": 3,
                               "multihead_attention_merge_type": "average"}, {}),
    "max_aggregation": ({}, {"aggregation_type": "max"}, {}),
    "attention_max": ({}, {"use_attention": True, "aggregation_type": "max"}, {}),
    "compress": ({"compress_node_feature_dim": 8}, {}, {}),
    "add_output": ({"output_type": "add_final_hidden_and_input"}, {}, {}),
    "concat_output": ({"output_type": "concat_final_hidden_and_input"}, {},
                      {"incorporate_hidden_features_in_update": False}),
    "no_input_in_update": ({"num_transition_steps": 2}, {},
                           {"incorporate_node_input_features_in_update": False}),
    "no_transitions": ({"num_transition_steps": 0}, {}, {}),
}


def _batch(rng, sizes, max_nodes, max_edges, dn=15, de=2):
    padded = []
    for n in sizes:
        g = _random_graph(rng, n, dn, de, n_edges=2 * n)
        # node 0 of every graph gets no in-edges (an empty segment)
        edges = np.asarray(g["interacting_nodes"], np.int32)
        edges = edges[edges[:, 1] != 0]
        ef = np.asarray(g["edge_features"], np.float32)[:len(edges)]
        e, f = jgraph.correct_edges(edges, ef, n, undirected=False)
        rels, _, _ = jgraph.build_full_relations(n, None)
        padded.append(jgraph.pad_graph(n, np.asarray(g["node_features"], np.float32),
                                       e, f, rels, None, max_nodes, max_edges,
                                       max_nodes * max_nodes))
    return jgraph.batch_graphs(padded)


def _torch_inputs(batch):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        if k in ("interacting_nodes", "relations_to_consider"):
            t = t.long()
        out[k] = t
    return out


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_graph_relation_logits_match_flax(option):
    gp, mp, up = OPTIONS[option]
    rng = np.random.RandomState(sorted(OPTIONS).index(option))
    batch = _batch(rng, [7, 3, 16], max_nodes=16, max_edges=64)
    jmodel = JGraphRelation(gnn_params=gp, message_params=mp, update_params=up)
    jin = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jmodel.init(jax.random.PRNGKey(len(option)), jin)
    # flax inits biases at zero: give them values so they are checked too
    flat = {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(variables, sep="/").items()}
    flat = {k: (rng.randn(*v.shape).astype(np.float32) * 0.3 if k.endswith("bias") else v)
            for k, v in flat.items()}
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                              for k, v in flat.items()})
    want = np.asarray(jmodel.apply(variables, jin))

    tmodel = GraphRelation(15, 2, gnn_params=gp, message_params=mp, update_params=up)
    tmodel.load_state_dict(gnn_state_dict_from_flax(flat))
    with torch.no_grad():
        got = tmodel(_torch_inputs(batch)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_padded_group_member_is_independent():
    """A graph's logits do not depend on the group it is padded into."""
    rng = np.random.RandomState(5)
    batch = _batch(rng, [9, 4], max_nodes=16, max_edges=64)
    model = GraphRelation(15, 2)
    with torch.no_grad():
        both = model(_torch_inputs(batch))
        alone = model(_torch_inputs({k: v[:1] for k, v in batch.items()}))
    np.testing.assert_allclose(both[:1].numpy(), alone.numpy(), rtol=0, atol=1e-6)


def test_unknown_paths_and_visual_branch_raise():
    """Paths the relation GNN does not have raise; the visual branch builds
    with every backbone, Inception v3 included, and raises for an unknown
    one and for the Inception net's train mode (its batch statistics are
    never mutable, as in the JAX package)."""
    from citlab_as_tpu_torch.models.inception_v3 import InceptionV3, TrainModeUnsupported
    with pytest.raises(KeyError):
        gnn_state_dict_from_flax({"params/visual/attention_head/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError):
        gnn_state_dict_from_flax({"params/GraphLSTM1/update_fn/ingate/scale": np.zeros(2)})
    assert GraphRelation(15, 2, image_input=True, visual_backbone="ARU_cutted_v1").visual
    assert RelationPredictor(image_input=True, device="cpu").image_input
    model = GraphRelation(15, 2, image_input=True, visual_backbone="inception_v3")
    assert isinstance(model.visual.backbone, InceptionV3)
    assert RelationPredictor(image_input=True, visual_backbone="inception_v3",
                             device="cpu").visual_backbone == "inception_v3"
    with pytest.raises(ValueError, match="Unknown visual backbone"):
        GraphRelation(15, 2, image_input=True, visual_backbone="resnet")
    with pytest.raises(TrainModeUnsupported):
        model.visual.backbone(torch.zeros(1, 80, 80, 1), train=True)


@pytest.fixture(scope="module")
def feature_jsons(tmp_path_factory):
    """Feature JSONs of two demo pages written by the JAX package's stages
    (baseline clustering, text regions, features)."""
    import sys
    sys.path.insert(0, REPO)
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu.stages.baseline_clustering import cluster_page
    from citlab_as_tpu.stages.features import generate_feature_jsons
    from citlab_as_tpu.stages.textregion import generate_text_regions_for_page
    work = str(tmp_path_factory.mktemp("gnn_feats"))
    pages, images = [], []
    for i, seed in enumerate((3, 11)):
        img, _ = make_demo_page(work, f"d{i}", np.random.RandomState(seed))
        page = os.path.join(work, "page", f"d{i}.xml")
        cluster_page(page, min_polygons_for_cluster=3, rectangle_interline_factor=0.4)
        generate_text_regions_for_page(page)
        pages.append(page)
        images.append(img)
    paths = generate_feature_jsons(pages, visual_regions=False, separators="bb",
                                   image_paths=images)
    graphs = []
    for p in paths:
        with open(p) as f:
            graphs.append(json.load(f))
    return graphs


@pytest.mark.parametrize("net", ("gnn", "gnn_pipeline"))
def test_converted_weights_on_feature_jsons(net, feature_jsons):
    assert all(g["num_nodes"] >= 4 for g in feature_jsons)
    jpred = JRelationPredictor(os.path.join(REPO, "models_ckpt", net, "best", "f1"))
    tpred = RelationPredictor(os.path.join(REPO, "models_ckpt_torch", f"{net}.npz"),
                              device="cpu")
    for want, got in zip(jpred.confidences_batch(feature_jsons),
                         tpred.confidences_batch(feature_jsons)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_relation_predictor_group_across_buckets():
    """One group of pages of 3, 20, 40 and 100 nodes with node buckets
    (16, 32, 64): 100 is past the last bucket, which grows to 128. Then a
    smaller group pads up to the grown buckets. Every page within 1e-5 of
    the JAX predictor with the same buckets."""
    rng = np.random.RandomState(9)
    group = [_random_graph(rng, n) for n in (3, 20, 40, 100)]
    small = [_random_graph(rng, n) for n in (5, 9)]
    npz = os.path.join(REPO, "models_ckpt_torch", "gnn.npz")
    buckets = (16, 32, 64)
    tpred = RelationPredictor(npz, node_buckets=buckets, device="cpu")
    jpred = JRelationPredictor(os.path.join(REPO, "models_ckpt", "gnn", "best", "f1"),
                               node_buckets=buckets)
    for graphs in (group, small):
        got = tpred.confidences_batch(graphs)
        want = jpred.confidences_batch(graphs)
        assert [g.shape for g in got] == [(g["num_nodes"],) * 2 for g in graphs]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert tpred._node_bucket == 128 and tpred.node_buckets[-1] == 128
    assert tpred._group_bucket == 4
    single = tpred.confidences(small[0])
    np.testing.assert_allclose(single, tpred.confidences_batch(small)[0], rtol=0, atol=1e-6)
