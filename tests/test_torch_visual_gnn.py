"""The port's visual relation GNN (the 'v' nets) against the JAX package's,
on the CPU.

- ``resize_image_ratio``: the JAX function's output shape and padding, its
  values within 1e-3 on the 0-255 scale (the port's resize uses jax's
  weight matrices bit for bit, ``test_torch_ops.py``; the two matmul
  libraries sum in different orders, a few float32 ulps apart);
- ``normalize_visual_regions``, ``_bbox_from_regions`` and
  ``region_max_pool`` equal to JAX (the max bit for bit, also when it is
  split into chunks of regions);
- ``ARUCutted`` end points, ``MultiResolutionFeatureMaps`` and
  ``GraphRelation(image_input=True)`` logits (both ARU backbones) within
  1e-5 of flax with random weights;
- the converted ``gnn_visual`` checkpoint: every flax leaf consumed exactly
  once, and its confidences within 1e-5 of the JAX predictor's on feature
  JSONs and page images at 288 / 384 (the checkpoint's evaluation sizes);
- the visual clustered PAGE-XML of ``gnn_clustering_for_page`` byte-equal
  to the reference's.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.inference import RelationPredictor as JRelationPredictor
from citlab_as_tpu.models import arunet as jarunet
from citlab_as_tpu.models.gnn import visual as jvisual
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu.ops.image_utils import resize_image_ratio as jresize_image_ratio
from citlab_as_tpu.pagexml import page as jpage
from citlab_as_tpu_torch.inference import RelationPredictor
from citlab_as_tpu_torch.models.arunet import ARUCutted
from citlab_as_tpu_torch.models.gnn import visual as tvisual
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.ops.image_utils import resize_image_ratio
from citlab_as_tpu_torch.pagexml import page as tpage
from citlab_as_tpu_torch.weights import (
    arunet_state_dict_from_flax, gnn_state_dict_from_flax, load_npz,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TOL = 1e-5
VISUAL_CKPT = os.path.join(REPO, "models_ckpt", "gnn_visual", "best", "f1")
VISUAL_NPZ = os.path.join(REPO, "models_ckpt_torch", "gnn_visual.npz")
# the checkpoint's evaluation sizes (scripts/eval_visual_gnn.py)
VISUAL_KW = dict(image_input=True, visual_backbone="ARU_cutted_v1",
                 image_min_dimension=288, image_max_dimension=384)


def _flat(variables, rng=None):
    """Flat float32 {path: array}; with ``rng`` the biases get random values
    (flax starts them at a constant) so that they are checked too."""
    flat = {k: np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(variables, sep="/").items()}
    if rng is not None:
        flat = {k: (rng.randn(*v.shape).astype(np.float32) * 0.3 if k.endswith("bias") else v)
                for k, v in flat.items()}
    return flat


def _unflat(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


@pytest.mark.parametrize("shape,dims,pad", [((700, 500), (288, 384), True),
                                            ((2000, 1420), (288, 384), True),
                                            ((120, 333), (600, 1024), False),
                                            ((64, 48), (64, 96), True)])
def test_resize_image_ratio_equals_jax(shape, dims, pad):
    rng = np.random.RandomState(sum(shape))
    image = rng.randint(0, 256, shape).astype(np.uint8)
    got, got_shape = resize_image_ratio(image, *dims, pad_to_max_dimension=pad)
    want, want_shape = jresize_image_ratio(image, *dims, pad_to_max_dimension=pad)
    assert got_shape == want_shape
    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
    if pad:
        assert not got[got_shape[0]:].any() and not got[:, got_shape[1]:].any()


def _regions(rng, b, n, p, extent):
    regions = (rng.rand(b, n, 2, p) * extent).astype(np.float32)
    counts = rng.randint(0, p + 1, (b, n)).astype(np.int32)
    return regions, counts


def test_normalize_and_bbox_equal_jax():
    rng = np.random.RandomState(0)
    regions, counts = _regions(rng, 3, 9, 8, 384.0)
    want = jvisual.normalize_visual_regions(jnp.asarray(regions), jnp.zeros((3, 2)), 384, 320)
    got = tvisual.normalize_visual_regions(torch.from_numpy(regions), 384, 320)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(tvisual._bbox_from_regions(got, torch.from_numpy(counts)),
                    jvisual._bbox_from_regions(want, jnp.asarray(counts))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("chunk", [1 << 24, 4096])
def test_region_max_pool_bit_equal(chunk, monkeypatch):
    """Random maps, random boxes (some empty, some past the edges, padded
    regions with no points): the max equals JAX's bit for bit, in one chunk
    of regions and in many."""
    monkeypatch.setattr(tvisual, "_POOL_CHUNK_ELEMENTS", chunk)
    rng = np.random.RandomState(1)
    fm = rng.randn(2, 24, 20, 6).astype(np.float32)
    regions, counts = _regions(rng, 2, 13, 6, 1.3)
    regions -= 0.1
    bounds_t = tvisual._bbox_from_regions(torch.from_numpy(regions), torch.from_numpy(counts))
    bounds_j = jvisual._bbox_from_regions(jnp.asarray(regions), jnp.asarray(counts))
    got = tvisual.region_max_pool(torch.from_numpy(fm), *bounds_t).numpy()
    want = np.asarray(jvisual.region_max_pool(jnp.asarray(fm), *bounds_j))
    assert got.shape == want.shape == (2, 13, 6)
    np.testing.assert_array_equal(got, want)


def test_aru_cutted_endpoints_match_flax():
    rng = np.random.RandomState(2)
    x = rng.rand(2, 64, 96, 1).astype(np.float32)
    jmodel = jarunet.ARUCutted()
    flat = _flat(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want_deep, want_ends = jax.jit(jmodel.apply)(_unflat(flat), jnp.asarray(x))
    tmodel = ARUCutted()
    tmodel.load_state_dict(arunet_state_dict_from_flax(flat))
    with torch.no_grad():
        got_deep, got_ends = tmodel(torch.from_numpy(x))
    assert sorted(got_ends) == sorted(want_ends) and len(got_ends) == 6
    for k in got_ends:
        assert tuple(got_ends[k].shape) == want_ends[k].shape, k
        np.testing.assert_allclose(got_ends[k].numpy(), np.asarray(want_ends[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(got_deep.numpy(), np.asarray(want_deep), rtol=0, atol=TOL)
    assert not any(m.use_k1 for m in tmodel.modules() if hasattr(m, "use_k1"))


def test_multi_resolution_feature_maps_match_flax():
    """Projections, a pass-through map and new stride-2 maps with and
    without the 1x1 reduction."""
    rng = np.random.RandomState(3)
    ends = {"a": rng.rand(2, 17, 12, 5).astype(np.float32),
            "b": rng.rand(2, 9, 6, 7).astype(np.float32)}
    for layers, depths, reduce in ((("a", "b", ""), (24, -1, 40), True),
                                   (("b", "", ""), (-1, 20, 8), False)):
        jmod = jvisual.MultiResolutionFeatureMaps(from_layers=layers, layer_depths=depths,
                                                  insert_1x1_conv=reduce)
        jends = {k: jnp.asarray(v) for k, v in ends.items()}
        flat = _flat(jax.jit(jmod.init)(jax.random.PRNGKey(1), jends), rng)
        want = jax.jit(jmod.apply)(_unflat(flat), jends)
        tmod = tvisual.MultiResolutionFeatureMaps({"a": 5, "b": 7}, layers, depths, reduce)
        state = {k.split("/", 1)[1].replace("/kernel", ".weight").replace("/bias", ".bias"):
                 torch.from_numpy(np.ascontiguousarray(
                     v.transpose(3, 2, 0, 1) if k.endswith("kernel") else v))
                 for k, v in flat.items()}
        tmod.load_state_dict(state)
        with torch.no_grad():
            got = tmod({k: torch.from_numpy(v) for k, v in ends.items()})
        assert [g.shape[-1] for g in got] == tmod.out_channels
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def _graph(rng, n, dn=15, de=2, extent=(700, 500)):
    edges = np.stack([rng.randint(0, n, 3 * n), rng.randint(0, n, 3 * n)], 1)
    regions = []
    for _ in range(n):
        x0, y0 = rng.rand() * extent[1] * 0.8, rng.rand() * extent[0] * 0.8
        x1, y1 = x0 + rng.rand() * 90 + 5, y0 + rng.rand() * 60 + 5
        regions.append([[x0, x1, x1, x0], [y0, y0, y1, y1]])
    return {"num_nodes": n,
            "node_features": rng.rand(n, dn).astype(np.float32).tolist(),
            "interacting_nodes": edges.tolist(),
            "edge_features": rng.randint(0, 2, (3 * n, de)).astype(float).tolist(),
            "visual_regions_nodes": regions,
            "num_points_visual_regions_nodes": [4] * n}


@pytest.mark.parametrize("backbone", ["ARU_cutted_v1", "ARU_v1"])
def test_graph_relation_visual_logits_match_flax(backbone):
    """Random weights, a group of three pages with their images: the
    JAX predictor's batched inputs through flax and through the port."""
    rng = np.random.RandomState(4)
    graphs = [_graph(rng, n) for n in (5, 9, 3)]
    images = [rng.randint(0, 256, (700, 500)).astype(np.uint8) for _ in graphs]
    jpred = JRelationPredictor(image_input=True, visual_backbone=backbone,
                               image_min_dimension=64, image_max_dimension=96)
    batch, _ = jpred._batch_inputs(graphs, images)
    jmodel = JGraphRelation(image_input=True, visual_backbone=backbone)
    flat = _flat(jax.jit(jmodel.init)(jax.random.PRNGKey(2), batch), rng)
    want = np.asarray(jax.jit(jmodel.apply)(_unflat(flat), batch))

    tmodel = GraphRelation(15, 2, image_input=True, visual_backbone=backbone)
    tmodel.load_state_dict(gnn_state_dict_from_flax(flat))
    inputs = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in ("interacting_nodes", "relations_to_consider"):
        inputs[k] = inputs[k].long()
    with torch.no_grad():
        got = tmodel(inputs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_inception_backbone_raises():
    """Both packages refuse a train step with the Inception visual net: the
    JAX package never makes ``batch_stats`` mutable, so flax raises
    ``ModifyScopeVariableError`` at the first BatchNorm of a train-mode
    forward, and the port's ``GraphRelation`` raises
    ``TrainModeUnsupported`` before its backbone runs. Inference runs."""
    from flax.errors import ModifyScopeVariableError
    from citlab_as_tpu_torch.models.inception_v3 import TrainModeUnsupported
    rng = np.random.RandomState(6)
    graphs = [_graph(rng, n) for n in (4, 6)]
    images = [rng.randint(0, 256, (300, 200)).astype(np.uint8) for _ in graphs]
    batch, _ = JRelationPredictor(image_input=True, visual_backbone="inception_v3",
                                  image_min_dimension=80, image_max_dimension=96
                                  )._batch_inputs(graphs, images)
    jmodel = JGraphRelation(image_input=True, visual_backbone="inception_v3")
    variables = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch))
    with pytest.raises(ModifyScopeVariableError):
        jmodel.apply(variables, batch, train=True)
    tmodel = GraphRelation(15, 2, image_input=True, visual_backbone="inception_v3")
    inputs = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("interacting_nodes", "relations_to_consider"):
        inputs[k] = inputs[k].long()
    with pytest.raises(TrainModeUnsupported, match="batch statistics"):
        tmodel(inputs, train=True)
    with torch.no_grad():
        assert tmodel.eval()(inputs).shape[:2] == batch["relations_to_consider"].shape[:2]


def test_visual_state_dict_consumes_every_leaf_once():
    """Every flax leaf of the converted checkpoint maps to exactly one
    parameter of the port's visual net, and every parameter is filled."""
    flat = load_npz(VISUAL_NPZ)
    sd = gnn_state_dict_from_flax(flat)
    assert len(sd) == len(flat)
    assert sum(k.startswith("params/visual/") for k in flat) == \
        sum(k.startswith("visual.") for k in sd) == 18
    model = GraphRelation(15, 2, image_input=True, visual_backbone="ARU_cutted_v1")
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    assert sum(v.size for v in flat.values()) == sum(p.numel() for p in model.parameters())


@pytest.fixture(scope="module")
def visual_pages(tmp_path_factory):
    """Two demo pages through the JAX package's baseline clustering and text
    regions, with visual-region feature JSONs."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu.stages.baseline_clustering import cluster_page
    from citlab_as_tpu.stages.features import generate_feature_jsons
    from citlab_as_tpu.stages.textregion import generate_text_regions_for_page
    root = str(tmp_path_factory.mktemp("visual"))
    pages, images = [], []
    for i, seed in enumerate((3, 11)):
        img, _ = make_demo_page(root, f"d{i}", np.random.RandomState(seed))
        page = os.path.join(root, "page", f"d{i}.xml")
        cluster_page(page, min_polygons_for_cluster=3, rectangle_interline_factor=0.4)
        generate_text_regions_for_page(page)
        pages.append(page)
        images.append(img)
    jsons = generate_feature_jsons(pages, visual_regions=True, separators="bb",
                                   image_paths=images)
    return root, jsons, pages, images


@pytest.fixture(scope="module")
def visual_predictors():
    """The JAX package's visual predictor on the checkpoint and the port's
    on the converted file, at the checkpoint's evaluation sizes."""
    return (JRelationPredictor(VISUAL_CKPT, **VISUAL_KW),
            RelationPredictor(VISUAL_NPZ, device="cpu", **VISUAL_KW))


def test_converted_visual_confidences_match_jax(visual_pages, visual_predictors):
    from citlab_as_tpu_torch.utils.io import load_image
    _, jsons, _, images = visual_pages
    graphs = []
    for p in jsons:
        with open(p) as f:
            graphs.append(json.load(f))
    assert all("visual_regions_nodes" in g and g["num_nodes"] >= 4 for g in graphs)
    pages = [np.asarray(load_image(i, "L")) for i in images]
    jpred, tpred = visual_predictors
    for want, got in zip(jpred.confidences_batch(graphs, pages),
                         tpred.confidences_batch(graphs, pages)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    single = tpred.confidences(graphs[1], pages[1])
    np.testing.assert_allclose(single, tpred.confidences_batch(graphs, pages)[1],
                               rtol=0, atol=1e-6)


def test_visual_clustering_byte_equal(visual_pages, visual_predictors, tmp_path,
                                     monkeypatch):
    """``gnn_clustering_for_page`` with the visual predictor (the page
    image loaded beside the page) writes the reference's bytes."""
    from citlab_as_tpu.stages.gnn_io import gnn_clustering_for_page as jcluster
    from citlab_as_tpu_torch.stages.gnn_io import gnn_clustering_for_page as tcluster
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    root, jsons, pages, images = visual_pages
    jpred, tpred = visual_predictors
    for json_path, page, image in zip(jsons, pages, images):
        want = jcluster(json_path, jpred, out_dir=str(tmp_path / "j"), page_path=page)
        got = tcluster(json_path, tpred, out_dir=str(tmp_path / "t"), page_path=page,
                       image_path=image)
        assert open(got, "rb").read() == open(want, "rb").read()
        shutil.rmtree(os.path.dirname(got))
