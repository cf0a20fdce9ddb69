"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
neither jax nor the JAX package, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2


def _k1_inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    w3 = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)   # HWIO
    bias = rng.randn(cout).astype(np.float32)
    return x, w3, bias


def _to_oihw(w3):
    return torch.from_numpy(np.ascontiguousarray(w3.transpose(3, 2, 0, 1)))


def _synthetic(h=96, w=300, seed=0):
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w), np.float32)
    img[40:43, 10:290] = 255.0          # horizontal rule
    img[5:90, 150:153] = 255.0          # vertical rule
    img[(rng.rand(h, w) < 0.01)] = 255.0  # noise
    return img


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the main path's smallest instance (4 x 96 x 68) has fewer tiles than the
# card has SMs; (3, 37, 131) is ragged against every tile size
_K1_CASES = [(pair, (2, 45, 70)) for pair in [
    (8, 8), (8, 16), (16, 32), (64, 32), (32, 16), (12, 8), (16, 16), (32, 32),
    (16, 8), (10, 8)]] + [((32, 16), (4, 96, 68)), ((64, 32), (4, 96, 68)),
                 ((8, 8), (3, 37, 131)), ((24, 32), (1, 7, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("pair,bhw", _K1_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain(cuda, pair, bhw, dtype):
    cin, cout = pair
    x, w3, bias = _k1_inputs(bhw + (cin, cout), seed=cin + cout)
    xt = torch.from_numpy(x).to(cuda, dtype)
    wt = _to_oihw(w3).to(cuda, dtype)
    bt = torch.from_numpy(bias).to(cuda, dtype)
    before = k1.launches
    got = k1.conv3x3(xt, wt, bt, relu=True)
    assert k1.launches == before + 1
    want = k1.conv3x3_plain(xt, wt, bt, relu=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2 * scale), err


_K1_GRAD_PAIRS = [(8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (16, 8), (32, 16),
                  (64, 32)]


def k1_grad_errors(cin, cout, bhw, dtype, device, relu=True, seed=0):
    """K1 under autograd (``Conv3x3Function``: the kernel's forward, the
    cuDNN backward) against autograd through ``F.conv2d`` on the same card:
    per tensor (x, weight, bias) the max abs error of the gradient, divided
    by the reference gradient's largest entry for bf16, and the kernel
    launches the forward made. Under ReLU the reference is masked by the
    kernel's own output (y > 0), since the two forwards may round an output
    next to 0 to opposite signs."""
    import torch.nn.functional as F
    b, h, w = bhw
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=gen, device=device)
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device=device) * (
        2.0 / (9 * cin + cout)) ** 0.5
    bias = 0.1 + 0.02 * torch.randn((cout,), generator=gen, device=device)
    gy = torch.randn((b, h, w, cout), generator=gen, device=device).to(dtype)
    ours = [t.detach().to(dtype).clone().requires_grad_() for t in (x, wt, bias)]
    ref = [t.detach().to(dtype).clone().requires_grad_() for t in (x, wt, bias)]
    before = k1.launches
    y = k1.conv3x3(*ours, relu=relu)
    launched = k1.launches - before
    y.backward(gy)
    y_ref = F.conv2d(ref[0].permute(0, 3, 1, 2), ref[1], ref[2], padding=1).permute(0, 2, 3, 1)
    if relu:
        y_ref = y_ref * (y.detach() > 0)
    y_ref.backward(gy)
    errors = []
    for a, r in zip(ours, ref):
        err = (a.grad.float() - r.grad.float()).abs().max().item()
        if dtype == torch.bfloat16:
            err /= r.grad.float().abs().max().item()
        errors.append(err)
    return errors, launched


@pytest.mark.cuda
@pytest.mark.parametrize("pair", _K1_GRAD_PAIRS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_gradients_on_the_card(cuda, pair, dtype):
    """f32 (TF32 off) within 1e-4; bf16 within 2e-2 of the gradient's
    scale, the forward's bound; with and without ReLU."""
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for relu in (True, False):
        errors, launched = k1_grad_errors(*pair, (2, 45, 70), dtype, cuda, relu=relu,
                                          seed=sum(pair))
        assert launched == 1
        assert max(errors) <= limit, (relu, errors)


@pytest.mark.cuda
@pytest.mark.parametrize("kernels,hw", [
    ((15, 30, 10), (150, 700)), ((4, 6, 2), (150, 700)), ((45, 30, 25), (150, 700)),
    ((48, 30, 32), (150, 3200)), ((15, 30, 10), (131, 333))])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_separator_morphology_kernel_matches_plain(cuda, kernels, hw, dtype):
    imgs = np.stack([_synthetic(h=hw[0], w=hw[1], seed=s) for s in (0, 1, 2)])
    x = torch.from_numpy(imgs).to(cuda, dtype)
    before = k2.launches
    got_h, got_v = k2.separator_morphology(x, *kernels)
    assert k2.launches == before + 1
    want_h, want_v = k2.separator_morphology_plain(x, *kernels)
    assert torch.equal(got_v, want_v) and torch.equal(got_h, want_h)
    # a batch element that starts off a 16-byte boundary (odd H * W)
    got_h1, got_v1 = k2.separator_morphology(x[1:], *kernels)
    assert torch.equal(got_v1, want_v[1:]) and torch.equal(got_h1, want_h[1:])


# the heading stage's forward: pages of height 900 padded to 960 x 640, in
# groups of 4 and, for a last group, fewer. Tile edges at W = 640 and
# H = 960 / 480 / ... / 60.
_K1_HEADING_CASES = [
    ((8, 8), (4, 960, 640)), ((16, 8), (4, 960, 640)), ((16, 16), (4, 480, 320)),
    ((32, 16), (4, 480, 320)), ((32, 32), (4, 240, 160)), ((64, 32), (4, 240, 160)),
    ((32, 32), (4, 120, 80)), ((64, 32), (4, 60, 40)), ((8, 8), (3, 960, 640)),
    ((16, 32), (1, 240, 160)), ((8, 16), (2, 480, 320))]


@pytest.mark.cuda
@pytest.mark.parametrize("pair,bhw", _K1_HEADING_CASES)
def test_conv3x3_kernel_matches_plain_at_heading_shapes(cuda, pair, bhw):
    cin, cout = pair
    x, w3, bias = _k1_inputs(bhw + (cin, cout), seed=cin + cout)
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    wt = _to_oihw(w3).to(cuda, torch.bfloat16)
    bt = torch.from_numpy(bias).to(cuda, torch.bfloat16)
    got = k1.conv3x3(xt, wt, bt, relu=True)
    want = k1.conv3x3_plain(xt, wt, bt, relu=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


def _grey_pages(n, h, w, seed):
    """Light noisy paper with dark strokes of several widths."""
    rng = np.random.RandomState(seed)
    pages = rng.randint(170, 256, (n, h, w)).astype(np.uint8)
    for i in range(n):
        for _ in range(h * w // 1500):
            y, x = rng.randint(0, h - 30), rng.randint(0, w - 40)
            pages[i, y:y + rng.randint(2, 26), x:x + rng.randint(2, 36)] = rng.randint(0, 90)
    return pages


@pytest.mark.cuda
@pytest.mark.parametrize("hw,cap", [((240, 320), 255.0), ((333, 517), 255.0),
                                    ((240, 320), 0.0), ((700, 500), 6.0)])
def test_otsu_and_edt_on_the_card_equal_the_cpu(cuda, hw, cap):
    """The heading chain's plain-PyTorch device ops give on the card what
    they give on the CPU: Otsu threshold and binary equal, EDT bit for bit."""
    from citlab_as_tpu_torch.ops.binarize import otsu_binarize
    from citlab_as_tpu_torch.ops.distance_transform import distance_transform_edt
    pages = torch.from_numpy(_grey_pages(3, *hw, seed=hw[0]))
    inv = 255.0 - pages.to(torch.float32)
    t_cpu, b_cpu = otsu_binarize(inv)
    t_gpu, b_gpu = otsu_binarize(inv.to(cuda))
    assert torch.equal(t_gpu.cpu(), t_cpu) and torch.equal(b_gpu.cpu(), b_cpu)
    d_cpu = distance_transform_edt(b_cpu, cap=cap)
    d_gpu = distance_transform_edt(b_gpu, cap=cap)
    assert torch.equal(d_gpu.cpu(), d_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [64, 7, 3])
def test_line_feature_program_on_the_card_equals_the_cpu(cuda, monkeypatch, chunk):
    """``DeviceLineFeatures`` on the card against the port's CPU device on
    the same distance transform, probability map and boxes: the packed
    [n_lines, 3] integers are equal, in one chunk of crops and in several."""
    from citlab_as_tpu_torch.ops.binarize import otsu_binarize
    from citlab_as_tpu_torch.ops.distance_transform import distance_transform_edt
    from citlab_as_tpu_torch.ops import swt_device
    from citlab_as_tpu_torch.ops.swt_device import DeviceLineFeatures
    monkeypatch.setattr(swt_device, "_STATS_CHUNK", chunk)
    rng = np.random.RandomState(chunk)
    pages = torch.from_numpy(_grey_pages(2, 300, 420, seed=9))
    _, binary = otsu_binarize(255.0 - pages.to(torch.float32))
    dt = distance_transform_edt(binary, cap=255.0).to(torch.uint8)
    prob = torch.from_numpy(rng.randint(0, 256, (2, 200, 280)).astype(np.uint8))
    swt_list, net_list = [], []
    for n in (23, 9):
        x, y = rng.randint(0, 380, n), rng.randint(0, 280, n)
        boxes = np.stack([x, y, rng.randint(5, 200, n), rng.randint(3, 60, n)], 1).astype(np.int32)
        boxes[1] = -1                                    # a line without Coords
        swt_list.append(boxes)
        net_list.append(np.where(boxes < 0, -1, (boxes * 0.66).astype(np.int32)))
    want = DeviceLineFeatures().dispatch_batch(dt, prob, swt_list, net_list)()
    got = DeviceLineFeatures().dispatch_batch(
        dt.to(cuda), prob.to(cuda), swt_list, net_list)()
    for (g_net, g_sw), (w_net, w_sw) in zip(got, want):
        np.testing.assert_array_equal(g_sw, w_sw)
        np.testing.assert_array_equal(g_net, w_net)
    assert max(w_sw[:, 0].max() for _, w_sw in want) > 0


def _delaunay_graph(rng, n):
    """A page graph of n region centres with Delaunay edges (the feature
    stage's interaction) and random 15 + 2 features."""
    from scipy.spatial import Delaunay
    pts = rng.rand(n, 2) * 1000.0
    indptr, indices = Delaunay(pts).vertex_neighbor_vertices
    edges = np.array([(v, u) for v in range(n) for u in indices[indptr[v]:indptr[v + 1]]])
    return {"num_nodes": n,
            "node_features": rng.rand(n, 15).astype(np.float32).tolist(),
            "interacting_nodes": edges.tolist(),
            "edge_features": rng.randint(0, 2, (len(edges), 2)).astype(float).tolist()}


@pytest.mark.cuda
def test_relation_gnn_on_the_card_equals_the_cpu(cuda):
    """``RelationPredictor`` with the converted ``gnn`` weights: the card's
    confidences within 1e-5 of the CPU's on a group of 4 pages (segment sums
    by float atomics on the card, so not bit for bit)."""
    import os
    from citlab_as_tpu_torch.inference import RelationPredictor
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models_ckpt_torch", "gnn.npz")
    rng = np.random.RandomState(3)
    group = [_delaunay_graph(rng, n) for n in (12, 40, 64, 7)]
    want = RelationPredictor(npz, device="cpu").confidences_batch(group)
    got = RelationPredictor(npz, device="cuda").confidences_batch(group)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_host_geometry_library_builds_on_the_card_machine(cuda):
    """The host C++ library builds with the machine's compiler and agrees
    with its numpy plain versions there."""
    from citlab_as_tpu_torch.geometry import native
    from citlab_as_tpu_torch.geometry.pairwise import min_perpendicular_distances
    from citlab_as_tpu_torch.geometry.polygon import Polygon, norm_poly_dists
    from citlab_as_tpu_torch.geometry.util import alpha_shape, alpha_shape_plain
    rng = np.random.RandomState(0)
    polys = [Polygon.from_arrays(np.sort(rng.randint(0, 400, 3)) + 500 * (i % 2),
                                 100 + 40 * (i // 2) + rng.randint(-3, 4, 3))
             for i in range(30)]
    normed = norm_poly_dists(polys, 5)
    np.testing.assert_allclose(native.interline_distances_normed(normed, 5, 500),
                               min_perpendicular_distances(normed, 5, 500),
                               rtol=0, atol=1e-9)
    coords, off = native.norm_poly_dists_packed(polys, 50)
    cloud = np.concatenate([coords, coords + [1, -30]]).astype(np.int64)
    assert alpha_shape(cloud, 75) == alpha_shape_plain(
        cloud, 75, simplices=native.delaunay(cloud))


@pytest.mark.cuda
def test_async_copies_on_the_card(cuda):
    """``upload`` through pinned staging and ``prefetch`` into pinned memory
    on a side stream: the values arrive, and the copy's event is the only
    thing waited on."""
    from citlab_as_tpu_torch.utils.async_copy import HostCopy, prefetch, upload
    rng = np.random.RandomState(4)
    pages = [rng.randint(0, 256, (37, 53)).astype(np.uint8) for _ in range(3)]
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        batch = upload(pages, cuda)
        copy = prefetch(batch.to(torch.int32) * 3)
    assert isinstance(copy, HostCopy) and copy.host.is_pinned()
    assert np.array_equal(copy.numpy(), np.stack(pages).astype(np.int32) * 3)
    assert copy.event.query()


@pytest.mark.cuda
def test_visual_relation_gnn_on_the_card_equals_the_cpu(cuda):
    """The converted ``gnn_visual`` net (ARU_cutted backbone, page images at
    288 / 384): the card's confidences within 1e-4 of the CPU's (f32 convs
    summed in another order on cuDNN, segment sums by float atomics), and
    no K1 launch from the backbone."""
    import os
    from citlab_as_tpu_torch.inference import RelationPredictor
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models_ckpt_torch", "gnn_visual.npz")
    kw = dict(image_input=True, visual_backbone="ARU_cutted_v1",
              image_min_dimension=288, image_max_dimension=384)
    rng = np.random.RandomState(5)
    group = []
    for n in (12, 30, 7):
        g = _delaunay_graph(rng, n)
        xy = rng.rand(n, 2) * [1200.0, 1800.0]
        g["visual_regions_nodes"] = [[[x, x + 150, x + 150, x], [y, y, y + 90, y + 90]]
                                     for x, y in xy]
        g["num_points_visual_regions_nodes"] = [4] * n
        group.append(g)
    images = [rng.randint(0, 256, (2000, 1420)).astype(np.uint8) for _ in group]
    want = RelationPredictor(npz, device="cpu", **kw).confidences_batch(group, images)
    k1.launches = 0
    got = RelationPredictor(npz, device="cuda", **kw).confidences_batch(group, images)
    assert k1.launches == 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- training

_TRAIN_GP = {"graph": "ARU", "featRoot": 8, "scale_space_num": 3, "res_depth": 1,
             "num_scales_att": 2}


def _seg_batch(device, seed=0, b=2, hw=64):
    rng = np.random.RandomState(seed)
    return {"image": torch.tensor(rng.rand(b, hw, hw, 1).astype(np.float32), device=device),
            "label": torch.tensor(rng.randint(0, 2, (b, hw, hw)).astype(np.int32),
                                  device=device),
            "mask": torch.tensor((rng.rand(b, hw, hw) > 0.1).astype(np.float32),
                                 device=device)}


@pytest.mark.cuda
def test_segmentation_train_steps_on_the_card_equal_the_cpu(cuda):
    """A tiny ARU-Net (featRoot 8, so its 3x3 convs from 8 channels go
    through K1 under autograd) in f32 with TF32 off: the first step's loss
    and every gradient on the card within 1e-4 of the CPU's (K1's forward
    and cuDNN's backward against the plain convs; sums in another order),
    the losses of three Adam steps within 1e-4 relative, and K1 launched
    for every routed conv of each forward."""
    from citlab_as_tpu_torch.train.optimizer import build_optimizer
    from citlab_as_tpu_torch.train.segmentation import create_model, make_train_step
    runs = {}
    for dev in ("cpu", "cuda"):
        model = create_model(2, _TRAIN_GP, torch.float32).init_random(0).to(dev)
        params = dict(model.named_parameters())
        opt = build_optimizer({"optimizer": "adam", "learning_rate": 1e-3}, 4, 10)
        state, step = opt.init(params), make_train_step(model, opt)
        k1.launches = 0
        losses, grads = [], None
        for i in range(3):
            losses.append(float(step(params, state, _seg_batch(dev, seed=i))))
            if i == 0:
                grads = {k: p.grad.cpu().numpy() for k, p in params.items()}
        runs[dev] = (losses, grads, k1.launches)
    (lc, gc, _), (lg, gg, launches) = runs["cpu"], runs["cuda"]
    assert launches > 0 and launches % 3 == 0
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for k in gc:
        scale = max(float(np.abs(gc[k]).max()), 1e-30)
        assert float(np.abs(gg[k] - gc[k]).max()) / scale <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("name,accum", [("adam", 1), ("nadam", 1), ("rmsprop", 1),
                                        ("sgd", 1), ("adam", 3)])
def test_optimizers_on_cuda_tensors_equal_the_cpu(cuda, name, accum):
    """The port's optax update rules on CUDA tensors: 6 updates of random
    gradients within 1e-6 of the same on the CPU, relative to each
    parameter's scale."""
    from citlab_as_tpu_torch.train.optimizer import build_optimizer
    rng = np.random.RandomState(0)
    init = {"w": rng.randn(64, 33).astype(np.float32), "b": rng.randn(33).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, v in init.items()} for _ in range(6)]
    out = {}
    for dev in ("cpu", "cuda"):
        opt = build_optimizer({"optimizer": name, "learning_rate": 0.01}, 2, 10,
                              schedule_kind="decay", grad_accum_steps=accum)
        params = {k: torch.tensor(v, device=dev) for k, v in init.items()}
        state = opt.init(params)
        for g in grads:
            opt.step(params, {k: torch.tensor(v, device=dev) for k, v in g.items()}, state)
        out[dev] = {k: v.cpu().numpy() for k, v in params.items()}
    for k in init:
        scale = float(np.abs(out["cpu"][k]).max())
        assert float(np.abs(out["cuda"][k] - out["cpu"][k]).max()) / scale <= 1e-6, k


@pytest.mark.cuda
def test_relation_gnn_train_step_on_the_card_equals_the_cpu(cuda):
    """One relation-GNN train step (the converted ``gnn`` weights, max
    aggregation not needed: the checkpoint's sum) on a batch of 4 Delaunay
    page graphs with sampled relations: loss with weight decay and every
    gradient within 1e-5 of the CPU's (segment sums by float atomics on the
    card)."""
    import os
    from citlab_as_tpu_torch.models.gnn.graph import (
        correct_edges, pad_graph, sample_relations)
    from citlab_as_tpu_torch.models.gnn.loss import relation_loss
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.train.input_pipeline import InputGNN, torch_batch
    from citlab_as_tpu_torch.weights import gnn_state_dict_from_flax, load_npz
    import random
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "models_ckpt_torch", "gnn.npz")
    rng, py = np.random.RandomState(1), random.Random(1)
    examples = []
    for n in (20, 33, 41, 12):
        g = _delaunay_graph(rng, n)
        gt = np.array([[1, i, j] for i in range(n) for j in range(n) if i % 3 == j % 3],
                      np.int32)
        edges, ef = correct_edges(np.asarray(g["interacting_nodes"], np.int32),
                                  np.asarray(g["edge_features"], np.float32), n)
        rels, _, rel_gt = sample_relations(n, gt, 300, 2, 2, py)
        examples.append(pad_graph(n, np.asarray(g["node_features"], np.float32), edges, ef,
                                  rels, rel_gt, 64, 256, 300))
    batch_np = InputGNN._stack_to_common_shape(examples)
    out = {}
    for dev in ("cpu", "cuda"):
        model = GraphRelation(15, 2).to(dev)
        model.load_state_dict(gnn_state_dict_from_flax(load_npz(npz)))
        batch = torch_batch(batch_np, dev)
        params = dict(model.named_parameters())
        loss = relation_loss(model(batch, train=True), batch["relations_to_consider_gt"],
                             batch["num_relations_to_consider"], params=params,
                             weight_decay=1e-4)
        loss.backward()
        out[dev] = (float(loss.detach()), {k: p.grad.cpu().numpy() for k, p in params.items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, want in out["cpu"][1].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(out["cuda"][1][k] - want).max()) / scale <= 1e-5, k


@pytest.mark.cuda
def test_k1_weight_cache_does_not_grow_over_train_steps(cuda):
    """bf16 compute with float32 weights casts every weight once per
    forward, so K1 packs each cast once; the packed copies die with the
    casts (weakref eviction), and six train steps leave the cache as one
    step does."""
    import gc
    from citlab_as_tpu_torch.models.arunet import _Conv
    from citlab_as_tpu_torch.train.optimizer import build_optimizer
    from citlab_as_tpu_torch.train.segmentation import create_model, make_train_step
    model = create_model(2, _TRAIN_GP, torch.bfloat16).init_random(0).to("cuda")
    n_k1 = sum(1 for m in model.modules() if isinstance(m, _Conv) and m.use_k1)
    params = dict(model.named_parameters())
    opt = build_optimizer(None, 4, 10)
    state, step = opt.init(params), make_train_step(model, opt)
    gc.collect()
    before = len(k1._packed)
    sizes = []
    for i in range(6):
        step(params, state, _seg_batch("cuda", seed=i))
        gc.collect()
        sizes.append(len(k1._packed))
    assert n_k1 > 0 and max(sizes) - before <= n_k1
    assert sizes[-1] == sizes[0]


@pytest.mark.cuda
def test_synthetic_pages_on_the_card_equal_the_cpu(cuda):
    """The synthetic page composition on the card, fed the same draws as
    on the CPU, gives the same pages bit for bit (its float64 sums and
    products are exact); the draws come from the card's own generator."""
    from citlab_as_tpu_torch.train import synthetic_data
    draws = synthetic_data.page_draws(torch.Generator().manual_seed(3), 2, 200, 150)
    for heading_mode in (False, True):
        want = synthetic_data.compose_pages(draws, 200, 150, heading_mode)
        got = synthetic_data.compose_pages({k: v.cuda() for k, v in draws.items()},
                                           200, 150, heading_mode)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    gen = torch.Generator(device="cuda").manual_seed(0)
    img, lab = synthetic_data.synthetic_batch(gen, 3, 128, 96, device="cuda")
    again, _ = synthetic_data.synthetic_batch(torch.Generator(device="cuda").manual_seed(0),
                                              3, 128, 96, device="cuda")
    assert img.shape == (3, 128, 96, 1) and lab.shape == (3, 128, 96)
    assert torch.equal(img, again) and set(lab.unique().tolist()) <= {0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [(3, 3), (5, 3), (1, 7)])
def test_dilation_on_the_card_equals_the_cpu(cuda, kernel):
    from citlab_as_tpu_torch.stages.ground_truth import apply_dilation
    img = (np.random.RandomState(sum(kernel)).rand(301, 217) < 0.02).astype(np.uint8) * 255
    got = apply_dilation(img, kernel, device=cuda)
    want = apply_dilation(img, kernel, device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, want) and got.sum() > img.sum()


@pytest.mark.cuda
def test_binarization_on_the_card_equals_the_cpu(cuda):
    import chip_smoke
    from citlab_as_tpu_torch.ops.image_utils import get_binarization
    pages, _ = chip_smoke.synthetic_pages(2, 700, 500, seed=4)
    for page in pages:
        got = get_binarization(page, device=cuda)
        want = get_binarization(page, device="cpu")
        assert np.array_equal(got, want) and 0 < got.mean() < 1


@pytest.mark.cuda
def test_gt_generators_on_the_card_equal_the_cpu(cuda, tmp_path):
    """The AS generator's channels (Otsu and dilation on the device) equal
    the CPU device's."""
    import chip_smoke
    from citlab_as_tpu_torch.stages.ground_truth import generate_as_ground_truth
    from citlab_as_tpu_torch.utils.io import get_page_path
    pages, _, layouts = chip_smoke.synthetic_newspaper(1, 800, 560, seed=2)
    paths = chip_smoke.write_corpus(str(tmp_path), pages, layouts)
    got = generate_as_ground_truth(get_page_path(paths[0]), device=cuda)
    want = generate_as_ground_truth(get_page_path(paths[0]), device="cpu")
    assert list(got) == list(want) == ["article", "baseline", "other"]
    for name in want:
        assert np.array_equal(got[name], want[name]), name


@pytest.mark.cuda
def test_inception_on_the_card_equals_the_cpu(cuda):
    """Inception v3 at 1 x 299 x 299 x 1 (f32, TF32 off), seeded weights
    and batch statistics: every end point within 1e-4 of the output's scale;
    no K1 launch (its convs are F.conv2d)."""
    from citlab_as_tpu_torch.models.inception_v3 import InceptionV3
    model = InceptionV3().init_random(3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + 0.75)
    x = torch.rand(1, 299, 299, 1, generator=gen)
    with torch.no_grad():
        _, want = model(x)
        k1.launches = 0
        _, got = model.to(cuda)(x.to(cuda))
    assert k1.launches == 0
    for name, w in want.items():
        scale = float(w.abs().max())
        assert float((got[name].cpu() - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.cuda
def test_frozen_arunet_forward_equals_npz_on_the_card(cuda, tmp_path):
    """The committed separator net exported to a bf16 ``.frozen``: its
    forward on the card equals the ``.npz`` predictor's bit for bit, with 69
    K1 launches each."""
    import os
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.train.export import export_checkpoint_frozen
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    npz = os.path.join(repo, "models_ckpt_torch", "separator.npz")
    frozen = export_checkpoint_frozen(npz, str(tmp_path / "separator.frozen"), "arunet",
                                      model_kwargs={"dtype": "bfloat16"})
    image = _synthetic(256, 320) / 255.0
    outs = []
    for path in (npz, frozen):
        pred = SegmentationPredictor(path, device=cuda)
        k1.launches = 0
        outs.append(pred(image))
        assert k1.launches == 69
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.cuda
def test_text_block_post_processor_on_the_card_equals_the_cpu(cuda):
    from citlab_as_tpu_torch.stages.textblock_postprocess import TextBlockNetPostProcessor
    rng = np.random.RandomState(5)
    prob = rng.rand(400, 300).astype(np.float32) * 0.04
    for _ in range(30):
        y, x = rng.randint(0, 380), rng.randint(0, 280)
        prob[y:y + rng.randint(3, 20), x:x + rng.randint(3, 20)] = rng.uniform(0.05, 1)
    net_output = np.stack([prob, 1 - prob], axis=-1)
    card, cpu = TextBlockNetPostProcessor(device=cuda), TextBlockNetPostProcessor(device="cpu")
    got, want = card.post_process(net_output), cpu.post_process(net_output)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    assert card.to_polygons(got) == cpu.to_polygons(want)


@pytest.fixture
def two_gpus(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_launch_on_their_tensors_gpu(two_gpus, dtype):
    """K1 and K2 on tensors of the second GPU while the first is current:
    each wrapper launches on its tensor's device (its grid sized for that
    device) and equals its plain version there."""
    first, second = two_gpus
    x, w3, bias = _k1_inputs((2, 45, 70, 16, 32), seed=3)
    xt = torch.from_numpy(x).to(second, dtype)
    wt = _to_oihw(w3).to(second, dtype)
    bt = torch.from_numpy(bias).to(second, dtype)
    imgs = torch.from_numpy(np.stack([_synthetic(seed=s) for s in (0, 1)])).to(
        second, torch.uint8)
    with torch.cuda.device(first):
        before = k1.launches, k2.launches
        got = k1.conv3x3(xt, wt, bt, relu=True)
        got_h, got_v = k2.separator_morphology(imgs, 15, 30, 10)
        assert torch.cuda.current_device() == first.index
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)
    assert got.device == second and got_h.device == second
    torch.cuda.synchronize(second)
    want = k1.conv3x3_plain(xt, wt, bt, relu=True)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2 * scale), err
    want_h, want_v = k2.separator_morphology_plain(imgs, 15, 30, 10)
    assert torch.equal(got_h, want_h) and torch.equal(got_v, want_v)


def _sharded_against_single(mesh, device):
    """A sharded predictor over ``mesh`` against the unsharded one on
    ``device``: every page equal bit for bit at the same per-shard batch
    and padded shape, 69 K1 launches per shard forward."""
    import os
    from citlab_as_tpu_torch.inference import (
        SegmentationPredictor, ShardedSegmentationPredictor)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    npz = os.path.join(repo, "models_ckpt_torch", "separator.npz")
    single = SegmentationPredictor(npz, device=device)
    sharded = ShardedSegmentationPredictor(npz, mesh=mesh)
    n = sharded.n_data
    images = [_synthetic(256, 320, seed=s) / 255.0 for s in range(2 * n)]
    k1.launches = 0
    got = sharded.predict_batch(images)
    assert k1.launches == 69 * n
    for i in range(n):
        for a, b in zip(got[2 * i:2 * i + 2], single.predict_batch(images[2 * i:2 * i + 2])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_sharded_predictor_over_two_shards_of_one_gpu(cuda):
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    _sharded_against_single(make_mesh([cuda, cuda]), cuda)


@pytest.mark.cuda
def test_sharded_predictor_over_every_gpu(two_gpus):
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    _sharded_against_single(make_mesh(), two_gpus[0])


@pytest.mark.cuda
def test_sharded_train_step_over_every_gpu(two_gpus):
    """The segmentation train step data-parallel over a mesh of every card
    (a tiny ARU-Net whose 3x3 convs from 8 channels run K1 under autograd,
    f32 with TF32 off, a validity mask and class weights): the gradients are
    summed on the first card and copied to the others, so after each of 3
    steps every replica's parameters and Adam slots are bit-equal to the
    first card's, and each loss, a 0-d tensor on the first card, is the
    one-card step's on the whole batch from the same start within 1e-5
    relative."""
    from citlab_as_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from citlab_as_tpu_torch.train.optimizer import build_optimizer
    from citlab_as_tpu_torch.train.segmentation import (
        create_model, make_sharded_train_step, make_train_step)
    first = two_gpus[0]
    mesh = make_mesh()
    n = mesh.shape["data"]
    model = create_model(2, _TRAIN_GP, torch.float32).init_random(0).to(first)
    opt = build_optimizer({"optimizer": "adam", "learning_rate": 1e-3}, 4, 10)
    replicas = replicate(mesh, model)
    params = [dict(r.named_parameters()) for r in replicas]
    states = [opt.init(p) for p in params]
    step = make_sharded_train_step(replicas, opt, mesh, class_weights=(4.0, 1.0))
    single_params = dict(model.named_parameters())
    single_state = opt.init(single_params)
    single = make_train_step(model, opt, class_weights=(4.0, 1.0))
    for i in range(3):
        with torch.no_grad():
            for k, p in single_params.items():
                p.copy_(params[0][k])
            for slot in ("mu", "nu"):
                for k, t in single_state[slot].items():
                    t.copy_(states[0][slot][k])
        k1.launches = 0
        batch = _seg_batch("cpu", seed=i, b=2 * n)
        loss = step(params, states, shard_batch(mesh, batch))
        assert k1.launches > 0 and k1.launches % n == 0
        want = single(single_params, single_state, {k: v.to(first) for k, v in batch.items()})
        assert loss.dim() == 0 and loss.device == first
        assert float(loss) == pytest.approx(float(want), rel=1e-5)
        for r in range(1, n):
            assert all(p.device == mesh.data_devices[r] for p in params[r].values())
            for k in params[0]:
                assert torch.equal(params[r][k].cpu(), params[0][k].cpu()), k
                for slot in ("mu", "nu"):
                    assert torch.equal(states[r][slot][k].cpu(), states[0][slot][k].cpu()), k
            assert states[r]["count"] == states[0]["count"] == i + 1


def _spatial_net(net, devices):
    """``net`` height-sharded over a (1, len(devices)) mesh."""
    from citlab_as_tpu_torch.parallel.mesh import make_mesh, replicate
    from citlab_as_tpu_torch.parallel.spatial import SpatialARU
    mesh = make_mesh(devices, data=1, model=len(devices))
    return SpatialARU(replicate(mesh, net, over_model=True)[0], mesh.model_devices(0))


def _separator_net(device, dtype):
    import os
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return SegmentationPredictor(os.path.join(repo, "models_ckpt_torch", "separator.npz"),
                                 dtype=dtype, device=device).model


def _page_batch(h=700, w=320):
    return torch.from_numpy(np.stack([_synthetic(h, w, seed=s) / 255.0
                                      for s in (0, 1)]).astype(np.float32))[..., None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_forward_on_the_card_equals_its_cpu_run(cuda, dtype):
    """The separator net height-sharded over 3 row shards of the card
    (256 / 192 / 252 rows) against the same sharded forward on the CPU:
    f32 (TF32 off) within 1e-4 of the logits' scale; bf16 within 2e-2 of
    the card's unsharded forward. Every 3 x 3 conv of every shard is a K1
    launch: 69 per shard."""
    x = _page_batch()
    net = _separator_net(cuda, dtype)
    with torch.no_grad():
        k1.launches = 0
        got = _spatial_net(net, [cuda] * 3)(x.to(cuda))
        torch.cuda.synchronize()
        assert k1.launches == 69 * 3
        if dtype == torch.float32:
            want = _spatial_net(_separator_net("cpu", dtype), [torch.device("cpu")] * 3)(x)
        else:
            want = net(x.to(cuda)).cpu()
    scale = want.abs().max().item()
    err = (got.cpu() - want).abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2) * scale, err


@pytest.mark.cuda
def test_spatial_forward_over_two_gpus(two_gpus):
    """Row shards on two cards, each with its own replica: the halo rows
    cross between them, the logits land on the first card, f32 within 1e-5
    of the logits' scale of the unsharded forward there, 69 K1 launches on
    each card; and the predictor over a (data=1, model=2) mesh."""
    from citlab_as_tpu_torch.inference import SegmentationPredictor, ShardedSegmentationPredictor
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    first, second = two_gpus
    x = _page_batch().to(first)
    net = _separator_net(first, torch.float32)
    with torch.no_grad():
        k1.launches = 0
        got = _spatial_net(net, [first, second])(x)
        torch.cuda.synchronize(first)
        torch.cuda.synchronize(second)
        assert k1.launches == 69 * 2 and got.device == first
        want = net(x)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    single = SegmentationPredictor.view(net, first)
    sharded = ShardedSegmentationPredictor.from_predictor(
        single, make_mesh([first, second], data=1, model=2))
    images = [_synthetic(700, 320, seed=s) / 255.0 for s in (0, 1)]
    for a, b in zip(sharded.predict_batch(images), single.predict_batch(images)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", ["rect", "ellipse", "cross"])
def test_apply_transform_on_the_card_equals_the_cpu(cuda, kernel_type):
    from citlab_as_tpu_torch.ops.image_utils import apply_transform
    img = (255 - _synthetic(200, 260)).astype(np.uint8)
    for transform in ("erosion", "dilation", "opening", "closing", "gradient", "tophat",
                      "blackhat"):
        np.testing.assert_array_equal(
            apply_transform(img, transform, (5, 3), kernel_type, 2, device=cuda),
            apply_transform(img, transform, (5, 3), kernel_type, 2, device="cpu"))


@pytest.mark.cuda
def test_jpeg_variant_pages_through_the_separator_on_the_card(cuda, tmp_path):
    """The committed full-size JPEG variant pages (CMYK, YCCK,
    arithmetic-coded progressive, lossless grey, block-smoothed
    progressive; ``tests/data/torch_formats_jpeg``) decode on the card's
    machine to their recorded "L" digests, and the separator stage on the
    card writes for each the PAGE-XML it writes for the page's PNG twin,
    with K1 69 and K2 one launch per group of 4."""
    import hashlib
    import json
    import os
    import re
    import shutil
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    from citlab_as_tpu_torch.utils import io as tio
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "tests", "data", "torch_formats_jpeg")
    os.makedirs(tmp_path / "page")
    images = []
    for name in sorted(os.listdir(src)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(src, name)) as f:
            rec = json.load(f)
        stem = os.path.splitext(rec["file"])[0]
        path, twin = str(tmp_path / rec["file"]), str(tmp_path / f"twin_{stem}.png")
        shutil.copy(os.path.join(src, rec["file"]), path)
        grey = tio.load_image(path, "L")
        assert hashlib.sha256(np.ascontiguousarray(grey).tobytes()).hexdigest() == \
            rec["sha256_L"]
        tio.save_png(twin, grey)
        for s in (stem, f"twin_{stem}"):
            shutil.copy(os.path.join(src, "page", f"{stem}.xml"), tmp_path / "page" / f"{s}.xml")
        images += [path, twin]
    assert len(images) == 10
    pred = SegmentationPredictor(os.path.join(repo, "models_ckpt_torch", "separator.npz"),
                                 dtype=torch.bfloat16, device=cuda)
    tio._IMAGE_CACHE.clear()
    k1.launches = 0
    k2.launches = 0
    SeparatorNetPostProcessor(images, pred, fixed_height=1500).run_batched_fused(4)
    assert (k1.launches, k2.launches) == (69 * 3, 3)

    def written(image):
        with open(tio.get_page_path(image) + ".xml", "rb") as f:
            data = re.sub(rb"<LastChange>[^<]*</LastChange>", b"", f.read())
        return re.sub(rb'imageFilename="[^"]*"', b"", data)
    for path, twin in zip(images[::2], images[1::2]):
        assert b"SeparatorRegion" in written(path) and written(path) == written(twin), path


@pytest.mark.cuda
def _pages_through_the_separator(cuda, tmp_path, folder):
    """The committed full-size pages of ``tests/data/<folder>`` decode on the
    card's machine to their recorded "L" and "RGB" digests (PIL's), and the
    separator stage on the card writes for each the PAGE-XML it writes for
    the page's PNG twin, with K1 69 and K2 one launch per group of 4."""
    import hashlib
    import json
    import os
    import re
    import shutil
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    from citlab_as_tpu_torch.utils import io as tio
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, "tests", "data", folder)
    os.makedirs(tmp_path / "page")
    images = []
    for name in sorted(os.listdir(src)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(src, name)) as f:
            rec = json.load(f)
        stem = os.path.splitext(rec["file"])[0]
        path, twin = str(tmp_path / rec["file"]), str(tmp_path / f"twin_{stem}.png")
        shutil.copy(os.path.join(src, rec["file"]), path)
        for mode in ("L", "RGB"):
            tio._IMAGE_CACHE.clear()
            assert hashlib.sha256(np.ascontiguousarray(tio.load_image(path, mode)).tobytes()
                                  ).hexdigest() == rec[f"sha256_{mode}"], (path, mode)
        tio.save_png(twin, tio.load_image(path, "L"))
        for s in (stem, f"twin_{stem}"):
            shutil.copy(os.path.join(src, "page", f"{stem}.xml"), tmp_path / "page" / f"{s}.xml")
        images += [path, twin]
    assert len(images) == 6
    pred = SegmentationPredictor(os.path.join(repo, "models_ckpt_torch", "separator.npz"),
                                 dtype=torch.bfloat16, device=cuda)
    tio._IMAGE_CACHE.clear()
    k1.launches = 0
    k2.launches = 0
    SeparatorNetPostProcessor(images, pred, fixed_height=1500).run_batched_fused(4)
    assert (k1.launches, k2.launches) == (69 * 2, 2)

    def written(image):
        with open(tio.get_page_path(image) + ".xml", "rb") as f:
            data = re.sub(rb"<LastChange>[^<]*</LastChange>", b"", f.read())
        return re.sub(rb'imageFilename="[^"]*"', b"", data)
    for path, twin in zip(images[::2], images[1::2]):
        assert b"SeparatorRegion" in written(path) and written(path) == written(twin), path


def test_webp_pages_through_the_separator_on_the_card(cuda, tmp_path):
    """The committed full-size WebP pages (lossy with the normal loop filter,
    4 partitions and 4 segments; lossless; lossy with a filtered
    VP8L-compressed alpha plane; ``tests/data/torch_formats_webp``) through
    the separator stage on the card beside their PNG twins."""
    _pages_through_the_separator(cuda, tmp_path, "torch_formats_webp")


def test_jpeg2000_pages_through_the_separator_on_the_card(cuda, tmp_path):
    """The committed full-size JPEG 2000 pages (lossy 9/7 at rate 8 in RPCL
    order with 512 x 512 tiles and PLT; lossless 5/3; lossy colour with the
    ICT; ``tests/data/torch_formats_jpeg2000``) through the separator stage
    on the card beside their PNG twins."""
    _pages_through_the_separator(cuda, tmp_path, "torch_formats_jpeg2000")
