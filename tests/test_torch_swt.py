"""The heading stage's device ops, port against JAX package, on the CPU with
the same numpy inputs made from a seed: Gaussian blur, Otsu, the jump-flood
EDT, the per-crop component statistics, the per-line statistics, the net
sums and ``DeviceLineFeatures``. Every comparison is exact (integers, or
float32 values that both sides compute in the same order); the one float64
quantity, the mean net probability, is the same division on both sides and
is compared exactly too."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from citlab_as_tpu.ops import binarize as jbin
from citlab_as_tpu.ops import distance_transform as jdt
from citlab_as_tpu.ops import swt as jswt
from citlab_as_tpu.ops import swt_device as jsd
from citlab_as_tpu_torch.ops import binarize as tbin
from citlab_as_tpu_torch.ops import distance_transform as tdt
from citlab_as_tpu_torch.ops import swt as tswt
from citlab_as_tpu_torch.ops import swt_device as tsd

from tests.test_swt_device import _random_boxes, _random_dt

H, W = 240, 320


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The fixpoints run thousands of small tensor ops: one thread per
    worker is faster than every worker's pool fighting for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _page(seed, h=H, w=W):
    """A grey page: light paper with noise, dark strokes of several widths."""
    rng = np.random.RandomState(seed)
    img = rng.randint(170, 256, (h, w)).astype(np.uint8)
    for _ in range(60):
        y, x = rng.randint(0, h - 30), rng.randint(0, w - 40)
        img[y:y + rng.randint(2, 26), x:x + rng.randint(2, 36)] = rng.randint(0, 90)
    img[rng.rand(h, w) < 0.003] = 0
    return img


@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_gaussian_blur_equal(ksize):
    """Exact for the dyadic kernels (3, 5, 7); the 9-tap kernel is a rounded
    Gaussian whose sums round by the order of addition: atol 1e-4 (a few
    float32 ulps at 255)."""
    pages = np.stack([_page(0), 255 - _page(1)]).astype(np.float32)
    got = tbin.gaussian_blur(torch.from_numpy(pages), ksize).numpy()
    want = np.stack([np.asarray(jbin.gaussian_blur(jnp.asarray(p), ksize)) for p in pages])
    if ksize <= 7:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_otsu_threshold_and_binary_equal(seed):
    page = 255.0 - _page(seed).astype(np.float32)
    t_want, b_want = jbin.otsu_binarize(jnp.asarray(page), 5)
    t_got, b_got = tbin.otsu_binarize(torch.from_numpy(page)[None], 5)
    assert float(t_got[0]) == float(t_want)
    np.testing.assert_array_equal(b_got[0].numpy(), np.asarray(b_want))
    assert b_got.dtype == torch.uint8 and 0 < b_got.float().mean() < 255


def test_otsu_threshold_on_full_page_histograms():
    """Seeded random histograms with the mass of a 2000 x 1420 page: the
    class sums pass 2^24, so the threshold depends on the order of the
    float32 prefix sum. The port's host definition must give the JAX
    function's threshold on every one (the image is rebuilt from the
    histogram, so JAX sees exactly these counts)."""
    rng = np.random.RandomState(0)
    n = 2000 * 1420
    for trial in range(6):
        alpha = [0.05, 0.3, 1.0][trial % 3]
        hist = rng.multinomial(n, rng.dirichlet(np.ones(256) * alpha))
        if trial % 3 == 2:                       # two near-equal modes
            hist = np.zeros(256, np.int64)
            hist[[40, 41, 200, 201]] = [n // 4, n // 4 + trial, n // 4, n // 4 - trial]
        image = np.repeat(np.arange(256, dtype=np.float32), hist).reshape(2000, -1)
        t_want, _ = jbin.otsu_threshold(jnp.asarray(image))
        assert int(tbin.otsu_threshold_from_hist(hist)) == int(t_want), trial
    hists = rng.multinomial(n, rng.dirichlet(np.ones(256)), size=3)
    batched = tbin.otsu_threshold_from_hist(hists)
    assert [int(tbin.otsu_threshold_from_hist(h)) for h in hists] == batched.tolist()


def test_otsu_binarize_host_equal():
    page = 255.0 - _page(9).astype(np.float32)
    t_want, b_want = jbin.otsu_binarize_host(page)
    t_got, b_got = tbin.otsu_binarize_host(page)
    assert t_got == t_want
    np.testing.assert_array_equal(b_got, b_want)


@pytest.mark.parametrize("cap", [255.0, 0.0, 6.0])
def test_edt_equal_bit_for_bit(cap):
    rng = np.random.RandomState(int(cap))
    pages = []
    for i in range(3):
        _, binary = tbin.otsu_binarize_host(255.0 - _page(20 + i).astype(np.float32))
        pages.append(binary)
    pages[2] = np.where(rng.rand(H, W) < 0.5, 255, 0).astype(np.uint8)   # many ties
    pages.append(np.full((H, W), 255, np.uint8))                        # no seed at all
    pages.append(np.zeros((H, W), np.uint8))
    got = tdt.distance_transform_edt(torch.from_numpy(np.stack(pages)), cap=cap).numpy()
    want = np.stack([np.asarray(jdt.distance_transform_edt(jnp.asarray(p), cap=cap))
                     for p in pages])
    np.testing.assert_array_equal(got, want)               # float32, inf included
    if cap:
        np.testing.assert_array_equal(got.astype(np.uint8), want.astype(np.uint8))
    assert tdt.jfa_steps(2000, 1420, 255.0) == [256, 128, 64, 32, 16, 8, 4, 2, 1, 1]


def test_edt_non_square_and_tiny():
    for shape in [(1, 1), (3, 70), (70, 3), (33, 47)]:
        rng = np.random.RandomState(sum(shape))
        b = (rng.rand(*shape) < 0.7).astype(np.uint8)
        got = tdt.distance_transform_edt(torch.from_numpy(b)[None], cap=255.0)[0].numpy()
        want = np.asarray(jdt.distance_transform_edt(jnp.asarray(b), cap=255.0))
        np.testing.assert_array_equal(got, want)


def _serpentine(h=42, w=400):
    dt = np.zeros((h, w), np.int32)
    for i, y in enumerate(range(0, h, 2)):
        dt[y, :] = 1
        if y + 2 < h:
            dt[y + 1, w - 1 if i % 2 == 0 else 0] = 1
    return dt


def _crops(seed, l=5, h=40, w=96):
    rng = np.random.RandomState(seed)
    dt = _random_dt(rng, 200, 600, n_blobs=300)
    out = []
    for _ in range(l):
        y, x = rng.randint(0, 200 - h), rng.randint(0, 600 - w)
        out.append(dt[y:y + h, x:x + w])
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("stride", [0, 4])
@pytest.mark.parametrize("which", ["random", "serpentine"])
def test_component_stats_equal(which, stride):
    # ``stride`` is the JAX package's cap on its doubling distance; the port
    # has one path (exact run maxima) and reaches the same fixpoint. JAX's
    # capped doubling needs about path / (2 * stride) sweeps: a shorter
    # snake (still > 64 * stride px of path) keeps the stride case quick
    snake = _serpentine() if stride == 0 else _serpentine(22, 200)
    crops = _crops(3) if which == "random" else snake[None]
    fg = crops > 0
    want = [np.asarray(a) for a in jsd.component_stats_u16(
        jnp.asarray(crops), jnp.asarray(fg), stride=stride)]
    got = [a.numpy() for a in tsd.component_stats(
        torch.from_numpy(crops), torch.from_numpy(fg))]
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    # the int32 variant of the JAX package differs only in what it leaves
    # at background pixels
    want32 = [np.asarray(a) for a in jsd.component_stats(
        jnp.asarray(crops), jnp.asarray(fg))]
    for g, w_ in zip(got, want32):
        np.testing.assert_array_equal(g[fg], w_[fg])
    if which == "serpentine":
        assert np.unique(got[0][fg]).size == 1 and got[1][fg].max() == snake.shape[1] - 1


@pytest.mark.parametrize("which,stride", [
    ("random", 0), ("random", 4), ("serpentine", 0), ("serpentine", 4),
    ("large", 0)])         # the JAX package's int32 path takes no stride
def test_line_stats_from_crops_equal(which, stride):
    if which == "random":
        crops = _crops(4)
    elif which == "serpentine":
        crops = (_serpentine() if stride == 0 else _serpentine(22, 200))[None] * 7
        crops[0, 6:16, 100:130] = 3             # a second component under the snake's bbox
    else:
        crops = _crops(5, l=2, h=80, w=420)      # > 32768 px: JAX takes component_stats
    want = np.asarray(jsd._line_stats_from_crops(jnp.asarray(crops), 2, stride))
    got = tsd._line_stats_from_crops(torch.from_numpy(crops), 2).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[:, 0], (want[:, 0] * 2).astype(np.int32))
    np.testing.assert_array_equal(got[:, 1], want[:, 1].astype(np.int32))
    for clean in (0, 1):
        want = np.asarray(jsd._line_stats_from_crops(jnp.asarray(crops), clean, stride))
        got = tsd._line_stats_from_crops(torch.from_numpy(crops), clean).numpy()
        np.testing.assert_array_equal(got, (want * [2, 1]).astype(np.int32))


def test_stride_paths_share_one_fixpoint():
    """The JAX package's capped doubling (stride 2) and the port's exact
    run maxima end in the same fixpoint; the port counts one host sync per
    sweep."""
    crops = _crops(6)
    want = np.asarray(jsd._line_stats_from_crops(jnp.asarray(crops), 2, 2))
    tsd.reset_counts()
    got = tsd._line_stats_from_crops(torch.from_numpy(crops), 2).numpy()
    np.testing.assert_array_equal(got, (want * [2, 1]).astype(np.int32))
    assert tsd.COUNTS["sweeps"] == tsd.COUNTS["syncs"] > 2


def _maps(seed, b=2):
    rng = np.random.RandomState(seed)
    dt = np.stack([_random_dt(rng, H, W) for _ in range(b)])
    prob = rng.randint(0, 256, (b, 200, 260)).astype(np.uint8)
    return rng, dt, prob


def test_net_prob_sums_equal(monkeypatch):
    rng, _, prob = _maps(1)
    boxes = np.stack([np.asarray(_random_boxes(rng, 200, 260, 16), np.int32)
                      for _ in range(2)])
    boxes[0, 0] = (250, 190, 40, 40)     # overshoots both edges
    boxes[0, 1] = (300, 300, 5, 5)       # wholly outside
    boxes[1, 0] = (0, 0, 260, 200)       # the whole page
    boxes[1, 1] = (10, 10, 0, 0)         # empty
    want = np.asarray(jsd.net_prob_sums_batch_sat(jnp.asarray(prob), jnp.asarray(boxes)))
    got = tsd.net_prob_sums_batch_sat(torch.from_numpy(prob), torch.from_numpy(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    inside = boxes.copy()
    inside[0, 1] = (255, 195, 5, 5)
    want = np.asarray(jsd.net_prob_sums_batch(jnp.asarray(prob), jnp.asarray(inside),
                                              crop_h=256, crop_w=512))
    monkeypatch.setattr(tsd, "_STATS_CHUNK", 5)     # several chunks of boxes
    got = tsd.net_prob_sums_batch(torch.from_numpy(prob), torch.from_numpy(inside),
                                  crop_h=256, crop_w=512)
    np.testing.assert_array_equal(got.numpy(), want)


def test_line_features_batch_equal(monkeypatch):
    rng, dt, prob = _maps(2)
    sb = np.stack([np.asarray(_random_boxes(rng, H, W, 16), np.int32) for _ in range(2)])
    nb = (sb * 0.8).astype(np.int32)
    want = np.asarray(jsd.line_features_batch(
        jnp.asarray(dt), jnp.asarray(prob), jnp.asarray(sb), jnp.asarray(nb),
        crop_h=80, crop_w=128, mxu=True))
    for chunk in (64, 5, 7):       # one chunk, and chunks that cut a page's lines
        monkeypatch.setattr(tsd, "_STATS_CHUNK", chunk)
        got = tsd.line_features_batch(
            torch.from_numpy(dt), torch.from_numpy(prob), torch.from_numpy(sb),
            torch.from_numpy(nb), crop_h=80, crop_w=128)
        np.testing.assert_array_equal(got.numpy(), want)


def test_device_line_features_dispatch_batch_equal():
    """Same uint8 DT and probability maps on both sides; one page has no
    line at all and one line has no Coords (w = -1). A later group with a
    long tall line grows the port's buckets; its results are held against
    the host path (scipy label per crop) and the exact numpy sums."""
    rng, dt, prob = _maps(3, b=3)
    jfeat, tfeat = jsd.DeviceLineFeatures(), tsd.DeviceLineFeatures()

    def group(n_lines, big):
        swt_list, net_list = [], []
        for n in n_lines:
            sb = np.asarray(_random_boxes(rng, H, W, n), np.int32).reshape(n, 4)
            if big and n:
                sb[0] = (5, 5, 300, 90)
            nb = (sb * 0.8).astype(np.int32)
            if n > 2:
                sb[2] = nb[2] = -1
            swt_list.append(sb)
            net_list.append(nb)
        return swt_list, net_list

    n_lines = (5, 0, 9)
    swt_list, net_list = group(n_lines, big=False)
    want = jfeat.dispatch_batch(jnp.asarray(dt), jnp.asarray(prob),
                                swt_list, net_list)()
    got = tfeat.dispatch_batch(torch.from_numpy(dt), torch.from_numpy(prob),
                               swt_list, net_list)()
    assert len(got) == len(want) == 3
    for (gn, gs), (wn, ws), n in zip(got, want, n_lines):
        assert gn.shape == (n,) and gs.shape == (n, 2)
        assert gn.dtype == np.float64 and gs.dtype == np.float32
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gs, ws)
    assert (got[2][0][2], tuple(got[2][1][2])) == (0.0, (0.0, 0.0))   # no Coords
    assert tfeat._line_bucket == jfeat._line_bucket == 16
    assert tfeat._swt_crop == jfeat._swt_crop
    assert tfeat._net_crop == jfeat._net_crop

    swt_list, net_list = group((3, 33, 1), big=True)
    got = tfeat.dispatch_batch(torch.from_numpy(dt), torch.from_numpy(prob),
                               swt_list, net_list)()
    assert tfeat._line_bucket == 64 and tfeat._swt_crop == [96, 384]
    host = jswt.StrokeWidthDistanceTransform()
    for i, (sb, nb) in enumerate(zip(swt_list, net_list)):
        for j, (s_box, n_box) in enumerate(zip(sb, nb)):
            if s_box[2] < 0:
                continue
            sw, th = host.textline_features(dt[i], tuple(s_box))
            assert (got[i][1][j, 0], got[i][1][j, 1]) == (sw, th)
            x, y, w_, h_ = n_box
            mean = prob[i][y:y + h_, x:x + w_].sum() / (255.0 * w_ * h_) if w_ * h_ else 0.0
            assert got[i][0][j] == mean
    one = tfeat(torch.from_numpy(dt[1]), torch.from_numpy(prob[1]),
                swt_list[1], net_list[1])
    np.testing.assert_array_equal(one[1], got[1][1])
    np.testing.assert_array_equal(one[0], got[1][0])


def test_device_features_equal_host_textline_features():
    """The device program against the host path of the port itself (scipy
    label per crop), on a DT the port computed."""
    page = _page(31)
    dev_swt = tswt.StrokeWidthDistanceTransform()
    _, binary = tbin.otsu_binarize(255.0 - torch.from_numpy(page)[None].float())
    dt = tdt.distance_transform_edt(binary, cap=255.0)[0].numpy().astype(np.uint8)
    rng = np.random.RandomState(5)
    boxes = np.asarray(_random_boxes(rng, H, W, 20), np.int32)
    host = np.array([dev_swt.textline_features(dt, tuple(b)) for b in boxes])
    _, sw_th = tsd.DeviceLineFeatures()(torch.from_numpy(dt),
                                        torch.zeros(H, W, dtype=torch.uint8),
                                        boxes, boxes)
    np.testing.assert_array_equal(sw_th, host.astype(np.float32))
    assert host[:, 0].max() > 0


def test_host_swt_equal():
    page = _page(32)
    a = jswt.StrokeWidthDistanceTransform().distance_transform(page)
    b = tswt.StrokeWidthDistanceTransform().distance_transform(page)
    np.testing.assert_array_equal(a, b)
    j, t = jswt.StrokeWidthDistanceTransform(), tswt.StrokeWidthDistanceTransform()
    assert t.connected_components(b) == j.connected_components(a)
    assert (t.clean_connected_components(t.connected_components(b))
            == j.clean_connected_components(j.connected_components(a)))
    for bbox in [(10, 10, 100, 40), (200, 150, 119, 89), (0, 0, 5, 5)]:
        assert t.textline_features(b, bbox) == j.textline_features(a, bbox)
    swt2, ccs = t.apply_swt_dist_trafo(page)
    np.testing.assert_array_equal(swt2, b)


def test_per_chunk_buckets_change_nothing(monkeypatch):
    """Each chunk shrinks its crop bucket to its own largest line; one long
    tall line among short ones must not change any line's result: with the
    boxes read back or handed over, in small chunks or in one, and against
    the host path (scipy label per crop)."""
    rng, dt, _ = _maps(7)
    sb = np.stack([np.asarray(_random_boxes(rng, H, W, 16), np.int32) for _ in range(2)])
    sb[..., 2] = np.minimum(sb[..., 2], 60)
    sb[..., 3] = np.minimum(sb[..., 3], 20)
    sb[0, 3] = (2, 2, 300, 100)
    args = dict(crop_h=112, crop_w=384)
    one_chunk = tsd.swt_line_stats_batch_gather2(torch.from_numpy(dt), torch.from_numpy(sb), **args)
    monkeypatch.setattr(tsd, "_STATS_CHUNK", 5)
    fixed = tsd.swt_line_stats_batch_gather2(torch.from_numpy(dt), torch.from_numpy(sb), **args)
    trimmed = tsd.swt_line_stats_batch_gather2(torch.from_numpy(dt), torch.from_numpy(sb),
                                               boxes_host=sb, **args)
    assert torch.equal(fixed, trimmed) and torch.equal(fixed, one_chunk)
    assert int(fixed[..., 1].max()) > 0
    host = tswt.StrokeWidthDistanceTransform()
    for i in range(2):
        want = np.array([host.textline_features(dt[i], tuple(b)) for b in sb[i]])
        np.testing.assert_array_equal(fixed[i].numpy(), (want * [2, 1]).astype(np.int32))
