"""Ground-truth generation: the port against PIL and the JAX package on the
CPU.

- Drawing (``utils/draw.py``), the bilinear resize and the JPEG writer
  (``utils/io.py``, host C++ ``csrc/image_encode.cpp``) against PIL 12.1,
  bit for bit: hypothesis draws polygons and polylines on small canvases
  (degenerate, horizontal, self-crossing and off-canvas ones among them);
  the JPEG bytes equal PIL's.
- ``get_binarization``, ``is_whitespace``, the four geometry helpers and
  ``stages/article_rectangles.py`` against the JAX functions: equal values
  (exact: the same float64 arithmetic in the same order).
- Every generator (region, BNL, BNL header, AS with article rectangles, the
  AS CLI) on small drawn pages against the JAX generator's files: equal
  decoded pixels, equal ``info.txt`` / ``regions_gt.json`` bytes, equal
  text exports; and on the committed full-size fixture pages
  (``tests/data/torch_gt``) the digests that the JAX package's generators
  gave there.
"""
import hashlib
import importlib.util
import io as _io
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw

import chip_smoke
from citlab_as_tpu.geometry import util as jutil
from citlab_as_tpu.ops import image_utils as jimage_utils
from citlab_as_tpu.stages import article_rectangles as jar
from citlab_as_tpu.stages import bnl_ground_truth as jbnl
from citlab_as_tpu.stages import ground_truth as jgt
from citlab_as_tpu_torch.geometry import util as tutil
from citlab_as_tpu_torch.geometry.rectangle import Rectangle
from citlab_as_tpu_torch.ops import image_utils as timage_utils
from citlab_as_tpu_torch.stages import article_rectangles as tar
from citlab_as_tpu_torch.stages import bnl_ground_truth as tbnl
from citlab_as_tpu_torch.stages import ground_truth as tgt
from citlab_as_tpu_torch.utils import draw
from citlab_as_tpu_torch.utils import io as tio
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _fixtures_script():
    spec = importlib.util.spec_from_file_location(
        "make_gt_fixtures", os.path.join(REPO, "scripts", "make_gt_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------ drawing

def _pil_polygon(w, h, pts):
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).polygon([tuple(map(float, p)) for p in pts], outline=255, fill=255)
    return np.asarray(img)


def _pil_line(w, h, pts, width):
    img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(img).line([tuple(map(float, p)) for p in pts], fill=255, width=width)
    return np.asarray(img)


def _assert_same(got, want):
    diff = np.argwhere(got != want)
    assert diff.size == 0, f"{len(diff)} pixels differ, first at (y, x) {diff[0].tolist()}"


_coord = (st.floats(-20, 60, allow_nan=False, allow_infinity=False)
          | st.integers(-20, 60).map(float)
          | st.integers(-40, 120).map(lambda v: v / 2.0))
_point = st.tuples(_coord, _coord)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(w=st.integers(1, 48), h=st.integers(1, 48),
       pts=st.lists(_point, min_size=2, max_size=9))
def test_polygon_equals_pil(w, h, pts):
    got = draw.new_canvas(w, h)
    draw.polygon(got, pts, 255)
    _assert_same(got, _pil_polygon(w, h, pts))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(w=st.integers(1, 48), h=st.integers(1, 48),
       pts=st.lists(_point, min_size=2, max_size=7), width=st.integers(2, 12))
def test_wide_line_equals_pil(w, h, pts, width):
    got = draw.new_canvas(w, h)
    draw.line(got, pts, 255, width=width)
    _assert_same(got, _pil_line(w, h, pts, width))


_POLYGON_CASES = {
    "two points": [(5.0, 5.0), (12.0, 9.0)],
    "all the same point": [(7.0, 3.0)] * 4,
    "collinear": [(1.0, 1.0), (9.0, 5.0), (17.0, 9.0)],
    "back and forth": [(1.0, 1.0), (7.0, 4.0), (1.0, 1.0)],
    "horizontal runs": [(2.0, 3.0), (6.0, 3.0), (11.0, 3.0), (11.0, 9.0), (7.0, 9.0),
                        (2.0, 9.0)],
    "one row": [(2.0, 4.0), (19.0, 4.0), (11.0, 4.0)],
    "bow tie": [(2.0, 2.0), (18.0, 14.0), (18.0, 2.0), (2.0, 14.0)],
    "star": [(10.0, 0.0), (13.0, 18.0), (0.0, 6.0), (20.0, 6.0), (7.0, 18.0)],
    "off canvas": [(-30.0, -30.0), (-5.0, -30.0), (-5.0, -2.0)],
    "around the canvas": [(-50.0, -50.0), (90.0, -40.0), (70.0, 95.0), (-45.0, 80.0)],
    "far away": [(1e4, 1e4), (1e4 + 5, 1e4), (1e4, 1e4 + 9)],
    "negative halves": [(-0.5, -0.5), (10.5, -1.5), (4.5, 12.5)],
}


@pytest.mark.parametrize("name", sorted(_POLYGON_CASES))
def test_polygon_edge_cases_equal_pil(name):
    pts = _POLYGON_CASES[name]
    got = draw.new_canvas(24, 20)
    draw.polygon(got, pts, 255)
    _assert_same(got, _pil_polygon(24, 20, pts))
    got = draw.new_canvas(24, 20)
    draw.line(got, pts + pts[:1], 255, width=7)
    _assert_same(got, _pil_line(24, 20, pts + pts[:1], 7))


def test_page_size_polygons_equal_pil():
    """Region-sized polygons with many vertices on a full page canvas."""
    rng = np.random.RandomState(0)
    w, h = 1420, 2000
    got, want = draw.new_canvas(w, h), Image.new("L", (w, h), 0)
    pil = ImageDraw.Draw(want)
    for _ in range(25):
        cx, cy = rng.uniform(-100, w + 100), rng.uniform(-100, h + 100)
        n = rng.randint(3, 40)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(20, 400, n)
        pts = [(float(cx + r * np.cos(a)), float(cy + r * np.sin(a))) for a, r in zip(ang, rad)]
        draw.polygon(got, pts, 255)
        pil.polygon(pts, outline=255, fill=255)
        line = [(float(x), float(y)) for x, y in rng.uniform(0, 1500, (5, 2))]
        draw.line(got, line, 255, width=7)
        pil.line(line, fill=255, width=7)
    _assert_same(got, np.asarray(want))


@pytest.mark.parametrize("fill,closed", [(True, True), (False, True), (False, False)])
def test_plot_polys_binary_equals_jax(fill, closed):
    rng = np.random.RandomState(1)
    polys = [[(float(x), float(y)) for x, y in rng.uniform(-10, 90, (rng.randint(1, 8), 2))]
             for _ in range(12)] + [[(3, 4), (30, 4), (30, 40), (3, 40)], []]
    for width in (7, 3):
        want = jgt.plot_polys_binary(polys, 80, 70, closed=closed, fill_polygons=fill,
                                     line_width=width)
        got = tgt.plot_polys_binary(polys, 80, 70, closed=closed, fill_polygons=fill,
                                    line_width=width)
        _assert_same(got, want)


# ----------------------------------------------------------- resize and JPEG

@pytest.mark.parametrize("size,out", [
    ((1420, 2000), (710, 1000)), ((37, 29), (18, 14)), ((100, 60), (33, 20)),
    ((50, 50), (50, 25)), ((50, 50), (25, 50)), ((10, 10), (23, 17)), ((7, 5), (1, 1)),
    ((1, 1), (3, 4)), ((300, 17), (299, 16))])
def test_resize_bilinear_equals_pil(size, out):
    rng = np.random.RandomState(sum(size))
    w, h = size
    img = rng.randint(0, 256, (h, w)).astype(np.uint8)
    img[: h // 2] = (np.arange(w) * 7 % 256).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out, Image.BILINEAR))
    _assert_same(tio.resize_bilinear(img, *out), want)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(w=st.integers(1, 40), h=st.integers(1, 40), ow=st.integers(1, 40),
       oh=st.integers(1, 40), seed=st.integers(0, 2 ** 16))
def test_resize_bilinear_any_size_equals_pil(w, h, ow, oh, seed):
    img = np.random.RandomState(seed).randint(0, 256, (h, w)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    _assert_same(tio.resize_bilinear(img, ow, oh), want)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 9), (8, 8), (16, 16), (64, 80), (37, 100),
                                 (300, 13), (120, 90)])
def test_save_jpeg_equals_pil(tmp_path, h, w):
    """The file's bytes equal PIL's, so its decoded pixels do too; the
    port's decoder reads it as PIL does."""
    rng = np.random.RandomState(h * w)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + rng.randn(h, w) * 30,
                  0, 255).astype(np.uint8)
    img[rng.rand(h, w) < 0.05] = 0
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    path = str(tmp_path / "page.jpg")
    tio.save_jpeg(path, img)
    with open(path, "rb") as f:
        assert f.read() == buf.getvalue()
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    _assert_same(tio.load_image(path, "L"), want)


def test_image_writers_refuse_what_they_do_not_write():
    with pytest.raises(ValueError):
        tio.resize_bilinear(np.zeros((4, 4, 3), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        tio.resize_bilinear(np.zeros((4, 4), np.uint8), 0, 2)
    # width 1 is drawn since the raster took PIL's Bresenham line; a canvas
    # that is not uint8 is still refused, and so are reversed boxes
    with pytest.raises(ValueError):
        draw.line(np.zeros((4, 4), np.float32), [(0, 0), (3, 3)], 255, width=1)
    with pytest.raises(ValueError):
        draw.ellipse(draw.new_canvas(4, 4), (3, 0, 1, 2), fill=255)
    with pytest.raises(ValueError):
        draw.polygon(np.zeros((4, 4), np.float32), [(0, 0), (3, 3), (0, 3)], 255)
    with pytest.raises(ValueError):             # PIL raises TypeError here
        draw.polygon(draw.new_canvas(4, 4), [(1, 1)], 255)
    with pytest.raises(TypeError):
        ImageDraw.Draw(Image.new("L", (4, 4))).polygon([(1.0, 1.0)], fill=255)


# ------------------------------------------------ binarization and geometry

def test_get_binarization_equals_jax(tmp_path):
    rng = np.random.RandomState(3)
    img = np.clip(rng.randn(90, 70) * 40 + 170, 0, 255).astype(np.uint8)
    img[20:30, 5:60] = 20
    path = str(tmp_path / "b.png")
    Image.fromarray(img).save(path)
    for source in (img, path):
        want = jimage_utils.get_binarization(source)
        got = timage_utils.get_binarization(source, device="cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    for x, y, bw, bh in rng.randint(0, 60, (40, 4)):
        rect = Rectangle(int(x), int(y), int(bw), int(bh))
        for thr in (0.04, 0.05, 0.3):
            assert (timage_utils.is_whitespace(want, rect, thr)
                    == jimage_utils.is_whitespace(want, rect, thr))


def _outcome(fn, *args):
    try:
        return ("value", fn(*args))
    except Exception as e:          # the reference's own failures must match too
        return ("raises", type(e).__name__)


_seg_coord = st.integers(-6, 6) | st.floats(-6, 6, allow_nan=False).map(lambda v: round(v, 2))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(_seg_coord, min_size=8, max_size=8))
def test_check_intersection_equals_jax(v):
    line_1 = [[v[0], v[1]], [v[2], v[3]]]
    line_2 = [[v[4], v[5]], [v[6], v[7]]]
    # collinear and parallel axis-aligned segments
    line_3 = [[v[0], v[1]], [v[2], v[2]]]
    line_4 = [[v[4], v[5]], [v[2], v[2]]]
    for a, b in ((line_1, line_2), (line_3, line_4)):
        assert (_outcome(tutil.check_intersection, a, b)
                == _outcome(jutil.check_intersection, a, b))


def test_polygon_clip_equals_jax():
    rng = np.random.RandomState(4)
    for _ in range(300):
        poly = [tuple(p) for p in rng.randint(0, 40, (rng.randint(3, 9), 2)).tolist()]
        hull = jutil.convex_hull([tuple(p) for p in rng.randint(0, 40, (8, 2)).tolist()])
        clip = hull[::-1] if rng.rand() < 0.3 else hull
        assert _outcome(tutil.polygon_clip, poly, clip) == _outcome(jutil.polygon_clip, poly, clip)


def _rects(rng, n, grid=10):
    out = []
    for _ in range(n):
        x, y = rng.randint(0, 12, 2) * grid
        w, h = rng.randint(1, 6, 2) * grid
        out.append((int(x), int(y), int(w), int(h)))
    return out


def _poly_lists(polys):
    return [list(zip(p.x_points, p.y_points)) for p in polys]


def test_ortho_connect_and_smoothing_equal_jax():
    from citlab_as_tpu.geometry.rectangle import Rectangle as JRect
    rng = np.random.RandomState(5)
    for trial in range(150):
        boxes = _rects(rng, rng.randint(1, 6))
        got = tutil.ortho_connect([Rectangle(*b) for b in boxes])
        want = jutil.ortho_connect([JRect(*b) for b in boxes])
        assert _poly_lists(got) == _poly_lists(want)
        for p_got, p_want in zip(got, want):
            pts = p_want.as_list()
            if trial % 2:
                pts = [(x + int(rng.randint(-3, 4)), y + int(rng.randint(-3, 4))) for x, y in pts]
            dims = (400, 800, 600, 400) if trial % 3 else (60, 40, 60, 40)
            s_got = tutil.smooth_surrounding_polygon(pts, 10, dims)
            s_want = jutil.smooth_surrounding_polygon(pts, 10, dims)
            assert s_got.as_list() == s_want.as_list()


# -------------------------------------------------------- drawn small pages

SMALL_SHAPE = (800, 560)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two drawn pages with the fixtures' GT PAGE-XML (typed and BNL-typed
    regions, separators, a table, an advert, an image, article ids), as
    PNG."""
    root = str(tmp_path_factory.mktemp("gt_corpus"))
    script = _fixtures_script()
    rules = []
    pages, _, layouts = chip_smoke.synthetic_newspaper(2, *SMALL_SHAPE, seed=7,
                                                       rules_out=rules)
    os.makedirs(os.path.join(root, "page"))
    paths = []
    for i, (page, regions, page_rules) in enumerate(zip(pages, layouts, rules)):
        path = os.path.join(root, f"p{i}.png")
        Image.fromarray(page).save(path)
        script.write_page_xml(os.path.join(root, "page", f"p{i}.xml"), f"p{i}.png",
                              *page.shape, regions, page_rules)
        paths.append(path)
    return paths


def _rect_key(r):
    return (r.x, r.y, r.width, r.height, sorted(tl.id for tl in (r.textlines or [])),
            sorted(str(a) for a in r.a_ids))


@pytest.mark.parametrize("stretch,use_surr", [(False, True), (False, False), (True, True)])
def test_article_rectangles_equal_jax(corpus, stretch, use_surr):
    from citlab_as_tpu.pagexml import Page as JPage
    from citlab_as_tpu_torch.pagexml import Page
    for img in corpus:
        page_path = tio.get_page_path(img)
        want = jar.get_article_rectangles_from_baselines(JPage(page_path), img, stretch,
                                                         use_surr)
        got = tar.get_article_rectangles_from_baselines(Page(page_path), img, stretch,
                                                        use_surr, device="cpu")
        assert list(got) == list(want)
        assert {k: [_rect_key(r) for r in v] for k, v in got.items()} == \
            {k: [_rect_key(r) for r in v] for k, v in want.items()}
        for hull in (False, True):
            m_got = tar.merge_article_rectangles_vertically(got, use_convex_hull=hull)
            m_want = jar.merge_article_rectangles_vertically(want, use_convex_hull=hull)
            assert {k: _poly_lists(v) for k, v in m_got.items()} == \
                {k: _poly_lists(v) for k, v in m_want.items()}
        asp_got = tar.get_article_surrounding_polygons(got)
        asp_want = jar.get_article_surrounding_polygons(want)
        assert {k: _poly_lists(v) for k, v in asp_got.items()} == \
            {k: _poly_lists(v) for k, v in asp_want.items()}
        s_got = tar.smooth_article_surrounding_polygons(asp_got)
        s_want = jar.smooth_article_surrounding_polygons(asp_want)
        assert {k: [p.as_list() for p in v] for k, v in s_got.items()} == \
            {k: [p.as_list() for p in v] for k, v in s_want.items()}


@pytest.mark.usefixtures("jax_native")
def test_article_subregions_and_blank_rectangles_equal_jax(corpus):
    from citlab_as_tpu.pagexml import Page as JPage
    from citlab_as_tpu_torch.pagexml import Page
    page_path = tio.get_page_path(corpus[0])
    a_got, h_got, w_got = tar.get_article_rectangles_from_surr_polygons(Page(page_path))
    a_want, h_want, w_want = jar.get_article_rectangles_from_surr_polygons(JPage(page_path))
    assert (h_got, w_got) == (h_want, w_want)
    assert [_rect_key(r) for r in a_got] == [_rect_key(r) for r in a_want]

    def grouped(ars):
        out = {}
        for ar in ars:
            key = "blank" if not ar.a_ids else sorted(ar.a_ids)[0]
            out.setdefault(key, []).append(ar)
        return out

    g_got, g_want = grouped(a_got), grouped(a_want)
    assert g_want.get("blank"), "the quad tree must leave blank rectangles"
    for method in ("bb", "ch"):
        r_got = tar.convert_blank_article_rects_by_rects(g_got, method)
        r_want = jar.convert_blank_article_rects_by_rects(g_want, method)
        assert {k: [_rect_key(r) for r in v] for k, v in r_got.items()} == \
            {k: [_rect_key(r) for r in v] for k, v in r_want.items()}
        asp_got = tar.get_article_surrounding_polygons(
            {k: v for k, v in g_got.items() if k != "blank"})
        asp_want = jar.get_article_surrounding_polygons(
            {k: v for k, v in g_want.items() if k != "blank"})
        p_got = tar.convert_blank_article_rects_by_polys(g_got, asp_got, method)
        p_want = jar.convert_blank_article_rects_by_polys(g_want, asp_want, method)
        assert {k: [_rect_key(r) for r in v] for k, v in p_got.items()} == \
            {k: [_rect_key(r) for r in v] for k, v in p_want.items()}


def test_min_area_rect_and_channel_composition_equal_jax():
    rng = np.random.RandomState(6)
    for _ in range(50):
        pts = [tuple(p) for p in rng.randint(0, 100, (rng.randint(1, 12), 2)).tolist()]
        assert tgt.min_area_rect(pts) == jgt.min_area_rect(pts)
    for n in (1, 2, 4):
        channels = [(rng.rand(30, 20) < 0.4).astype(np.uint8) * 255 for _ in range(n)]
        composed = []
        for mod in (jgt, tgt):
            gen = object.__new__(mod.GroundTruthGenerator)
            gen.gt_imgs_lst = [[c.copy() for c in channels]]
            gen.gt_channel_names = [f"c{i}" for i in range(n)]
            gen.make_disjoint_all()
            gen.add_other_channel()
            assert gen.gt_channel_names[-1] == "other"
            composed.append(gen.gt_imgs_lst[0])
        got, want = composed
        assert len(got) == n + 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tgt.make_disjoint(channels[0], channels[-1]),
                                      jgt.make_disjoint(channels[0], channels[-1]))
        np.testing.assert_array_equal(tgt.create_other_ground_truth_image(*channels),
                                      jgt.create_other_ground_truth_image(*channels))


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def _assert_same_tree(got_root, want_root):
    """Equal file names; images equal pixels (the port's decoder on its
    files, PIL on the reference's; JPEG also equal bytes); text bytes."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, names in os.walk(root) for n in names)
    assert files(got_root) == files(want_root)
    for rel in files(want_root):
        got, want = os.path.join(got_root, rel), os.path.join(want_root, rel)
        if rel.endswith((".png", ".jpg")):
            tio._IMAGE_CACHE.clear()
            np.testing.assert_array_equal(tio.load_image(got, "L"), _pixels(want),
                                          err_msg=rel)
        if not rel.endswith(".png"):
            with open(got, "rb") as a, open(want, "rb") as b:
                assert a.read() == b.read(), rel


_REGION_CASES = [
    ("region", {}), ("region", {"max_resolution": (400, 0)}),
    ("region", {"max_resolution": (0, 300)}), ("region", {"scaling_factor": 0.5}),
    ("region", {"use_bounding_box": True}), ("region", {"use_min_area_rect": True}),
    ("region", {"region_types": ["TextRegion", "SeparatorRegion", "TableRegion",
                                 "AdvertRegion", "ImageRegion"]}),
    ("bnl", {}), ("bnl", {"scaling_factor": 0.75}), ("bnl_header", {}),
]


@pytest.mark.parametrize("kind,kwargs", _REGION_CASES,
                         ids=[f"{k}-{sorted(kw)}" for k, kw in _REGION_CASES])
def test_region_generators_equal_jax(tmp_path, corpus, kind, kwargs):
    classes = {"region": (jgt.RegionGroundTruthGenerator, tgt.RegionGroundTruthGenerator),
               "bnl": (jbnl.BNLGroundTruthGenerator, tbnl.BNLGroundTruthGenerator),
               "bnl_header": (jbnl.BNLHeaderGroundTruthGenerator,
                              tbnl.BNLHeaderGroundTruthGenerator)}
    jcls, tcls = classes[kind]
    jgen = jcls(corpus, **kwargs)
    tgen = tcls(corpus, **kwargs)
    assert tgen.scaling_factors == jgen.scaling_factors
    want_root, got_root = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jgen.run_ground_truth_generation(want_root)
    got = tgen.run_ground_truth_generation(got_root)
    assert [os.path.relpath(p, got_root) for p in got] == \
        [os.path.relpath(p, want_root) for p in want]
    if kind == "region":
        jgen.create_ground_truth_json(want_root)
        tgen.create_ground_truth_json(got_root)
    _assert_same_tree(got_root, want_root)
    assert tgen.gt_channel_names == jgen.gt_channel_names
    fired = [int((c > 0).sum()) for c in tgen.gt_imgs_lst[0]]
    assert all(fired), f"every channel draws something: {fired}"


def test_region_getters_equal_jax(corpus):
    jgen = jgt.RegionGroundTruthGenerator(corpus)
    tgen = tgt.RegionGroundTruthGenerator(corpus)

    def ids(lists):
        return [[r.id for r in regions] for regions in lists]

    assert ids(tgen.get_image_regions_list()) == ids(jgen.get_image_regions_list())
    assert ids(tgen.get_separator_regions_list()) == ids(jgen.get_separator_regions_list())
    assert ids(tgen.get_table_regions_list()) == ids(jgen.get_table_regions_list())
    assert ids(tgen.get_advert_regions_list()) == ids(jgen.get_advert_regions_list())
    for thresh in (20, 0, -1):
        assert ids(tgen.get_valid_text_regions(thresh)) == \
            ids(jgen.get_valid_text_regions(thresh))
    assert ids(tgen.get_title_regions_list(["subheadline"])) == \
        ids(jgen.get_title_regions_list(["subheadline"]))
    assert ids(tgen.get_classic_heading_regions_list(["", "author"])) == \
        ids(jgen.get_classic_heading_regions_list(["", "author"]))
    assert ids(tgen.get_caption_text_regions()) == ids(jgen.get_caption_text_regions())
    assert [[r.id for r in tgen.get_heading_regions_for_page(p)]
            for p in tgen.page_object_lst] == \
        [[r.id for r in jgen.get_heading_regions_for_page(p)] for p in jgen.page_object_lst]
    assert any(ids(tgen.get_title_regions_list(["subheadline"])))


@pytest.mark.parametrize("kwargs", [
    {}, {"fill_articles": True}, {"with_baseline_gt": False}, {"scaling_factor": 0.5},
    {"dilation_kernel": (5, 3)}])
def test_as_ground_truth_equals_jax(tmp_path, corpus, kwargs):
    for img in corpus:
        page_path = tio.get_page_path(img)
        want = jgt.generate_as_ground_truth(page_path, save_folder=str(tmp_path / "jax"),
                                            **kwargs)
        got = tgt.generate_as_ground_truth(page_path, save_folder=str(tmp_path / "port"),
                                           device="cpu", **kwargs)
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got["article"].max() == 255
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_as_gt_cli_equals_jax_and_skips_a_bad_page(tmp_path, corpus, caplog):
    from citlab_as_tpu.cli import run_as_gt_generation as jcli
    from citlab_as_tpu_torch.cli import run_as_gt_generation as tcli
    lst = tmp_path / "pages.lst"
    lst.write_text("\n".join([tio.get_page_path(corpus[0]), str(tmp_path / "missing.xml"),
                              tio.get_page_path(corpus[1])]) + "\n")
    jcli.main(["--pagexml_list", str(lst), "--save_folder", str(tmp_path / "jax")])
    done = tcli.main(["--pagexml_list", str(lst), "--save_folder", str(tmp_path / "port"),
                      "--device", "cpu"])
    assert done == 2
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_text_exports_equal_jax(tmp_path, corpus):
    pages = [tio.get_page_path(p) for p in corpus]
    want = jgt.create_text_files_from_page_list(pages, str(tmp_path / "jax"))
    got = tgt.create_text_files_from_page_list(pages, str(tmp_path / "port"))
    assert got == want and all(any(v.values()) for v in got.values())
    assert tgt.create_text_file_from_page(pages[0]) == jgt.create_text_file_from_page(pages[0])
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_generators_default_to_cuda_and_raise_without_it(monkeypatch, corpus):
    from citlab_as_tpu_torch.cli import run_as_gt_generation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgt.apply_dilation(np.zeros((4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        timage_utils.get_binarization(np.zeros((4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tgt.generate_as_ground_truth(tio.get_page_path(corpus[0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_as_gt_generation.main(["--pagexml_list", "unused", "--save_folder", "unused"])


# --------------------------------------------------- full-size fixture pages

def _fixture_record():
    with open(os.path.join(chip_smoke.GT_DIR, "digests.json")) as f:
        return json.load(f)


def test_fixture_digests_match_the_jax_generators(tmp_path):
    """The committed digests are what the JAX package's generators write
    from the committed pages (the fixture is in step with both)."""
    record = _fixture_record()
    images = [os.path.join(chip_smoke.GT_DIR, p) for p in record["pages"]]
    for path in images:
        with Image.open(path) as im:
            assert im.size == (1420, 2000)
    assert _fixtures_script().run_jax_generators(images, str(tmp_path)) == record["runs"]


def test_port_generators_reproduce_the_fixture_digests(tmp_path):
    """The smoke's ``gt_eval`` gate, here on the CPU device: every file the
    port's generators write from the full-size pages decodes to the
    digest the JAX package's file gave."""
    record = _fixture_record()
    images = [os.path.join(chip_smoke.GT_DIR, p) for p in record["pages"]]
    got, done = chip_smoke.run_gt_generators(images, str(tmp_path), CPU,
                                             record["half_resolution"])
    assert done == len(images)
    assert chip_smoke.compare_gt_records(record["runs"], got) is None
    assert sum(len(r) for r in record["runs"].values()) == 58
    digest = hashlib.sha256(np.asarray(tio.load_image(images[0], "L")).tobytes()).hexdigest()
    assert digest == hashlib.sha256(_pixels(images[0]).tobytes()).hexdigest()
