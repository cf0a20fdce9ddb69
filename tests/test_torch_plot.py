"""The port's plotting on the CPU, against the JAX package and PIL:

- ``utils/colors.py::COLORS`` and the colour lookup against the JAX list and
  matplotlib (a test-only dependency);
- ``pagexml/plot.py``: ``article_color_map``, ``compare_article_ids`` and
  the drawn items of ``plot_pagexml`` against the ``PolyCollection`` s of the
  JAX plot on the same page; the written PNG, the legend beside it, the
  side-by-side and folder plots;
- the raster (``utils/draw.py``): width-1 lines, ellipses and rectangles
  (filled and outlined) bit for bit against PIL 12.1 on random cases from a
  seed, and ``ops/image_utils.py::shape_to_mask`` against the JAX package
  for every shape type;
- ``cli/plot_net_output.py``: the overlay against the JAX tool's composite,
  and the CLI end to end.
"""
import functools
import json
import os
import sys

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

matplotlib.use("Agg")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from citlab_as_tpu_torch.pagexml import plot as tplot  # noqa: E402
from citlab_as_tpu_torch.utils import draw  # noqa: E402


@pytest.fixture(scope="module")
def demo_page(tmp_path_factory):
    """A demo page with article ids on its lines, text regions from the
    port's stages, and a separator region."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
    from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page
    root = str(tmp_path_factory.mktemp("plot"))
    image, _ = make_demo_page(root, "d0", np.random.RandomState(3), w=500, h=700)
    page = os.path.join(root, "page", "d0.xml")
    cluster_page(page, min_polygons_for_cluster=3, rectangle_interline_factor=0.4)
    generate_text_regions_for_page(page)
    return image, page


# ---------------------------------------------------------------- colours

def test_colors_equal_the_jax_list():
    import matplotlib.colors as mcolors
    from citlab_as_tpu.utils.colors import COLORS as JCOLORS
    from citlab_as_tpu_torch.utils import colors
    assert colors.COLORS == JCOLORS and len(colors.COLORS) == 155
    assert [colors.get_article_color(i) for i in range(160)] == \
        [JCOLORS[i % len(JCOLORS)] for i in range(160)]
    names = (list(mcolors.CSS4_COLORS) + list(mcolors.TABLEAU_COLORS)
             + list(mcolors.BASE_COLORS) + ["none", "#12ab9f"])
    for name in names:
        for alpha in (None, 0.3):
            assert colors.to_rgba(name, alpha) == mcolors.to_rgba(name, alpha), name
    rgb = np.random.RandomState(0).rand(5, 4, 3)
    np.testing.assert_array_equal(colors.rgb_to_hsv(rgb), mcolors.rgb_to_hsv(rgb))


# ---------------------------------------------------------------- plot.py

def test_article_ids_order_and_colours_equal_jax():
    from citlab_as_tpu.pagexml import plot as jplot
    ids = ["a10", "a2", None, "a1", "b", "a", "x3y", "a2", None, "c7"]
    for a in ids:
        for b in ids:
            assert tplot.compare_article_ids(a, b) == jplot.compare_article_ids(a, b)
    assert tplot.article_color_map(ids) == jplot.article_color_map(ids)
    assert sorted(ids, key=functools.cmp_to_key(tplot.compare_article_ids)) == \
        sorted(ids, key=functools.cmp_to_key(jplot.compare_article_ids))
    assert tplot.REGION_COLORS == jplot.REGION_COLORS


def _jax_items(ax):
    """(points, edge RGBA, closed, linewidth, filled) of every path of the
    JAX plot's collections, in drawing order."""
    out = []
    for coll in ax.collections:
        edge = [tuple(float(v) for v in c) for c in coll.get_edgecolor()]
        face = coll.get_facecolor()
        lw = [float(v) for v in coll.get_linewidth()]
        for i, path in enumerate(coll.get_paths()):
            closed = path.codes is not None and path.codes[-1] == path.CLOSEPOLY
            pts = path.vertices[:-1] if closed else path.vertices
            out.append(([tuple(map(float, p)) for p in pts], edge[i % len(edge)], closed,
                        lw[i % len(lw)], bool(len(face)) and float(face[0][3]) > 0))
    return out


@pytest.mark.parametrize("fill_regions", [False, True])
@pytest.mark.parametrize("plot_article", [True, False])
def test_plot_pagexml_items_equal_the_jax_collections(demo_page, fill_regions,
                                                      plot_article):
    import matplotlib.pyplot as plt
    from citlab_as_tpu.pagexml import plot as jplot
    image, page = demo_page
    ax = jplot.plot_pagexml(page, image, plot_article=plot_article,
                            fill_regions=fill_regions, plot_legend=True)
    want = _jax_items(ax)
    plt.close(ax.figure)
    canvas = tplot.plot_pagexml(page, image, plot_article=plot_article,
                                fill_regions=fill_regions, plot_legend=True)
    got = [(item.points, item.rgba, item.closed, item.linewidth, item.filled)
           for item in canvas]
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g[0] == w[0]
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-12)
        assert g[2:] == w[2:]
    # the JAX plot's legend handles, by label and colour
    handles = ax.get_legend().legend_handles if plot_article else []
    assert (canvas.legend or {}) == {h.get_label(): h.get_color() for h in handles}


def test_plot_raster_legend_and_lists(demo_page, tmp_path):
    """The raster holds the page image under the drawn items; the legend
    lands beside the PNG; the side-by-side plot is twice as wide; a folder
    plot finds the page."""
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.utils.io import load_image
    image, page = demo_page
    png = str(tmp_path / "p.png")
    canvas = tplot.plot_pagexml(page, image, plot_legend=True, save_path=png,
                                fill_regions=True)
    raster = np.asarray(load_image(png, mode="RGB"))
    grey = np.asarray(load_image(image, mode="L"))
    assert raster.shape == grey.shape + (3,)
    drawn = np.zeros(grey.shape, bool)
    for item in canvas:
        mask = draw.new_canvas(grey.shape[1], grey.shape[0])
        if item.filled:
            draw.polygon(mask, item.points, 255)
        draw.line(mask, list(item.points) + ([item.points[0]] if item.closed else []),
                  255, width=max(1, int(round(item.linewidth))))
        drawn |= mask > 0
    assert drawn.any() and (~drawn).any()
    np.testing.assert_array_equal(raster[~drawn], np.repeat(grey[~drawn, None], 3, 1))
    assert (raster[drawn] != np.repeat(grey[drawn, None], 3, 1)).any(axis=1).mean() > 0.9
    with open(str(tmp_path / "p_legend.json")) as f:
        assert json.load(f) == canvas.legend
    # the page's resolution without an image, or when asked for
    w, h = Page(page).get_image_resolution()
    assert tplot.plot_pagexml(page).render().shape == (h, w, 3)
    big = tplot.plot_pagexml(page, image, use_page_image_resolution=True)
    assert big.extent() == (w, h)

    side = tplot.plot_list([image], [page], gt_lst=[page], plot_legend=True,
                           out_dir=str(tmp_path / "lst"))
    both = np.asarray(load_image(side[0], mode="RGB"))
    assert both.shape == (grey.shape[0], 2 * grey.shape[1], 3)
    np.testing.assert_array_equal(both[:, :grey.shape[1]], both[:, grey.shape[1]:])
    with open(side[0][:-4] + "_legend.json") as f:
        assert set(json.load(f)) == {"HYP", "GT"}
    folder = tplot.plot_folder(os.path.dirname(image), out_dir=str(tmp_path / "f"))
    assert [os.path.basename(p) for p in folder] == ["d0.png"]
    np.testing.assert_array_equal(
        np.asarray(load_image(folder[0], mode="RGB")),
        tplot.plot_pagexml(page, image).render())


# ---------------------------------------------------------------- raster

def _random_case(rng, kind):
    w, h = rng.randint(1, 90), rng.randint(1, 90)
    if kind == "line":
        return w, h, [tuple(rng.uniform(-15, 100, 2)) for _ in range(rng.randint(1, 6))]
    x0, y0 = rng.uniform(-15, 90, 2)
    box = (x0, y0, x0 + rng.uniform(0, 70), y0 + rng.uniform(0, 70))
    if rng.rand() < 0.3:
        box = tuple(float(int(v)) for v in box)
    return w, h, box


@pytest.mark.parametrize("kind", ["line", "ellipse", "rectangle"])
def test_raster_equals_pil(kind):
    rng = np.random.RandomState({"line": 1, "ellipse": 2, "rectangle": 3}[kind])
    for _ in range(400):
        w, h, xy = _random_case(rng, kind)
        want = Image.new("L", (w, h), 0)
        got = draw.new_canvas(w, h)
        if kind == "line":
            ImageDraw.Draw(want).line(xy, fill=200, width=1)
            draw.line(got, xy, 200, width=1)
        else:
            fill = int(rng.choice([0, 0, 90]))
            width = int(rng.randint(0, 7))
            args = dict(fill=fill or None, outline=255, width=width)
            getattr(ImageDraw.Draw(want), kind)(xy, **args)
            getattr(draw, kind)(got, xy, **args)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{kind} {xy} {w}x{h}")


def test_large_ellipses_equal_pil():
    rng = np.random.RandomState(4)
    for _ in range(20):
        w, h = rng.randint(200, 700, 2)
        box = (rng.uniform(-50, w / 2), rng.uniform(-50, h / 2))
        box = box + (box[0] + rng.uniform(0, w), box[1] + rng.uniform(0, h))
        want = Image.new("L", (int(w), int(h)), 0)
        ImageDraw.Draw(want).ellipse(box, fill=1, outline=1)
        got = draw.new_canvas(int(w), int(h))
        draw.ellipse(got, box, fill=1, outline=1)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_shape_boxes_refuse_reversed_corners():
    canvas = draw.new_canvas(10, 10)
    for fn in (draw.ellipse, draw.rectangle):
        with pytest.raises(ValueError, match="x1 must be"):
            fn(canvas, (5, 1, 2, 3), fill=1)
        with pytest.raises(ValueError, match="y1 must be"):
            fn(canvas, (1, 5, 2, 3), fill=1)


@pytest.mark.parametrize("shape_type,points,kw", [
    ("circle", [(40.3, 30.7), (52.9, 41.2)], {}),
    ("rectangle", [(10.6, 12.2), (70.9, 41.5)], {}),
    ("line", [(5.5, 6.2), (80.1, 55.7)], {}),
    ("line", [(5.5, 6.2), (80.1, 55.7)], {"line_width": 1}),
    ("linestrip", [(5, 6), (40, 50), (80, 12), (20, 3)], {"line_width": 3}),
    ("point", [(33.3, 44.4)], {}),
    ("point", [(3.5, 4.5)], {"point_size": 9}),
    (None, [(5, 5), (60.7, 8.2), (70, 55), (12.4, 50.9)], {}),
])
def test_shape_to_mask_equals_jax(shape_type, points, kw):
    from citlab_as_tpu.ops.image_utils import shape_to_mask as jshape
    from citlab_as_tpu_torch.ops.image_utils import shape_to_mask as tshape
    for dtype in (bool, np.uint8):
        want = jshape((64, 90), points, shape_type, dtype=dtype, **kw)
        got = tshape((64, 90), points, shape_type, dtype=dtype, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tshape((64, 90), points, shape_type, **kw).any()


# ---------------------------------------------------------------- plot_net_output

def test_plot_net_output_overlay_equals_jax(tmp_path):
    import matplotlib.pyplot as plt
    from citlab_as_tpu.cli import plot_net_output as jtool
    from citlab_as_tpu_torch.cli import plot_net_output as ttool
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (40, 30)).astype(np.uint8)
    for channels in (2, 3, 4):
        probs = rng.rand(40, 30, channels).astype(np.float32)
        want = jtool.plot_image_with_net_output(image, probs)
        plt.close("all")
        got = ttool.plot_image_with_net_output(image, probs,
                                               save_path=str(tmp_path / "o.png"))
        np.testing.assert_array_equal(got, want)
    assert ttool.random_colors(5, bright=False, seed=3) == \
        jtool.random_colors(5, bright=False, seed=3)
    hyp, gt = rng.rand(20, 20) > 0.5, rng.rand(20, 20) > 0.5
    assert ttool.compute_accuracy(hyp, gt) == jtool.compute_accuracy(hyp, gt)


def test_plot_net_output_cli(tmp_path):
    """The CLI over 2 pages on the CPU: one ``<name>_net.png`` each, equal
    to the overlay recomputed from the predictor's probabilities."""
    from citlab_as_tpu_torch.cli import plot_net_output as ttool
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops.resize import scale_image
    from citlab_as_tpu_torch.utils.io import load_image, save_png
    rng = np.random.RandomState(1)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"p{i}.png"))
        save_png(paths[-1], rng.randint(0, 256, (90, 70)).astype(np.uint8))
    lst = tmp_path / "img.lst"
    lst.write_text("\n".join(paths) + "\n")
    npz = os.path.join(REPO, "models_ckpt_torch", "separator.npz")
    written = ttool.main(["--path_to_img_lst", str(lst), "--model", npz,
                          "--save_folder", str(tmp_path / "out"), "--fixed_height", "64",
                          "--device", "cpu"])
    assert [os.path.basename(p) for p in written] == ["p0_net.png", "p1_net.png"]
    pred = SegmentationPredictor(npz, dtype=torch.bfloat16, device="cpu")
    for path, out in zip(paths, written):
        scaled, _ = scale_image(torch.from_numpy(
            load_image(path, mode="L").astype(np.float32)), 64, 1.0)
        scaled = scaled.numpy()
        want = ttool.plot_image_with_net_output(scaled.astype(np.uint8),
                                                pred(scaled / 255.0))
        np.testing.assert_array_equal(np.asarray(load_image(out, mode="RGB")), want)
