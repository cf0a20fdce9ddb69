"""The port's AS measure (``eval/measure.py``, ``cli/run_measure.py``) and
its host C++ entry points (``gk_calc_tols``, ``gk_calc_metric``) against
the numpy plain versions and the JAX package's measure, on the CPU.

- ``calc_tols``: the C++ library and the numpy plain version equal the JAX
  package's to 1e-9;
- ``gk_calc_metric``: the precision / recall per tolerance tick equal the
  numpy path to 1e-9, with fixed and with dynamic tolerances;
- ``run_measure`` through the port's ``main`` gives the JAX ``main``'s
  (R, P, F) exactly, on random GT / hypothesis pages and on the demo page
  after the port's workflow with the converted checkpoints, where it
  reaches AS F1 > 0.98.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _random_lines(rng, n, w=1400, h=2000):
    """n baselines of 2-5 points in a few columns: (x, y) int lists."""
    lines = []
    cols = rng.randint(2, 4)
    for i in range(n):
        c = i % cols
        x0 = 40 + c * (w // cols) + rng.randint(0, 20)
        x1 = x0 + rng.randint(150, w // cols - 60)
        y = 60 + (i // cols) * rng.randint(25, 60) + rng.randint(0, 6)
        k = rng.randint(2, 6)
        xs = np.linspace(x0, x1, k).round().astype(int)
        ys = (y + rng.randint(-3, 4, k)).astype(int)
        lines.append(list(zip(xs.tolist(), ys.tolist())))
    return lines


def _write_page(path, lines, articles, w=1400, h=2000):
    from citlab_as_tpu_torch.pagexml import Page, TextLine, TextRegion
    tls = []
    for i, (pts, art) in enumerate(zip(lines, articles)):
        x0 = min(p[0] for p in pts)
        x1 = max(p[0] for p in pts)
        y0 = min(p[1] for p in pts) - 20
        y1 = max(p[1] for p in pts) + 4
        tl = TextLine(f"tl_{i}", None, "", pts, [(x0, y0), (x1, y0), (x1, y1), (x0, y1)])
        if art is not None:
            tl.set_article_id(art)
        tls.append(tl)
    doc = Page(img_filename=os.path.basename(path)[:-4] + ".png", img_w=w, img_h=h)
    doc.set_text_regions([TextRegion("r0", None, [(0, 0), (w - 1, 0), (w - 1, h - 1),
                                                  (0, h - 1)], tls)])
    doc.write_page_xml(path)


def _random_pair(root, seed):
    """A GT page and a hypothesis page: the hypothesis moves every baseline
    by a few pixels, drops some, adds some, and reassigns a share of the
    lines to other articles (some to none)."""
    rng = np.random.RandomState(seed)
    n = rng.randint(8, 40)
    lines = _random_lines(rng, n)
    gt_art = [f"a{i % rng.randint(2, 6)}" if rng.rand() > 0.05 else None for i in range(n)]
    hy_lines, hy_art = [], []
    for pts, art in zip(lines, gt_art):
        if rng.rand() < 0.1:
            continue
        hy_lines.append([(x + rng.randint(-6, 7), y + rng.randint(-6, 7)) for x, y in pts])
        hy_art.append(art if rng.rand() > 0.25 else
                      rng.choice(["a0", "a1", "b7", None]))
    hy_lines += _random_lines(rng, rng.randint(0, 4))
    hy_art += ["a9"] * (len(hy_lines) - len(hy_art))
    gt = os.path.join(root, "gt", "page", f"p{seed}.xml")
    hy = os.path.join(root, "hy", "page", f"p{seed}.xml")
    os.makedirs(os.path.dirname(gt), exist_ok=True)
    os.makedirs(os.path.dirname(hy), exist_ok=True)
    _write_page(gt, lines, gt_art)
    _write_page(hy, hy_lines, hy_art)
    return gt, hy


def _polys(page_path):
    from citlab_as_tpu_torch.eval.measure import get_data_from_pagexml
    return [p for polys in get_data_from_pagexml(page_path).values() for p in polys]


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("seed", range(6))
def test_calc_tols_equals_numpy_and_jax(tmp_path, seed):
    from citlab_as_tpu.geometry.pairwise import calc_tols as jcalc
    from citlab_as_tpu.geometry.polygon import Polygon as JPolygon
    from citlab_as_tpu.geometry.polygon import norm_poly_dists as jnorm
    from citlab_as_tpu_torch.geometry.pairwise import calc_tols, calc_tols_plain
    from citlab_as_tpu_torch.geometry.polygon import norm_poly_dists
    gt, _ = _random_pair(str(tmp_path), seed)
    polys = _polys(gt)
    normed = norm_poly_dists(polys, 5)
    jnormed = jnorm([JPolygon(list(p.x_points), list(p.y_points), p.n_points)
                     for p in polys], 5)
    want = np.asarray(jcalc(jnormed, 5, 250, 0.25))
    for rel_tol in (0.25, 0.5):
        np.testing.assert_allclose(calc_tols(normed, 5, 250, rel_tol),
                                   calc_tols_plain(normed, 5, 250, rel_tol),
                                   rtol=0, atol=1e-9)
    np.testing.assert_allclose(calc_tols(normed, 5, 250, 0.25), want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(calc_tols_plain(normed, 5, 250, 0.25), want, rtol=0,
                               atol=1e-9)
    assert calc_tols([], 5, 250, 0.25).shape == (0,)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("tols", ["fixed", "dynamic"])
def test_calc_metric_equals_numpy_path(tmp_path, seed, tols):
    from citlab_as_tpu_torch.eval.measure import BaselineMeasureEval
    gt, hy = _random_pair(str(tmp_path), seed)
    truth, reco = _polys(gt), _polys(hy)
    lo, hi = (10, 30) if tols == "fixed" else (-1, -1)
    got = BaselineMeasureEval(lo, hi)
    got.calc_measure_for_page_baseline_polys(truth, reco, use_native=True)
    want = BaselineMeasureEval(lo, hi)
    want.calc_measure_for_page_baseline_polys(truth, reco, use_native=False)
    g, w = got.measure.result, want.measure.result
    for a, b in ((g.page_wise_per_dist_tol_tick_per_line_precision,
                  w.page_wise_per_dist_tol_tick_per_line_precision),
                 (g.page_wise_per_dist_tol_tick_per_line_recall,
                  w.page_wise_per_dist_tol_tick_per_line_recall)):
        assert a[0].shape == b[0].shape
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-9)


def _lists(root, gt_files, hy_files):
    gt_lst, hy_lst = os.path.join(root, "gt.lst"), os.path.join(root, "hy.lst")
    with open(gt_lst, "w") as f:
        f.write("\n".join(gt_files) + "\n")
    with open(hy_lst, "w") as f:
        f.write("\n".join(hy_files) + "\n")
    return gt_lst, hy_lst


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("tol_args", [[], ["--min_tol", "10", "--max_tol", "30"]])
def test_run_measure_equals_jax_on_random_pages(tmp_path, tol_args):
    from citlab_as_tpu.cli.run_measure import main as jmain
    from citlab_as_tpu_torch.cli.run_measure import main as tmain
    pairs = [_random_pair(str(tmp_path), seed) for seed in range(10, 16)]
    gt_lst, hy_lst = _lists(str(tmp_path), *zip(*pairs))
    args = ["--path_to_gt_xml_lst", gt_lst, "--path_to_hy_xml_lst", hy_lst] + tol_args
    want, got = jmain(args), tmain(args)
    assert set(got) == set(want)
    for key in ("bd", "bd_without_none", "as", "counts"):
        assert got[key] == want[key], key
    assert got["as"] is not None and 0 < got["as"][2] < 1


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """The demo page of tests/test_trained_models.py (RandomState(11)), its
    GT with one article per column, and the port's clustered page from the
    workflow with the three converted checkpoints on the CPU."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.pagexml import Page
    work = str(tmp_path_factory.mktemp("demo"))
    img, _ = make_demo_page(work, "d0", np.random.RandomState(11))
    gt_dir = os.path.join(work, "gt", "page")
    os.makedirs(gt_dir)
    gt_path = os.path.join(gt_dir, "d0.xml")
    shutil.copy(os.path.join(work, "page", "d0.xml"), gt_path)
    page = Page(gt_path)
    tls = page.get_textlines()
    xs = sorted({tl.baseline.points_list[0][0] for tl in tls})
    for tl in tls:
        tl.set_article_id(f"a{xs.index(tl.baseline.points_list[0][0]) + 1}")
    page.set_textline_attr(tls)
    page.write_page_xml(gt_path)
    npz = os.path.join(REPO, "models_ckpt_torch")
    result = run_full_workflow(
        [img], gnn_model_path=os.path.join(npz, "gnn.npz"), clustering_method="dbscan",
        out_dir=os.path.join(work, "out"), device="cpu",
        separator_predictor=SegmentationPredictor(
            os.path.join(npz, "separator.npz"), dtype=torch.float32, device="cpu"),
        heading_predictor=SegmentationPredictor(
            os.path.join(npz, "heading.npz"), dtype=torch.float32, device="cpu"))
    assert result["skipped"] == []
    return _lists(work, [gt_path], [result["clustered"][0]])


@pytest.mark.usefixtures("jax_native")
def test_run_measure_equals_jax_on_the_demo_page(demo_run):
    from citlab_as_tpu.cli.run_measure import main as jmain
    from citlab_as_tpu_torch.cli.run_measure import main as tmain
    gt_lst, hy_lst = demo_run
    for tol_args in ([], ["--min_tol", "10", "--max_tol", "30"]):
        args = ["--path_to_gt_xml_lst", gt_lst, "--path_to_hy_xml_lst", hy_lst] + tol_args
        want, got = jmain(args), tmain(args)
        for key in ("bd", "bd_without_none", "as", "counts"):
            assert got[key] == want[key], (tol_args, key)


def test_converted_checkpoints_reach_article_f1_by_the_port_measure(demo_run):
    """tests/test_torch_workflow.py::test_converted_checkpoints_reach_article_f1
    with the port's own measure."""
    from citlab_as_tpu_torch.cli.run_measure import main as measure_main
    gt_lst, hy_lst = demo_run
    out = measure_main(["--path_to_gt_xml_lst", gt_lst, "--path_to_hy_xml_lst", hy_lst,
                        "--min_tol", "10", "--max_tol", "30"])
    as_r, as_p, as_f = out["as"]
    assert as_f > 0.98, f"AS F1 {as_f} too low (R={as_r}, P={as_p})"
