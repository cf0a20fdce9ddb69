"""Blind article-quality oracles of the port: the counterparts of the JAX
package's ``test_blind_e2e_*`` tests in ``tests/test_trained_models.py``.

Fresh multi-article pages from the same generators and seeds, with every
text line's article id stripped from the input PAGE-XML, go through the
port's ``run_full_workflow`` on the CPU with the converted checkpoints
(``models_ckpt_torch/``); the JAX package's ``run_measure`` scores the
clustered pages against the generators' ground truth, held to the JAX
tests' floors. The ARU-Nets run at the port's default compute dtype,
bfloat16 (as the JAX predictor's default), as on the card. The file takes
about 45 s on one CPU process.

``scripts/make_blind_fixtures.py`` commits the same pages under
``tests/data/torch_blind/`` for ``chip_smoke.py``'s ``blind`` phase (the
card's machine has neither PIL nor JAX); the last test holds them to the
generators.
"""
import glob
import json
import os
import re
import sys

import numpy as np
import pytest

from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
NPZ = os.path.join(REPO, "models_ckpt_torch")
FIXTURES = os.path.join(REPO, "tests", "data", "torch_blind")


def _pages(work):
    from scripts.make_blind_fixtures import make_pages
    return make_pages(work)


def _workflow(work, pages, gnn_model_path=None, gnn_predictor=None):
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    result = run_full_workflow(
        [img for img, _, _ in pages],
        separator_model_path=os.path.join(NPZ, "separator.npz"),
        heading_model_path=os.path.join(NPZ, "heading.npz"),
        gnn_model_path=gnn_model_path, gnn_predictor=gnn_predictor,
        clustering_method="dbscan", out_dir=os.path.join(work, "out"), device="cpu")
    assert result["skipped"] == [] and len(result["clustered"]) == len(pages)
    return result


def _measure(work, pages, result):
    from citlab_as_tpu.cli.run_measure import main as measure_main
    gt_lst, hy_lst = os.path.join(work, "gt.lst"), os.path.join(work, "hy.lst")
    with open(gt_lst, "w") as f:
        f.write("\n".join(gt for _, _, gt in pages) + "\n")
    with open(hy_lst, "w") as f:
        f.write("\n".join(result["clustered"]) + "\n")
    return measure_main(["--path_to_gt_xml_lst", gt_lst, "--path_to_hy_xml_lst", hy_lst,
                         "--min_tol", "10", "--max_tol", "30"])


@pytest.mark.usefixtures("jax_native")
def test_blind_e2e_multi_article_f1(tmp_path):
    """A fresh page with several articles per column (RandomState(777)),
    the pipeline-trained relation net: AS F1 above 0.98."""
    work = str(tmp_path)
    pages = _pages(work)["multi"]
    result = _workflow(work, pages, gnn_model_path=os.path.join(NPZ, "gnn_pipeline.npz"))
    as_r, as_p, as_f = _measure(work, pages, result)["as"]
    assert as_f > 0.98, f"AS F1 {as_f} too low (R={as_r}, P={as_p})"


@pytest.mark.usefixtures("jax_native")
def test_blind_e2e_hard_corpus_f1(tmp_path):
    """Two skewed, noisy, dense pages whose separator rules are faded below
    the separator net's detection point (RandomState(7)): baseline
    detection F1 above 0.9 and AS F1 above 0.96."""
    work = str(tmp_path)
    pages = _pages(work)["hard"]
    result = _workflow(work, pages, gnn_model_path=os.path.join(NPZ, "gnn_pipeline.npz"))
    out = _measure(work, pages, result)
    as_r, as_p, as_f = out["as"]
    bd_r, bd_p, bd_f = out["bd"]
    assert bd_f > 0.9, f"baseline-detection F1 {bd_f} too low"
    assert as_f > 0.96, f"hard-corpus AS F1 {as_f} too low (R={as_r}, P={as_p})"


@pytest.mark.usefixtures("jax_native")
def test_blind_e2e_visual_gnn_f1(tmp_path):
    """Three pages (seeds 31, 7, 101) through one workflow call with the
    visual relation net (ARU_cutted_v1 backbone, images of 288 to 384
    pixels): mean AS F1 above 0.95, and the net's confidences on the first
    page discriminate (a spread above 0.1, as the JAX test guards)."""
    from citlab_as_tpu_torch.inference import RelationPredictor
    from citlab_as_tpu_torch.utils.io import load_image
    work = str(tmp_path)
    pages = _pages(work)["visual"]
    gnn = RelationPredictor(os.path.join(NPZ, "gnn_visual.npz"), image_input=True,
                            visual_backbone="ARU_cutted_v1", image_min_dimension=288,
                            image_max_dimension=384, device="cpu")
    result = _workflow(work, pages, gnn_predictor=gnn)
    as_r, as_p, as_f = _measure(work, pages, result)["as"]
    assert as_f > 0.95, f"visual-GNN AS F1 {as_f} too low (R={as_r}, P={as_p})"
    jf = next(p for p in sorted(glob.glob(os.path.join(work, "json*", "*.json")))
              if "v31" in os.path.basename(p))
    with open(jf) as f:
        graph = json.load(f)
    confs = gnn.confidences(graph, image=np.asarray(load_image(pages[0][0], "L")))
    n = int(graph["num_nodes"])
    off_diag = confs[~np.eye(n, dtype=bool)]
    assert float(off_diag.max() - off_diag.min()) > 0.1


def _no_clock(xml):
    return re.sub(r"<LastChange>[^<]*</LastChange>", "<LastChange/>", xml)


def test_blind_fixtures_are_the_generators_pages(tmp_path):
    """The committed pages of chip_smoke.py's blind phase are the
    generators' pages: equal pixels, the same ground truth, and input
    PAGE-XML with the same text lines and no article id (the hard-corpus
    generator stamps its ground truth's LastChange, which is set aside)."""
    from PIL import Image
    from citlab_as_tpu.pagexml import Page
    with open(os.path.join(FIXTURES, "blind.json")) as f:
        record = json.load(f)
    made = _pages(str(tmp_path))
    assert {k: [os.path.splitext(os.path.basename(i))[0] for i, _, _ in v]
            for k, v in made.items()} == {k: v["pages"] for k, v in record.items()}
    for img, page, gt in (t for v in made.values() for t in v):
        name = os.path.splitext(os.path.basename(img))[0]
        committed = os.path.join(FIXTURES, f"{name}.png")
        assert np.array_equal(np.asarray(Image.open(img)), np.asarray(Image.open(committed)))
        with open(gt) as a, open(os.path.join(FIXTURES, "gt", "page", f"{name}.xml")) as b:
            assert _no_clock(a.read()) == _no_clock(b.read())
        ours = Page(os.path.join(FIXTURES, "page", f"{name}.xml")).get_textlines()
        theirs = Page(page).get_textlines()
        assert [tl.id for tl in ours] == [tl.id for tl in theirs]
        assert all(tl.get_article_id() is None for tl in ours)
