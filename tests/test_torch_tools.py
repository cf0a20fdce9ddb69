"""The port's corpus, keyword-spotting and profiling tools on the CPU
(``utils/corpus_tools.py``, ``utils/kws_eval.py``, ``utils/profiling.py``),
against the JAX package on generated pages and JSON."""
import glob
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _normalized(path):
    with open(path, "rb") as f:
        return re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>", f.read())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three demo pages with text regions, as GT (article ids per region,
    two regions sharing one) and as hypotheses (ids shuffled per line)."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
    from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page
    root = str(tmp_path_factory.mktemp("corpus"))
    rng = np.random.RandomState(8)
    os.makedirs(os.path.join(root, "hyp"))
    gts, hyps = [], []
    for i in range(3):
        make_demo_page(os.path.join(root, "hyp"), f"d{i}", rng, w=500, h=700)
        page_path = os.path.join(root, "hyp", "page", f"d{i}.xml")
        cluster_page(page_path, min_polygons_for_cluster=3, rectangle_interline_factor=0.4)
        generate_text_regions_for_page(page_path)
        page = Page(page_path)
        lines = []
        for j, region in enumerate(page.get_text_regions()):
            for tl in region.text_lines:
                tl.set_article_id(f"a{min(j, 2)}")
                lines.append(tl)
        page.set_textline_attr(lines)
        gt_path = os.path.join(root, "gt", f"d{i}.xml")
        os.makedirs(os.path.dirname(gt_path), exist_ok=True)
        page.write_page_xml(gt_path)
        for tl in lines:
            tl.set_article_id(f"a{rng.randint(0, 4)}" if rng.rand() < 0.7 else None)
        page.set_textline_attr(lines)
        page.write_page_xml(page_path)
        gts.append(gt_path)
        hyps.append(page_path)
    return root, hyps, gts


def _copies(root, tmp_path, hyps):
    out = {}
    for side in ("j", "t"):
        dst = str(tmp_path / side)
        shutil.copytree(os.path.join(root, "hyp"), dst)
        out[side] = [os.path.join(dst, "page", os.path.basename(p)) for p in hyps]
    return out


def test_article_id_transfer_equals_jax(corpus, tmp_path):
    from citlab_as_tpu.utils import corpus_tools as jct
    from citlab_as_tpu_torch.utils import corpus_tools as tct
    root, hyps, gts = corpus
    for fn in ("overwrite_article_ids", "overwrite_article_ids_by_region"):
        pages = _copies(root, tmp_path / fn, hyps)
        got = getattr(tct, fn)(pages["t"], gts)
        want = getattr(jct, fn)(pages["j"], gts)
        assert got == want and (got[0] if isinstance(got, tuple) else got) > 0
        for a, b in zip(pages["t"], pages["j"]):
            assert _normalized(a) == _normalized(b), fn


def test_page_stats_lists_and_bert_pairs_equal_jax(corpus, tmp_path):
    from citlab_as_tpu.utils import corpus_tools as jct
    from citlab_as_tpu_torch.utils import corpus_tools as tct
    root, hyps, gts = corpus
    for page in hyps + gts:
        for flags in ((True, True, True), (True, False, False), (False, False, True)):
            assert tct.get_page_stats(page, *flags) == jct.get_page_stats(page, *flags)
    for side, mod in (("j", jct), ("t", tct)):
        d = tmp_path / side
        d.mkdir()
        (d / "all.lst").write_text("".join(f"p{i}.png\n" for i in range(23)))
        for split in (0.1, 3):
            paths = mod.create_sub_lists(str(d / "all.lst"), split=split, seed=11)
            assert [os.path.basename(p) for p in paths] == \
                ["all_train.lst", "all_val.lst", "all_test.lst"]
            (d / f"lists_{split}").write_text("|".join(open(p).read() for p in paths))
        mod.generate_bert_finetuning_data(gts, str(d / "bert" / "ft.json"))
        mod.generate_bert_prediction_data(hyps, str(d / "bert" / "pred.json"))
    for name in ("lists_0.1", "lists_3", "bert/ft.json", "bert/pred.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    records = json.loads((tmp_path / "t" / "bert" / "ft.json").read_text())
    assert records and {r["label"] for r in records} == {0, 1}


def _kws_json(rng, images, words):
    def bl():
        x0, y0 = rng.randint(0, 2000), rng.randint(0, 3000)
        return " ".join(f"{x0 + 40 * k},{y0 + rng.randint(-3, 4)}" for k in range(4))
    return {"keywords": [
        {"kw": w, "pos": [{"image": "/storage/x/" + images[rng.randint(len(images))],
                           "bl": bl(), "line": f"l{rng.randint(99)}",
                           "conf": float(rng.rand())}
                          for _ in range(rng.randint(0, 6))]}
        for w in words]}


def test_kws_evaluation_equals_jax(tmp_path):
    from citlab_as_tpu.utils import kws_eval as jkws
    from citlab_as_tpu_torch.utils import kws_eval as tkws
    rng = np.random.RandomState(12)
    images = [f"img{i}.jpg" for i in range(5)]
    words = ["ZEITUNG", "STADT", "WAHL", "MARKT", "BERICHT", "ZEIT.*"]
    path = tmp_path / "kws.json"
    path.write_text(json.dumps(_kws_json(rng, images, words)))
    results = tkws.load_kws_results(str(path))
    assert results == jkws.load_kws_results(str(path))
    suffix = tkws.load_kws_results(str(path))
    prefix = {"TUNG": _kws_json(rng, images, ["TUNG"])["keywords"][0]["pos"]}
    hyph = {"zeitung": [("ZEI", "TUNG"), ("ZEITUNG", "")], "wahl": [("WA", "HL")]}
    queries = ["zeitung", "stadt AND wahl", "markt bericht", "fehlt", "zeitung AND markt"]
    got = tkws.evaluate_queries(results, queries)
    assert got == jkws.evaluate_queries(results, queries)
    assert any(got.values())
    got = tkws.evaluate_queries(results, queries, hyph, prefix, suffix)
    assert got == jkws.evaluate_queries(results, queries, hyph, prefix, suffix)
    for _ in range(50):
        a, b = (" ".join(f"{rng.randint(0, 3000)},{rng.randint(0, 3000)}"
                         for _ in range(3)) for _ in range(2))
        a, b = a.replace(" ", ";"), b.replace(" ", ";")
        assert tkws.are_vertically_close(a, b) == jkws.are_vertically_close(a, b)
    assert tkws.get_corresponding_page_path("/x/y/a.jpg") == \
        jkws.get_corresponding_page_path("/x/y/a.jpg")
    with pytest.raises(ValueError, match="valid extension"):
        tkws.get_img_filename("a.bmp")


def test_stage_timer_and_profile_trace(tmp_path):
    """StageTimer as the JAX one; ``profile_trace`` is a no-op without a
    directory and writes a Chrome trace on the CPU with it, holding the
    ``annotate`` range by name."""
    from citlab_as_tpu.utils.profiling import StageTimer as JTimer
    from citlab_as_tpu_torch.utils.profiling import StageTimer, annotate, profile_trace
    for timer in (StageTimer(), JTimer()):
        for name in ("a", "a", "b"):
            with timer.section(name):
                pass
        summary = timer.summary()
        assert {k: v["count"] for k, v in summary.items()} == {"a": 2, "b": 1}
        assert set(summary["a"]) == {"total_s", "count", "mean_ms"}
        timer.log_summary()
    with profile_trace(None):
        x = 1 + 1
    assert x == 2 and not os.listdir(tmp_path)
    with profile_trace(str(tmp_path / "trace")):
        with annotate("citlab_test_region"):
            y = torch.ones(64).sum()
    assert float(y) == 64.0
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "citlab_test_region" for e in events)
