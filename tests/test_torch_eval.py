"""Evaluation: the split/merge comparator, its tournament and reports, the
AS checker, the two comparison CLIs and the heading evaluation with its
grid search, the port against the JAX package on the CPU.

Comparisons, CSV bytes, SQLite rows, pickle contents, the tournament and
the XLSX zip members (not the zip bytes, which carry timestamps) are
equal; the numpy precision / recall / F1 equals sklearn's to 1e-12
(hypothesis over label vectors, all four averages, one-class and empty
cases); the heading grid search gives the JAX package's metrics to 1e-12
in the same order, and leaves the same pages on disk.
"""
import os
import pickle
import sqlite3
import warnings
import zipfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from citlab_as_tpu.cli import min_run_example as jmin
from citlab_as_tpu.cli import run_compare as jrun
from citlab_as_tpu.eval import checker as jchk
from citlab_as_tpu.eval import compare as jcmp
from citlab_as_tpu.eval import heading_eval as jhe
from citlab_as_tpu_torch.cli import min_run_example as tmin
from citlab_as_tpu_torch.cli import run_compare as trun
from citlab_as_tpu_torch.eval import checker as tchk
from citlab_as_tpu_torch.eval import compare as tcmp
from citlab_as_tpu_torch.eval import heading_eval as the


def _line(i, aid, text, y):
    custom = f' custom="structure {{id:{aid}; type:article;}}"' if aid is not None else ""
    return (f'<TextLine id="tl_{i:02d}"{custom}><Coords points="50,{y - 20} 550,{y - 20} '
            f'550,{y + 5} 50,{y + 5}"/><Baseline points="50,{y} 550,{y}"/>'
            f'<TextEquiv><Unicode>{text}</Unicode></TextEquiv></TextLine>')


def _page_xml(regions):
    """regions: [(region id, [(line index, article id or None, text)])]."""
    blocks, y = [], 40
    for rid, lines in regions:
        body = []
        for i, aid, text in lines:
            body.append(_line(i, aid, text, y))
            y += 30
        blocks.append(f'<TextRegion id="{rid}" type="paragraph"><Coords points="40,10 '
                      f'560,10 560,{y} 40,{y}"/>' + "".join(body) + "</TextRegion>")
    return ('<?xml version="1.0" encoding="UTF-8"?>\n<PcGts xmlns="http://schema.'
            'primaresearch.org/PAGE/gts/pagecontent/2013-07-15"><Metadata><Creator>c'
            '</Creator><Created>t</Created><LastChange>t</LastChange></Metadata>'
            f'<Page imageFilename="p.png" imageWidth="600" imageHeight="{y + 40}">'
            + "".join(blocks) + "</Page></PcGts>")


def _write(path, regions):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(_page_xml(regions))
    return path


def _partition(rng, ids, n_articles, none_rate=0.0):
    return [(i, None if rng.rand() < none_rate else f"a{rng.randint(n_articles)}",
             f"text {i}") for i in ids]


def _work_tree(root, seed=0, n_pages=3, methods=("good", "random", "merged")):
    """GT pages under root/gt/page and hypotheses under
    root/work/<run>/clustering/<method>/<name>_clustering.xml."""
    rng = np.random.RandomState(seed)
    gts = []
    for p in range(n_pages):
        n = rng.randint(4, 12)
        gt = _partition(rng, range(n), 3)
        gts.append(_write(os.path.join(root, "gt", "page", f"pg{p}.xml"), [("r0", gt)]))
        for method in methods:
            if method == "good":
                hyp = gt
            elif method == "merged":
                hyp = [(i, "a0", t) for i, _, t in gt]
            else:
                hyp = _partition(rng, range(n), 4)
            _write(os.path.join(root, "work", "run1", "clustering", method,
                                f"pg{p}_clustering.xml"), [("r0", hyp)])
    return sorted(gts)


def _compare(mod, gt, hyps):
    comper = mod.SepPageBlComper()
    comper.loadGT(gt)
    out = []
    for hyp in hyps:
        try:
            out.append(comper.compareTo(hyp).dataDict().copy())
        except AssertionError as e:
            out.append(("raises", str(e)))
    return out


def test_comparisons_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    for trial in range(40):
        n = rng.randint(1, 12)
        gt = _partition(rng, range(n), rng.randint(1, 5), none_rate=0.15)
        gt_path = _write(str(tmp_path / f"gt{trial}.xml"), [("r0", gt[: n // 2]),
                                                            ("r1", gt[n // 2:])])
        hyps = []
        for k, kind in enumerate(("same", "random", "subset", "extra")):
            if kind == "same":
                lines = gt
            elif kind == "random":
                lines = _partition(rng, range(n), rng.randint(1, 5), none_rate=0.1)
            elif kind == "subset":
                lines = _partition(rng, sorted(rng.choice(n, max(1, n - 2), replace=False)), 3)
            else:
                lines = _partition(rng, range(n + 1), 2)
            hyps.append(_write(str(tmp_path / f"hyp{trial}_{k}.xml"), [("r0", lines)]))
        want = _compare(jcmp, gt_path, hyps)
        assert _compare(tcmp, gt_path, hyps) == want
        assert want[0]["splits"] == want[0]["merges"] == 0
        assert want[3][0] == "raises"
        for comp in want[:3]:
            assert comp["gtNIs"] + comp["splits"] + comp["merges"] == comp["hypNIs"]
    page = tcmp.SeparatedPage(gt_path)
    jpage = jcmp.SeparatedPage(gt_path)
    assert page.canonicalBlPartition() == jpage.canonicalBlPartition()
    page.removeBlSet({"tl_00"})
    jpage.removeBlSet({"tl_00"})
    assert page.niBlDict == jpage.niBlDict


def _comp_dicts(tmp_path):
    gts = _work_tree(str(tmp_path))
    out = []
    for mod in (tcmp, jcmp):
        comper, spc = mod.SepPageBlComper(), mod.SepPageCompDict()
        for gt in gts:
            comper.loadGT(gt)
            name = os.path.basename(gt)[:-4] + "_clustering.xml"
            for method in ("good", "random", "merged"):
                hyp = str(tmp_path / "work" / "run1" / "clustering" / method / name)
                spc.addItem("ds", gt, hyp, comper.compareTo(hyp))
                spc.addItem("ds2", gt, hyp, comper.compareTo(hyp))
        out.append(spc)
    return out


def _plain(spc):
    return {ds: {gt: {hyp: (c.dataDict().copy() if c is not None else None)
                      for hyp, c in g.items()} for gt, g in d.items()} for ds, d in spc.items()}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_comp_dict_round_trips_equal_jax(tmp_path):
    spc, jspc = _comp_dicts(tmp_path)
    assert _plain(spc) == _plain(jspc)
    csv_t, csv_j = tmp_path / "t.csv", tmp_path / "j.csv"
    spc.expCsv(csv_t)
    jspc.expCsv(csv_j)
    assert csv_t.read_bytes() == csv_j.read_bytes()
    methods = sorted({tcmp.SepPageCompDict.path2method(hyp) for g in spc["ds"].values()
                      for hyp in g})
    assert methods == sorted({jcmp.SepPageCompDict.path2method(hyp)
                              for g in jspc["ds"].values() for hyp in g})
    assert len(methods) == 3 and methods[0].endswith("/good")
    back = tcmp.SepPageCompDict()
    back.loadCSV(csv_j, methods[:2])
    jback = jcmp.SepPageCompDict()
    jback.loadCSV(csv_j, methods[:2])
    assert _plain(back) == _plain(jback) and len(back["ds"]) == 3
    for mod, d, name in ((tcmp, spc, "t.db"), (jcmp, jspc, "j.db")):
        d.expSqlite(tmp_path / name, "comparisons")
    rows = []
    for name in ("t.db", "j.db"):
        con = sqlite3.connect(str(tmp_path / name))
        rows.append(con.execute("SELECT * FROM comparisons").fetchall())
        con.close()
    assert rows[0] == rows[1] and len(rows[0]) == 18
    spc.savePickle("ds", tmp_path / "t.pkl")
    jspc.savePickle("ds", tmp_path / "j.pkl")
    loaded = tcmp.SepPageCompDict()
    loaded.loadPickle("ds", tmp_path / "t.pkl")
    with open(tmp_path / "j.pkl", "rb") as f:
        jloaded = {"ds": pickle.load(f)}
    assert _plain(loaded) == _plain(jloaded)
    spc.cleanup(methods[:1])
    jspc.cleanup(methods[:1])
    assert _plain(spc) == _plain(jspc)


def test_tournament_and_xlsx_equal_jax(tmp_path):
    spc, jspc = _comp_dicts(tmp_path)
    ev, jev = tcmp.CompDictEvaler(spc), jcmp.CompDictEvaler(jspc)
    ev.calcWinnerDict()
    jev.calcWinnerDict()
    assert ev.winnerStatDict == jev.winnerStatDict
    assert ev.winnerDict == jev.winnerDict
    ev.winnerStat2xlsx(tmp_path / "t.xlsx")
    jev.winnerStat2xlsx(tmp_path / "j.xlsx")
    members = _members(tmp_path / "t.xlsx")
    assert members == _members(tmp_path / "j.xlsx")
    assert len([m for m in members if m.startswith("xl/worksheets/")]) == 3


def _checker_pages(root):
    pages = [
        [("r0", [(0, "a1", "same"), (1, "a1", ""), (2, None, "x")]),
         ("r1", [(3, "a1", "same"), (4, "a2", "y")])],
        [("r0", [(0, "a1", "one"), (1, "a1", "two")])],
        [("r0", [(0, None, ""), (1, "a3", "z"), (2, "a4", "z")])],
    ]
    return [_write(os.path.join(root, f"c{i}.xml"), regions) for i, regions in enumerate(pages)]


@pytest.mark.parametrize("codes", [None, ("TL_12",), ("TL_11", "TR_11"), ("TL_21",)])
def test_checker_reports_equal_jax(tmp_path, codes):
    paths = _checker_pages(str(tmp_path))
    out = []
    for mod in (tchk, jchk):
        code_set = set(mod.AsProbCode) if codes is None else {mod.AsProbCode[c] for c in codes}
        checker = mod.AsChecker(code_set)
        checker.page_list = paths
        checker.check_pages()
        name = "t" if mod is tchk else "j"
        checker.probs_to_xlsx(tmp_path / f"{name}.xlsx")
        out.append((checker.prob_to_json(), checker.cnt_probs, checker.cnt_dict,
                    _members(tmp_path / f"{name}.xlsx")))
    assert out[0] == out[1]
    assert out[0][1] > 0
    with pytest.raises(RuntimeError):
        tchk.AsChecker(set())
    empty = tchk.AsChecker({tchk.AsProbCode.TL_12})
    assert empty.prob_to_json() == jchk.AsChecker({jchk.AsProbCode.TL_12}).prob_to_json()


@pytest.mark.parametrize("source", ["gt_list", "gt_dir"])
def test_run_compare_equals_jax(tmp_path, source):
    gts = _work_tree(str(tmp_path), seed=2)
    if source == "gt_list":
        lst = tmp_path / "gt.lst"
        lst.write_text("\n".join(gts) + "\n")
        args = ["--gt_list", str(lst)]
    else:
        args = ["--gt_dir", str(tmp_path / "gt")]
    args += ["--work_dir", str(tmp_path / "work"), "--name", "x", "--dataset", "d"]
    spc, ev = trun.main(args + ["--out_dir", str(tmp_path / "t")])
    jspc, jev = jrun.main(args + ["--out_dir", str(tmp_path / "j")])
    assert _plain(spc) == _plain(jspc) and ev.winnerDict == jev.winnerDict
    assert (tmp_path / "t" / "x_comparison.csv").read_bytes() == \
        (tmp_path / "j" / "x_comparison.csv").read_bytes()
    assert _members(tmp_path / "t" / "x_comparison.xlsx") == \
        _members(tmp_path / "j" / "x_comparison.xlsx")
    assert sum(len(g) for g in spc["d"].values()) == 9


def test_min_run_example_equals_jax(tmp_path, capsys):
    work = str(tmp_path / "work")
    out = []
    for mod, name in ((tmin, "t"), (jmin, "j")):
        spc, ev = mod.main(["--demo", "--work_dir", work, "--out_dir", str(tmp_path / name)])
        printed = capsys.readouterr().out.replace(str(tmp_path / name), "OUT")
        out.append((_plain(spc), ev.winnerDict, printed))
    assert out[0] == out[1]
    assert (tmp_path / "t" / "comparison.csv").read_bytes() == \
        (tmp_path / "j" / "comparison.csv").read_bytes()
    assert _members(tmp_path / "t" / "comparison.xlsx") == \
        _members(tmp_path / "j" / "comparison.xlsx")
    comps = {os.path.basename(os.path.dirname(h)): c
             for g in out[0][0]["example"].values() for h, c in g.items()}
    assert comps["method-good"]["dist"] == 0 and comps["method-merged"]["merges"] == -1


# ---------------------------------------------------------------- P / R / F1

def _sklearn(y_true, y_pred, average):
    from sklearn.metrics import f1_score, precision_score, recall_score
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return tuple(float(fn(y_true, y_pred, average=average, zero_division=0))
                         for fn in (precision_score, recall_score, f1_score))
        except ValueError:
            return "ValueError"


def _numpy(y_true, y_pred, average):
    try:
        return the.precision_recall_f1(y_true, y_pred, average)
    except ValueError:
        return "ValueError"


_labels = st.one_of(
    st.integers(0, 12).flatmap(lambda n: st.tuples(st.lists(st.booleans(), min_size=n, max_size=n),
                                                   st.lists(st.booleans(), min_size=n, max_size=n))),
    st.integers(0, 12).flatmap(lambda n: st.tuples(st.lists(st.integers(0, 3), min_size=n, max_size=n),
                                                   st.lists(st.integers(0, 3), min_size=n, max_size=n))))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_labels)
def test_precision_recall_f1_equal_sklearn(labels):
    y_true, y_pred = labels
    for average in the.AVERAGES:
        want = _sklearn(y_true, y_pred, average)
        got = _numpy(y_true, y_pred, average)
        if isinstance(want, str):
            assert got == want
        else:
            assert got != "ValueError" and np.allclose(got, want, rtol=0, atol=1e-12), \
                (average, got, want)


@pytest.mark.parametrize("y_true,y_pred", [
    ([], []), ([True], [True]), ([False, False], [False, False]), ([True, True], [False, False]),
    ([False, False], [True, True]), ([2, 2], [2, 2]), ([0, 2], [2, 0]), ([1, 2], [1, 1])])
def test_precision_recall_f1_one_class_and_empty(y_true, y_pred):
    for average in the.AVERAGES:
        want = _sklearn(y_true, y_pred, average)
        got = _numpy(y_true, y_pred, average)
        assert got == want if isinstance(want, str) else np.allclose(got, want, atol=1e-12)


# ---------------------------------------------------------- heading evaluation

H, W = 240, 320


def _heading_image(i):
    rng = np.random.RandomState(11 + i)
    img = np.full((H, W), 255, np.uint8)
    img[20:60, 20:300 - 10 * i] = 0                       # fat-stroke headline
    for k, y in enumerate((90, 130, 170)):               # body lines, bolder and bolder
        for x in range(20, 290, 14):
            img[y:y + 14, x:x + 3 + 4 * k + (i == 2)] = 0
    img[rng.rand(H, W) < 0.002] = 0
    return img


def _heading_xml(i, gt_types):
    lines = ['<TextLine id="tl_a"><Coords points="18,18 302,18 302,62 18,62"/>'
             '<Baseline points="18,60 302,60"/></TextLine>']
    for k, y in enumerate((90, 130, 170)):
        lines.append(f'<TextLine id="tl_b{k}"><Coords points="18,{y - 2} 295,{y - 2} '
                     f'295,{y + 16} 18,{y + 16}"/><Baseline points="18,{y + 14} '
                     f'295,{y + 14}"/></TextLine>')
    return ('<?xml version="1.0" encoding="UTF-8"?>\n<PcGts xmlns="http://schema.'
            'primaresearch.org/PAGE/gts/pagecontent/2013-07-15"><Metadata><Creator>t'
            '</Creator><Created>x</Created><LastChange>x</LastChange></Metadata>'
            f'<Page imageFilename="he{i}.png" imageWidth="{W}" imageHeight="{H}">'
            f'<TextRegion id="tr_head" type="{gt_types[0]}"><Coords points="10,10 310,10 '
            f'310,70 10,70"/>{lines[0]}</TextRegion>'
            f'<TextRegion id="tr_body" type="{gt_types[1]}"><Coords points="10,80 310,80 '
            f'310,230 10,230"/>{"".join(lines[1:])}</TextRegion></Page></PcGts>')


def _heading_corpus(root):
    os.makedirs(os.path.join(root, "page"))
    paths = []
    for i, types in enumerate((("heading", "paragraph"), ("heading", "paragraph"),
                               ("heading", "heading"))):
        path = os.path.join(root, f"he{i}.png")
        Image.fromarray(_heading_image(i)).save(path)
        with open(os.path.join(root, "page", f"he{i}.xml"), "w") as f:
            f.write(_heading_xml(i, types))
        paths.append(path)
    return paths


def _net(image_grey):
    """A deterministic net output: the heading probability rises down the
    page below the headline and follows the ink above it, so the body
    lines' net scores span the grid's thresholds."""
    h, w = image_grey.shape
    ramp = np.clip((np.arange(h, dtype=np.float32) - 60.0) / 150.0, 0.0, 1.0)
    p0 = np.repeat(ramp[:, None] * 0.95, w, axis=1)
    p0[:60] = np.clip(1.0 - image_grey[:60], 0.0, 1.0) * 0.95
    p0 = p0.astype(np.float32)
    return np.stack([p0, 1.0 - p0], axis=-1)


@pytest.fixture
def frozen_clock(monkeypatch):
    from citlab_as_tpu.pagexml import page as jpage
    from citlab_as_tpu_torch.pagexml import page as tpage
    for mod in (jpage, tpage):
        monkeypatch.setattr(mod, "_utc_now", lambda: "2026-01-01T00:00:00")


def test_run_heading_evaluation_equals_jax(tmp_path, frozen_clock):
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    paths = [_heading_corpus(r) for r in roots]
    kw = dict(fixed_height=H, weight_dict={"net": 0.6, "stroke_width": 0.2,
                                           "text_height": 0.2}, threshold=0.5)
    want = jhe.run_heading_evaluation(paths[0], _net, **kw)
    got = the.run_heading_evaluation(paths[1], _net, **kw)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k
    assert 0.0 < want["f1_macro"] < 1.0


def test_grid_search_equals_jax_and_leaves_the_same_pages(tmp_path, frozen_clock):
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    paths = [_heading_corpus(r) for r in roots]
    kw = dict(fixed_heights=(H,), thresholds=(0.35, 0.6), net_weights=(0.8, 0.7),
              text_height_threshs=(0.9,), text_line_percentages=(0.8, 0.5))
    want = jhe.run_grid_search(paths[0], _net, **kw)
    got = the.run_grid_search(paths[1], _net, **kw)
    assert [r["setting"] for r in got] == [r["setting"] for r in want]
    assert len(want) == 2 * (3 + 4) * 2
    for g, w in zip(got, want):
        assert list(g["metrics"]) == list(w["metrics"])
        for k in w["metrics"]:
            assert abs(g["metrics"][k] - w["metrics"][k]) <= 1e-12
            assert 0.0 <= g["metrics"][k] <= 1.0
    assert len({r["metrics"]["f1_binary"] for r in want}) > 1
    for i in range(3):
        left = [os.path.join(r, "page", f"he{i}.xml.xml") for r in roots]
        with open(left[0], "rb") as a, open(left[1], "rb") as b:
            assert b.read() == a.read()
    assert sorted(os.listdir(os.path.join(roots[1], "page"))) == \
        sorted(os.listdir(os.path.join(roots[0], "page")))


def test_heading_evaluation_page_getters_equal_jax(tmp_path):
    from citlab_as_tpu.pagexml import Page as JPage
    from citlab_as_tpu_torch.pagexml import Page
    paths = _heading_corpus(str(tmp_path))
    for p in paths:
        xml = os.path.join(str(tmp_path), "page", os.path.basename(p)[:-4] + ".xml")
        t_regions = the.get_heading_regions(Page(xml))
        j_regions = jhe.get_heading_regions(JPage(xml))
        assert [r.id for r in t_regions] == [r.id for r in j_regions]
        assert [tl.id for tl in the.get_heading_text_lines(t_regions)] == \
            [tl.id for tl in jhe.get_heading_text_lines(j_regions)]
        assert [tl.id for tl in the.get_heading_text_line_by_custom_type(t_regions)] == \
            [tl.id for tl in jhe.get_heading_text_line_by_custom_type(j_regions)]
    gt = [os.path.join(str(tmp_path), "page", f"he{i}.xml") for i in range(3)]
    assert the.evaluate_heading_pages(gt, gt[::-1]) == pytest.approx(
        jhe.evaluate_heading_pages(gt, gt[::-1]), abs=1e-12)
