"""The port's later stages and its workflow driver against the JAX package,
on the CPU, with the clock frozen on both sides.

- ``cluster_page``, ``generate_text_regions_for_page``,
  ``generate_feature_jsons`` (both separator modes, both interactions,
  visual-region keys, the heading stage's precomputed line features) and
  ``gnn_clustering_for_page`` (all four methods), ``gnn_clustering_for_pages``
  and ``conf_to_cluster`` write byte-equal files;
- ``TextblockClustering`` labels are equal for every method, and the port's
  DBSCAN and silhouette equal sklearn's;
- ``run_full_workflow`` with injected net outputs writes byte-equal
  clustered PAGE-XML; with the three converted checkpoints it reaches AS
  F1 > 0.98 on the demo page (the JAX package's AS measure); its command
  line runs on the CPU; a truncated PNG lands in ``skipped`` while the
  other pages complete.
"""
import filecmp
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from citlab_as_tpu.pagexml import page as jpage
from citlab_as_tpu_torch.pagexml import page as tpage
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")


def _add_separators(page_path, w, h):
    """A vertical rule between the first two columns and a horizontal rule
    across the first column, as SeparatorRegions (the edge features' input)."""
    with open(page_path) as f:
        xml = f.read()
    x = w // 3 if "d1" in page_path else w // 2
    seps = (f'    <SeparatorRegion id="sr_v"><Coords points="{x - 2},40 {x + 2},40 '
            f'{x + 2},{h - 40} {x - 2},{h - 40}"/></SeparatorRegion>\n'
            f'    <SeparatorRegion id="sr_h"><Coords points="30,700 {x - 30},700 '
            f'{x - 30},703 30,703"/></SeparatorRegion>\n  </Page>')
    with open(page_path, "w") as f:
        f.write(xml.replace("  </Page>", seps))


def _corpus(root, seeds=(3, 11)):
    """Demo pages (scripts/bench_e2e.py): 2-3 columns of about 20 lines,
    one TextRegion, plus two SeparatorRegions each."""
    from scripts.bench_e2e import make_demo_page
    os.makedirs(root, exist_ok=True)
    images = []
    for i, seed in enumerate(seeds):
        img, _ = make_demo_page(root, f"d{i}", np.random.RandomState(seed))
        _add_separators(os.path.join(root, "page", f"d{i}.xml"), 1000, 1500)
        images.append(img)
    return images


def _pages(root, n):
    return [os.path.join(root, "page", f"d{i}.xml") for i in range(n)]


def _same_tree(a, b):
    """Every file under a equals the same file under b, byte for byte."""
    files = []
    for dirpath, _, names in os.walk(a):
        for n in names:
            rel = os.path.relpath(os.path.join(dirpath, n), a)
            files.append(rel)
            assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                               shallow=False), rel
    assert files
    return files


# a tight neighbourhood rule, so the pages split into several articles per
# column (more regions, more graph nodes)
TIGHT = dict(rectangle_interline_factor=0.6, min_polygons_for_cluster=3)


@pytest.fixture(scope="module")
def regioned(tmp_path_factory):
    """The corpus after the JAX package's baseline clustering and text
    regions: the input of the feature and GNN stages."""
    from citlab_as_tpu.stages.baseline_clustering import cluster_page
    from citlab_as_tpu.stages.textregion import generate_text_regions_for_page
    root = str(tmp_path_factory.mktemp("regioned"))
    images = _corpus(root)
    for p in _pages(root, len(images)):
        cluster_page(p, **TIGHT)
        generate_text_regions_for_page(p)
    return root, images


@pytest.mark.usefixtures("jax_native")
def test_cluster_page_and_text_regions_byte_equal(tmp_path):
    from citlab_as_tpu.stages import baseline_clustering as jbc
    from citlab_as_tpu.stages import textregion as jtr
    from citlab_as_tpu_torch.stages import baseline_clustering as tbc
    from citlab_as_tpu_torch.stages import textregion as ttr
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    n = len(_corpus(jroot, seeds=(3, 11, 7)))
    shutil.copytree(jroot, troot)
    for jp, tp in zip(_pages(jroot, n), _pages(troot, n)):
        assert tbc.cluster_page(tp, **TIGHT) == jbc.cluster_page(jp, **TIGHT)
        assert filecmp.cmp(jp, tp, shallow=False)
        tregions = ttr.generate_text_regions_for_page(tp)
        jregions = jtr.generate_text_regions_for_page(jp)
        assert [(k, v[0], [tl.id for tl in v[1]], v[2]) for k, v in tregions.items()] == \
            [(k, v[0], [tl.id for tl in v[1]], v[2]) for k, v in jregions.items()]
        assert len(tregions) > 2
        assert filecmp.cmp(jp, tp, shallow=False)
        # the list path (Polygon objects) gives the same regions
        art, lines = ttr.get_data_from_pagexml(tp)
        assert [v[0] for v in ttr.create_text_regions(art, lines).values()] == \
            [v[0] for v in tregions.values()]


def test_text_regions_move_line_nodes_without_duplicates(tmp_path):
    """The rebuilt regions hold every line node once, with its words and
    text, and the region rebuild from objects writes the same bytes."""
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages import textregion as ttr
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
    root = str(tmp_path / "c")
    _corpus(root, seeds=(5,))
    page_path = _pages(root, 1)[0]
    cluster_page(page_path)
    copy = page_path + ".copy.xml"
    shutil.copy(page_path, copy)
    regions = ttr._create_regions_fast(page_path, 50, 100, 75)
    ttr.save_results_in_pagexml(page_path, regions)
    regions_copy = ttr._create_regions_fast(copy, 50, 100, 75)
    ttr.save_results_in_pagexml(copy, regions_copy, reuse_line_nodes=False)
    assert open(page_path, "rb").read() == open(copy, "rb").read()
    page = Page(page_path)
    ids = [nd.get("id") for nd in page.get_child_by_name(page.page_doc, "TextLine")]
    assert len(ids) == len(set(ids)) == sum(len(v[1]) for v in regions.values())


def _headline_page(root, spacing=24, w=710, h=1000):
    """A page in the layout of chip_smoke's newspaper pages: four
    sub-columns of one line per text band, and a headline three bands tall
    across the left two, right under the first line of each."""
    text_h = spacing * 3 // 5
    columns = [(10, 170), (176, 340), (350, 520), (526, 700)]
    headline = range(2, 5)

    def line(line_id, x0, y0, x1, y1):
        return (f'<TextLine id="{line_id}"><Coords points="{x0},{y0} {x1},{y0} '
                f'{x1},{y1} {x0},{y1}"/><Baseline points="{x0},{y1 - 2} {x1},{y1 - 2}"/>'
                f'<TextEquiv><Unicode>{line_id}</Unicode></TextEquiv></TextLine>')

    def region(region_id, lines):
        x0 = min(b[1] for b in lines)
        y0 = min(b[2] for b in lines)
        x1 = max(b[3] for b in lines)
        y1 = max(b[4] for b in lines)
        return (f'<TextRegion id="{region_id}"><Coords points="{x0},{y0} {x1},{y0} '
                f'{x1},{y1} {x0},{y1}"/>' + "".join(line(*b) for b in lines)
                + "</TextRegion>")

    hl_y1 = (headline[-1] + 1) * spacing - (spacing - text_h)
    regions = [region("r_hl", [("hl", 10, headline[0] * spacing, 340, hl_y1)])]
    for c, (x0, x1) in enumerate(columns):
        regions.append(region(f"r_col_{c}", [
            (f"c{c}_l{b}", x0, b * spacing, x1, b * spacing + text_h)
            for b in range(1, (h - 16) // spacing) if c >= 2 or b not in headline]))
    os.makedirs(os.path.join(root, "page"))
    path = os.path.join(root, "page", "hl.xml")
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n<PcGts xmlns="'
                'http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15">'
                '<Metadata><Creator>test</Creator><Created>x</Created>'
                '<LastChange>x</LastChange></Metadata>'
                f'<Page imageFilename="hl.png" imageWidth="{w}" imageHeight="{h}">'
                + "".join(regions) + "</Page></PcGts>\n")
    return path


@pytest.mark.usefixtures("jax_native")
def test_text_regions_above_the_page_edge(tmp_path):
    """The first line of a sub-column with a headline right under it: its
    interline distance reaches past the headline, the text-region rule
    shifts it up by 0.95 of that, and the region's top lands above the
    page edge. The JAX package writes the same negative y as the port; the
    file is structurally valid once only those y values are clamped to 0
    (chip_smoke's gate on the clustered pages)."""
    import re
    from chip_smoke import structurally_valid
    from citlab_as_tpu.stages.baseline_clustering import cluster_page as jcluster
    from citlab_as_tpu.stages.textregion import generate_text_regions_for_page as jregions
    from citlab_as_tpu_torch.pagexml import Page
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page as tcluster
    from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page as tregions
    jp = _headline_page(str(tmp_path / "j"))
    tp = _headline_page(str(tmp_path / "t"))
    jcluster(jp)
    tcluster(tp)
    jregions(jp)
    tregions(tp)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    region_points = re.findall(r'<TextRegion[^>]*>\s*<Coords points="([^"]*)"',
                               open(tp).read())
    ys = [int(p.split(",")[1]) for pts in region_points for p in pts.split()]
    xs = [int(p.split(",")[0]) for pts in region_points for p in pts.split()]
    assert min(ys) < 0 <= min(xs)
    page = Page(tp)
    assert not Page.validate_structural(page.page_doc)
    assert structurally_valid(page) == (True, True)
    # a negative x is not clamped: the file stays invalid
    with open(tp) as f:
        xml = f.read()
    with open(tp, "w") as f:
        f.write(xml.replace(f'points="{region_points[0]}"',
                            f'points="-1,{ys[0]} {region_points[0]}"', 1))
    assert structurally_valid(Page(tp)) == (False, True)


FEATURE_OPTIONS = [("delaunay", "bb", False), ("fully", "line", True),
                   ("delaunay", "line", True)]


@pytest.mark.parametrize("interaction,separators,visual", FEATURE_OPTIONS)
def test_feature_jsons_byte_equal(tmp_path, regioned, interaction, separators, visual):
    from citlab_as_tpu.stages.features import generate_feature_jsons as jgen
    from citlab_as_tpu_torch.stages.features import generate_feature_jsons as tgen
    src, images = regioned
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(src, jroot)
    shutil.copytree(src, troot)
    n = len(images)
    kw = dict(interaction=interaction, separators=separators, visual_regions=visual)
    jpaths = jgen(_pages(jroot, n), image_paths=[os.path.join(jroot, os.path.basename(i))
                                                 for i in images], **kw)
    tpaths = tgen(_pages(troot, n), image_paths=[os.path.join(troot, os.path.basename(i))
                                                 for i in images], **kw)
    assert [os.path.relpath(p, jroot) for p in jpaths] == \
        [os.path.relpath(p, troot) for p in tpaths]
    for jp, tp in zip(jpaths, tpaths):
        assert open(jp, "rb").read() == open(tp, "rb").read()
    graph = json.load(open(tpaths[0]))
    assert graph["num_nodes"] >= 4 and len(graph["node_features"][0]) == 15
    assert any(f != [0.0, 0.0] for f in graph["edge_features"])
    assert ("visual_regions_nodes" in graph) == visual


def test_feature_jsons_reuse_precomputed_line_features(tmp_path, regioned):
    """The heading stage's per-line (bbox, stroke width, text height),
    reused: no image is read, and both packages write the same JSON."""
    from citlab_as_tpu.pagexml import Page as JPage
    from citlab_as_tpu.stages.features import generate_feature_jsons as jgen
    from citlab_as_tpu_torch.stages.features import generate_feature_jsons as tgen
    src, images = regioned
    root = str(tmp_path / "r")
    shutil.copytree(src, root)
    pages = _pages(root, len(images))
    line_features = {}
    for p in pages:
        feats = {}
        for i, tl in enumerate(JPage(p).textlines):
            xs = [q[0] for q in tl.surr_p.points_list]
            ys = [q[1] for q in tl.surr_p.points_list]
            feats[tl.id] = ((min(xs), min(ys), max(xs) - min(xs) + 1,
                             max(ys) - min(ys) + 1), 2.0 + i % 3, 20 + i % 5)
        line_features[p] = feats
    for f in images:        # a read of an image would now fail
        os.remove(os.path.join(root, os.path.basename(f)))
    jpaths = jgen(pages, out_path=os.path.join(root, "j"), line_features=line_features)
    tpaths = tgen(pages, out_path=os.path.join(root, "t"), line_features=line_features)
    for jp, tp in zip(jpaths, tpaths):
        assert open(jp, "rb").read() == open(tp, "rb").read()


def _conf_fn(graph):
    """Deterministic numpy confidences from the node features: regions
    whose centres lie in one column (same x to 0.05) belong together."""
    feats = np.asarray(graph["node_features"])
    cx = feats[:, 2]
    same = np.abs(cx[:, None] - cx[None, :]) < 0.05
    rng = np.random.RandomState(graph["num_nodes"])
    return np.where(same, 0.9, 0.1) + rng.uniform(-0.05, 0.05, same.shape)


@pytest.mark.parametrize("method", ("greedy", "dbscan", "dbscan_std", "linkage"))
def test_gnn_clustering_for_page_byte_equal(tmp_path, regioned, method, monkeypatch):
    from citlab_as_tpu.stages.features import generate_feature_jsons
    from citlab_as_tpu.stages.gnn_io import gnn_clustering_for_page as jclu
    from citlab_as_tpu_torch.stages.gnn_io import gnn_clustering_for_page as tclu
    from citlab_as_tpu_torch.stages.gnn_io import load_conf_from_json
    src, images = regioned
    # page paths relative to the working directory: the clustering and
    # confidence files go to <side>/clustering and <side>/confidences
    monkeypatch.chdir(tmp_path)
    for side, clu in (("j", jclu), ("t", tclu)):
        shutil.copytree(src, side)
        pages = _pages(side, len(images))
        jsons = generate_feature_jsons(
            pages, visual_regions=False, separators="bb",
            image_paths=[os.path.join(side, os.path.basename(i)) for i in images])
        for json_path, page_path in zip(jsons, pages):
            clu(json_path, _conf_fn, clustering_method=method, save_conf=True,
                page_path=page_path, out_dir="",
                mask_horizontally_separated=True, mask_heading_separated=True)
    files = _same_tree("j", "t")
    assert sum(f.endswith("_clustering.xml") for f in files) == len(images)
    conf = [f for f in files if f.endswith("_confidences.json")]
    assert len(conf) == len(images)
    assert load_conf_from_json(os.path.join("t", conf[0])).ndim == 2


def test_group_clustering_and_reclustering_byte_equal(tmp_path, regioned, monkeypatch):
    """``gnn_clustering_for_pages`` (one call for the page group) and
    ``conf_to_cluster`` (re-clustering from saved confidence JSONs, without
    the net) write the same files in both packages."""
    from citlab_as_tpu.stages import gnn_io as jio
    from citlab_as_tpu.stages.features import generate_feature_jsons
    from citlab_as_tpu_torch.stages import gnn_io as tio
    src, images = regioned
    monkeypatch.chdir(tmp_path)
    for side, io in (("j", jio), ("t", tio)):
        shutil.copytree(src, side)
        pages = _pages(side, len(images))
        jsons = generate_feature_jsons(
            pages, visual_regions=False, separators="bb",
            image_paths=[os.path.join(side, os.path.basename(i)) for i in images])
        written = io.gnn_clustering_for_pages(jsons, _conf_fn, clustering_method="dbscan",
                                              page_paths=pages)
        assert len(written) == len(images)
        confs = []
        for json_path, page_path in zip(jsons, pages):
            with open(json_path) as f:
                confs.append(io.save_conf_to_json(_conf_fn(json.load(f)), page_path, ""))
        assert len(io.conf_to_cluster(confs, clustering_method="greedy")) == len(images)
    files = _same_tree("j", "t")
    assert sum(f.endswith("_clustering.xml") for f in files) == 2 * len(images)


LINKAGE = [("linkage", {}), ("linkage", {"t": "silhouette", "method": "average"}),
           ("linkage", {"t": "merge", "method": "average"})]


@pytest.mark.parametrize("method,params", [("greedy", {}), ("dbscan", {}),
                                           ("dbscan_std", {"epsilon": 0.4})] + LINKAGE)
def test_textblock_clustering_labels_equal(method, params):
    from citlab_as_tpu.stages.clustering import TextblockClustering as J
    from citlab_as_tpu_torch.stages.clustering import TextblockClustering as T
    for seed in range(6):
        rng = np.random.RandomState(seed)
        n = rng.randint(2, 25)
        groups = rng.randint(0, max(1, n // 4), n)
        conf = np.where(groups[:, None] == groups[None, :], 0.85, 0.15)
        conf = np.clip(conf + rng.uniform(-0.3, 0.3, (n, n)), 0, 1)
        j, t = J(params), T(params)
        j.set_confs(conf)
        t.set_confs(conf)
        j.calc(method)
        t.calc(method)
        assert list(np.asarray(t.tb_labels)) == list(np.asarray(j.tb_labels))
        assert t.tb_classes == j.tb_classes and t.rel_LLH == j.rel_LLH


def test_dbscan_and_silhouette_equal_sklearn():
    from sklearn.cluster import dbscan
    from sklearn.metrics import silhouette_score
    from citlab_as_tpu_torch.stages.clustering import (
        dbscan_precomputed, silhouette_score_precomputed)
    for seed in range(20):
        rng = np.random.RandomState(seed)
        n = rng.randint(3, 40)
        c = rng.rand(n, n)
        d = -np.log(np.sqrt(c * c.T))
        np.fill_diagonal(d, 0.0)
        eps, min_samples = rng.uniform(0.1, 2.0), rng.randint(1, 4)
        assert np.array_equal(dbscan_precomputed(d, eps, min_samples),
                              dbscan(d, metric="precomputed", eps=eps,
                                     min_samples=min_samples)[1])
        labels = rng.randint(0, rng.randint(2, n), n)
        try:
            want = silhouette_score(d, labels, metric="precomputed")
        except ValueError:
            with pytest.raises(ValueError):
                silhouette_score_precomputed(d, labels)
            continue
        assert silhouette_score_precomputed(d, labels) == want


def _separator_fn(image_grey):
    """Net output stand-in: a vertical rule at the page centre."""
    h, w = image_grey.shape
    prob = np.zeros((h, w, 2), np.float32)
    prob[10:h - 10, w // 2 - 2:w // 2 + 2, 0] = 0.9
    prob[..., 1] = 1.0 - prob[..., 0]
    return prob


def _benign_fn(image_grey):
    h, w = image_grey.shape
    prob = np.zeros((h, w, 2), np.float32)
    prob[..., 1] = 1.0
    return prob


@pytest.mark.usefixtures("jax_native")
def test_run_full_workflow_byte_equal_with_injected_nets(tmp_path):
    """Both drivers with the same net outputs (numpy predictors) and the
    trained relation GNN (flax checkpoint / converted npz): every written
    file equal, every line with an article id."""
    from citlab_as_tpu.cli.run_full_workflow import run_full_workflow as jrun
    from citlab_as_tpu.inference import RelationPredictor as JRel
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow as trun
    from citlab_as_tpu_torch.inference import RelationPredictor as TRel
    from citlab_as_tpu_torch.pagexml import Page
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    images = _corpus(jroot)
    shutil.copytree(jroot, troot)
    kw = dict(separator_predictor=_separator_fn, heading_predictor=_benign_fn,
              batch_size=2, clustering_method="dbscan")
    jres = jrun([os.path.join(jroot, os.path.basename(i)) for i in images],
                out_dir=os.path.join(jroot, "out"),
                gnn_predictor=JRel(os.path.join(REPO, "models_ckpt", "gnn", "best", "f1")),
                **kw)
    tres = trun([os.path.join(troot, os.path.basename(i)) for i in images],
                out_dir=os.path.join(troot, "out"), device="cpu",
                gnn_predictor=TRel(os.path.join(REPO, "models_ckpt_torch", "gnn.npz"),
                                   device="cpu"),
                **kw)
    assert jres["skipped"] == tres["skipped"] == []
    assert set(tres["timings"]) == set(jres["timings"])
    assert len(tres["clustered"]) == len(images)
    files = _same_tree(jroot, troot)
    assert sum(f.endswith("_clustering.xml") for f in files) == len(images)
    for path in tres["clustered"]:
        lines = Page(path).get_textlines()
        assert lines and all(tl.get_article_id() for tl in lines)


@pytest.mark.usefixtures("jax_native")
def test_converted_checkpoints_reach_article_f1(tmp_path):
    """The port with the converted separator, heading and gnn checkpoints
    on the demo page of tests/test_trained_models.py (RandomState(11)), one
    article per column, by the JAX package's AS measure."""
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu.cli.run_measure import main as measure_main
    from citlab_as_tpu.pagexml import Page
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    work = str(tmp_path)
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
    gt_lst, hy_lst = os.path.join(work, "gt.lst"), os.path.join(work, "hy.lst")
    open(gt_lst, "w").write(gt_path + "\n")
    open(hy_lst, "w").write(result["clustered"][0] + "\n")
    out = measure_main(["--path_to_gt_xml_lst", gt_lst, "--path_to_hy_xml_lst", hy_lst,
                        "--min_tol", "10", "--max_tol", "30"])
    as_r, as_p, as_f = out["as"]
    assert as_f > 0.98, f"AS F1 {as_f} too low (R={as_r}, P={as_p})"


def test_cli_main_runs_the_workflow(tmp_path):
    """The port's command line on the CPU: an image list, the three
    converted nets and a clustering-parameter override (parsed as the JAX
    package parses it)."""
    from citlab_as_tpu.config.flags import parse_dict_flag as jparse
    from citlab_as_tpu_torch.cli.run_full_workflow import main
    from citlab_as_tpu_torch.config.flags import parse_dict_flag
    from citlab_as_tpu_torch.pagexml import Page
    for spec in ("confidence_threshold=0.6", "t=silhouette, method=average,max_clusters=7",
                 "assign_noise_clusters=f,epsilon=1e-3,ids=[4]"):
        assert parse_dict_flag(spec) == jparse(spec)
    root = str(tmp_path / "c")
    images = _corpus(root, seeds=(11,))
    image_list = os.path.join(root, "images.lst")
    with open(image_list, "w") as f:
        f.write("\n".join(images) + "\n")
    npz = os.path.join(REPO, "models_ckpt_torch")
    result = main(["--path_to_image_list", image_list,
                   "--separator_model", os.path.join(npz, "separator.npz"),
                   "--heading_model", os.path.join(npz, "heading.npz"),
                   "--gnn_model", os.path.join(npz, "gnn.npz"), "--device", "cpu",
                   "--clustering_params", "confidence_threshold=0.6"])
    assert result["skipped"] == [] and len(result["clustered"]) == 1
    assert os.sep + "dbscan_conf0.6_cluster0.5" + os.sep in result["clustered"][0]
    lines = Page(result["clustered"][0]).get_textlines()
    assert lines and all(tl.get_article_id() for tl in lines)


def test_truncated_png_is_skipped(tmp_path):
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.inference import RelationPredictor
    root = str(tmp_path / "c")
    images = _corpus(root, seeds=(3, 11, 5))
    with open(images[1], "rb") as f:
        data = f.read()
    with open(images[1], "wb") as f:
        f.write(data[:len(data) // 3])
    result = run_full_workflow(
        images, out_dir=os.path.join(root, "out"), device="cpu", batch_size=2,
        separator_predictor=_separator_fn, heading_predictor=_benign_fn,
        gnn_predictor=RelationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "gnn.npz"), device="cpu"))
    assert [s["page"] for s in result["skipped"]] == [images[1]]
    assert len(result["clustered"]) == 2
    assert all(os.path.exists(p) for p in result["clustered"])
