"""The port's per-stage command lines against the JAX package's, on the CPU,
chained in the workflow's order over a small corpus of a PNG, a JPEG and a
TIFF page, with the clock frozen on both sides:

run_net_post_processing (separator, then heading; injected net outputs)
-> run_baseline_clustering -> run_textregion_generation
-> run_feature_generation -> run_gnn_clustering (the converted relation
net against its flax checkpoint, confidences saved) -> run_conf_to_cluster.

After every stage each written file equals the JAX CLI's byte for byte,
except the saved confidences, which hold the two relation nets' floats at
full precision and agree within 1e-5 (both CLIs then re-cluster the same
confidence files).
Between the two net stages and after the heading stage, ``page/<name>.xml.xml``
is moved over ``page/<name>.xml`` on both sides, as a user chaining the
CLIs does. The JAX CLIs' orbax ``--model_dir`` flags, once refused by
name, reach the predictors.
"""
import filecmp
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from citlab_as_tpu.pagexml import page as jpage
from citlab_as_tpu_torch.pagexml import page as tpage
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")


def _separator_fn(image_grey):
    """Net output stand-in: a vertical rule at the page centre."""
    h, w = image_grey.shape
    prob = np.zeros((h, w, 2), np.float32)
    prob[10:h - 10, w // 2 - 2:w // 2 + 2, 0] = 0.9
    prob[..., 1] = 1.0 - prob[..., 0]
    return prob


def _heading_fn(image_grey):
    """Net output stand-in: the top tenth of the page is heading."""
    h, w = image_grey.shape
    prob = np.zeros((h, w, 2), np.float32)
    prob[:h // 10, :, 0] = 0.95
    prob[..., 1] = 1.0 - prob[..., 0]
    return prob


def _corpus(root):
    """Three demo pages (scripts/bench_e2e.py), the second as a JPEG and
    the third as an LZW TIFF."""
    from scripts.bench_e2e import make_demo_page
    os.makedirs(root)
    images = []
    for i, seed in enumerate((3, 11, 5)):
        png, _ = make_demo_page(root, f"d{i}", np.random.RandomState(seed))
        if i == 0:
            images.append(png)
            continue
        path = os.path.join(root, f"d{i}." + ("jpg" if i == 1 else "tif"))
        im = Image.open(png)
        if i == 1:
            im.save(path, format="JPEG", quality=90)
        else:
            im.save(path, format="TIFF", compression="tiff_lzw", predictor=2)
        os.remove(png)
        images.append(path)
    return images


def _same_files(a, b, rels):
    for rel in rels:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel


def _promote(root, n):
    """page/<name>.xml.xml -> page/<name>.xml: the next stage's input."""
    for i in range(n):
        page = os.path.join(root, "page", f"d{i}.xml")
        os.replace(page + ".xml", page)


def _write_list(root, name, lines):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.mark.usefixtures("jax_native")
@pytest.mark.parametrize("batch_size", [0, 2])
def test_stage_clis_write_the_jax_clis_files(tmp_path, monkeypatch, batch_size):
    import citlab_as_tpu.inference as jinf
    import citlab_as_tpu_torch.inference as tinf
    from citlab_as_tpu.cli import (run_baseline_clustering as jbc, run_conf_to_cluster as jcc,
                                   run_feature_generation as jfg, run_gnn_clustering as jgc,
                                   run_net_post_processing as jnp_,
                                   run_textregion_generation as jtr)
    from citlab_as_tpu_torch.cli import (run_baseline_clustering as tbc,
                                         run_conf_to_cluster as tcc,
                                         run_feature_generation as tfg,
                                         run_gnn_clustering as tgc,
                                         run_net_post_processing as tnp,
                                         run_textregion_generation as ttr)
    from citlab_as_tpu_torch.pagexml import Page
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    images = _corpus(jroot)
    shutil.copytree(jroot, troot)
    n = len(images)
    roots = {"j": jroot, "t": troot}
    lists = {k: _write_list(r, "images.lst", [os.path.join(r, os.path.basename(i))
                                              for i in images]) for k, r in roots.items()}
    pages = {k: [os.path.join(r, "page", f"d{i}.xml") for i in range(n)]
             for k, r in roots.items()}
    page_lists = {k: _write_list(r, "pages.lst", pages[k]) for k, r in roots.items()}
    xml_rels = [os.path.join("page", f"d{i}.xml") for i in range(n)]

    for mode, fn in (("separator", _separator_fn), ("heading", _heading_fn)):
        monkeypatch.setattr(jinf, "SegmentationPredictor", lambda *a, **k: fn)
        monkeypatch.setattr(tinf, "SegmentationPredictor", lambda *a, **k: fn)
        args = ["--mode", mode, "--batch_size", str(batch_size)]
        jnp_.main(["--path_to_image_list", lists["j"]] + args)
        tnp.main(["--path_to_image_list", lists["t"], "--device", "cpu"] + args)
        _same_files(jroot, troot, [r + ".xml" for r in xml_rels])
        for r in roots.values():
            _promote(r, n)
    assert all(Page(p).get_regions().get("SeparatorRegion") for p in pages["t"])

    jbc.main(["--path_to_xml_lst", page_lists["j"]])
    assert tbc.main(["--path_to_xml_lst", page_lists["t"]]) == []
    _same_files(jroot, troot, xml_rels)
    jtr.main(["--path_to_xml_lst", page_lists["j"]])
    assert ttr.main(["--path_to_xml_lst", page_lists["t"]]) == []
    _same_files(jroot, troot, xml_rels)

    for k, mod in (("j", jfg), ("t", tfg)):
        mod.main(["--pagexml_list", page_lists[k], "--out_path",
                  os.path.join(roots[k], "json")])
    jsons = sorted(os.listdir(os.path.join(troot, "json")))
    assert len(jsons) == n
    _same_files(jroot, troot, [os.path.join("json", j) for j in jsons])

    json_lists = {k: _write_list(r, "jsons.lst", [os.path.join(r, "json", j) for j in jsons])
                  for k, r in roots.items()}
    common = ["--clustering_method", "dbscan", "--save_conf",
              "--clustering_params", "confidence_threshold=0.6"]
    # the clustering pages and confidences land beside page/ under the
    # working directory (gnn_io.save_clustering_to_page / save_conf_to_json),
    # where run_conf_to_cluster finds each confidence file's page
    monkeypatch.chdir(jroot)
    jgc.main(["--eval_list", json_lists["j"], "--out_dir", "",
              "--model_dir", os.path.join(REPO, "models_ckpt", "gnn", "best", "f1")]
             + common)
    monkeypatch.chdir(troot)
    written = tgc.main(["--eval_list", json_lists["t"], "--out_dir", "", "--model",
                        os.path.join(REPO, "models_ckpt_torch", "gnn.npz"),
                        "--device", "cpu"] + common)
    assert len(written) == n
    out_rels = [os.path.relpath(os.path.join(d, f), troot)
                for d, _, names in os.walk(troot) for f in names
                if f.endswith(("_clustering.xml", "_confidences.json"))]
    assert sum(r.endswith("_clustering.xml") for r in out_rels) == n
    assert sum(r.endswith("_confidences.json") for r in out_rels) == n
    # the clustered pages byte for byte; the saved confidences (written at
    # full float precision) within 1e-5 of flax's, as the two nets sum in
    # another order
    _same_files(jroot, troot, [r for r in out_rels if r.endswith(".xml")])
    for rel in (r for r in out_rels if r.endswith(".json")):
        with open(os.path.join(jroot, rel)) as f:
            want = json.load(f)["confidences"]
        with open(os.path.join(troot, rel)) as f:
            got = json.load(f)["confidences"]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].keys() == want[key].keys()
            np.testing.assert_allclose([float(v) for v in got[key].values()],
                                       [float(v) for v in want[key].values()],
                                       rtol=0, atol=1e-5)
    for path in written:
        lines = Page(path).get_textlines()
        assert lines and all(tl.get_article_id() for tl in lines)

    # both re-cluster the port's confidence files
    for rel in (r for r in out_rels if r.endswith(".json")):
        shutil.copy(os.path.join(troot, rel), os.path.join(jroot, rel))
    confs = {k: _write_list(r, "confs.lst", sorted(
        os.path.join(r, rel) for rel in out_rels if rel.endswith("_confidences.json")))
        for k, r in roots.items()}
    for k, mod in (("j", jcc), ("t", tcc)):
        monkeypatch.chdir(roots[k])
        mod.main(["--conf_list", confs[k], "--clustering_method", "greedy",
                  "--out_dir", "re"])
    re_rels = [os.path.relpath(os.path.join(d, f), troot)
               for d, _, names in os.walk(troot) for f in names
               if f.endswith("_clustering.xml") and os.path.relpath(d, troot).startswith("re")]
    assert len(re_rels) == n
    _same_files(jroot, troot, re_rels)


@pytest.mark.parametrize("module,argv,flag", [
    # these orbax checkpoint directories were refused by name until the port
    # read the JAX package's orbax checkpoints (train/orbax.py); --sharded
    # runs since the mesh was ported
    pytest.param("run_net_post_processing",
                 ["--path_to_image_list", "x.lst", "--mode", "separator", "--sharded",
                  "--model_dir", "models_ckpt/separator", "--device", "cpu"], "--model_dir",
                 id="run_net_post_processing-argv0---sharded"),
    ("run_net_post_processing", ["--path_to_image_list", "x.lst", "--mode", "heading",
                                 "--model_dir", "models_ckpt/heading", "--device", "cpu"],
     "--model_dir"),
    # the id it had beside the two word-vector cases, which went with the
    # refusal they tested
    pytest.param("run_gnn_clustering", ["--eval_list", "x.lst", "--model_dir",
                                        "models_ckpt/gnn", "--device", "cpu"], "--model_dir",
                 id="run_gnn_clustering-argv4---model_dir"),
])
def test_unported_flags_raise_by_name(module, argv, flag, tmp_path, monkeypatch):
    """The JAX CLI's orbax ``--model_dir``, which raised by name until the
    port read orbax checkpoints, goes to the predictor, and the CLI goes on
    to its input list, whose one entry is missing."""
    import importlib
    import citlab_as_tpu_torch.inference as tinf
    main = importlib.import_module(f"citlab_as_tpu_torch.cli.{module}").main
    monkeypatch.chdir(tmp_path)
    os.symlink(os.path.join(REPO, "models_ckpt"), "models_ckpt")
    _write_list(str(tmp_path), "x.lst", ["x.png"])
    seen = []
    for name in ("SegmentationPredictor", "ShardedSegmentationPredictor", "RelationPredictor"):
        cls = getattr(tinf, name)
        monkeypatch.setattr(tinf, name, lambda path=None, *a, _cls=cls, **k:
                            seen.append(path) or _cls(path, *a, **k))
    try:
        main(argv)
    except FileNotFoundError as e:
        assert "x.png" in str(e)
    assert argv[argv.index(flag) + 1] in seen


def test_num_workers_fans_pages_over_processes(tmp_path):
    """--num_workers 2 through utils/workers.py writes the same pages as
    the in-process run (``LastChange`` normalised: the spawned workers run
    on the real clock)."""
    import re
    from citlab_as_tpu_torch.cli import run_baseline_clustering as tbc
    from citlab_as_tpu_torch.cli import run_textregion_generation as ttr
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _corpus(a)
    shutil.copytree(a, b)
    for root, workers in ((a, "0"), (b, "2")):
        lst = _write_list(root, "pages.lst", [os.path.join(root, "page", f"d{i}.xml")
                                               for i in range(3)])
        assert tbc.main(["--path_to_xml_lst", lst, "--num_workers", workers]) == []
        assert ttr.main(["--path_to_xml_lst", lst, "--num_workers", workers]) == []
    for i in range(3):
        texts = [re.sub(r"<LastChange>[^<]*</LastChange>", "",
                        open(os.path.join(r, "page", f"d{i}.xml")).read()) for r in (a, b)]
        assert texts[0] == texts[1]


@pytest.fixture(scope="module")
def frozen_nets(tmp_path_factory):
    """The converted separator, heading and pipeline relation nets as
    ``.frozen`` artifacts."""
    from citlab_as_tpu_torch.train.export import export_checkpoint_frozen
    out = tmp_path_factory.mktemp("frozen")
    npz = os.path.join(REPO, "models_ckpt_torch")
    return {net: export_checkpoint_frozen(os.path.join(npz, f"{src}.npz"),
                                          str(out / f"{net}.frozen"), arch)
            for net, src, arch in (("separator", "separator", "arunet"),
                                   ("heading", "heading", "arunet"),
                                   ("gnn", "gnn_pipeline", "graph_relation"))}


@pytest.mark.parametrize("pipelined", [False, True], ids=["sequential", "pipelined"])
def test_workflow_model_dir_flags_take_frozen_artifacts(tmp_path, frozen_nets, pipelined):
    """The JAX CLI's --separator_model_dir, --heading_model_dir and
    --gnn_model_dir: a .frozen through each runs the workflow, for either
    driver, to clustered pages whose lines all carry an article id."""
    from scripts.train_pipeline_gnn import make_article_page
    from citlab_as_tpu_torch.cli.run_full_workflow import main
    from citlab_as_tpu_torch.pagexml import Page
    root = str(tmp_path)
    img, _, _ = make_article_page(root, "p", np.random.RandomState(777), w=600, h=800)
    image_list = _write_list(root, "images.lst", [img])
    argv = ["--path_to_image_list", image_list, "--out_dir", os.path.join(root, "out"),
            "--device", "cpu"] + (["--pipelined"] if pipelined else [])
    for net in ("separator", "heading", "gnn"):
        argv += [f"--{net}_model_dir", frozen_nets[net]]
    result = main(argv)
    assert result["skipped"] == [] and len(result["clustered"]) == 1
    lines = Page(result["clustered"][0]).get_textlines()
    assert lines and all(tl.get_article_id() for tl in lines)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sequential", "pipelined"])
@pytest.mark.parametrize("net", ["separator", "heading", "gnn"])
def test_workflow_model_dir_flags_refuse_orbax_directories(tmp_path, net, pipelined,
                                                          monkeypatch):
    """An orbax checkpoint directory through a *_model_dir flag (refused by
    name before the port read orbax checkpoints) reaches the net's
    predictor, which loads it, and the workflow runs (its one page is
    missing and skipped); a pair given twice is still an error."""
    import citlab_as_tpu_torch.inference as tinf
    from citlab_as_tpu_torch.cli.run_full_workflow import main
    image_list = _write_list(str(tmp_path), "images.lst", ["x.png"])
    argv = ["--path_to_image_list", image_list, "--device", "cpu"] + (
        ["--pipelined"] if pipelined else [])
    orbax = {"separator": "models_ckpt/separator", "heading": "models_ckpt/heading",
             "gnn": "models_ckpt/gnn_pipeline/best/f1"}[net]
    seen = []
    for name in ("SegmentationPredictor", "RelationPredictor"):
        cls = getattr(tinf, name)
        monkeypatch.setattr(tinf, name, lambda path=None, *a, _cls=cls, **k:
                            seen.append(path) or _cls(path, *a, **k))
    monkeypatch.chdir(tmp_path)
    result = main(argv + [f"--{net}_model_dir", os.path.join(REPO, orbax)])
    assert os.path.join(REPO, orbax) in seen
    assert [s["page"] for s in result["skipped"]] == ["x.png"] and result["clustered"] == []
    with pytest.raises(ValueError, match=f"--{net}_model or --{net}_model_dir"):
        main(argv + [f"--{net}_model", "x.npz", f"--{net}_model_dir", "x.frozen"])