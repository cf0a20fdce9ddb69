"""The port's wave-pipelined workflow driver on the CPU.

- ``run_full_workflow_pipelined`` writes the files of the port's sequential
  ``run_full_workflow`` byte for byte (``LastChange`` normalised): 5 demo
  pages of 500 x 700 in groups of 2 (three groups and the flush), the
  converted nets at fixed heights 512 / 384, with the host tail in process
  and over 2 spawned workers; and the files of the JAX package's
  sequential driver on the same injected net outputs;
- the visual relation net through both drivers, byte-equal;
- the skip contract: a truncated PNG and a corrupt PAGE-XML are skipped as
  the sequential driver skips them, with and without the worker pool, and
  ``fault_tolerant=False`` raises;
- the command line's ``--pipelined`` / ``--host_workers``; the worker
  pool's log-and-skip contract; the async copies on CPU tensors; the image
  cache under threads.
"""
import os
import re
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from citlab_as_tpu_torch.cli import run_full_workflow as workflow  # noqa: E402
from citlab_as_tpu_torch.inference import (  # noqa: E402
    RelationPredictor, SegmentationPredictor,
)
from tests.torch_jax_native import jax_native  # noqa: F401  (fixture: the JAX native oracle)

NPZ = os.path.join(REPO, "models_ckpt_torch")
N_PAGES = 5
KW = dict(separator_fixed_height=512, heading_fixed_height=384, batch_size=2,
          device="cpu")


def _normalized(path):
    """The file's bytes with the wall-clock ``LastChange`` stamp removed."""
    with open(path, "rb") as f:
        return re.sub(rb"<LastChange>[^<]*</LastChange>", b"<LastChange/>", f.read())


def _demo_corpus(root, n=N_PAGES, seed=7):
    from scripts.bench_e2e import make_demo_page
    os.makedirs(root)
    rng = np.random.RandomState(seed)
    return [make_demo_page(root, f"p{i}", rng, w=500, h=700)[0] for i in range(n)]


def _assert_same_outputs(a, b, root_a, root_b, pages):
    """Same written page XMLs of the given pages and the same clustered
    XMLs (LastChange normalised)."""
    for i in pages:
        name = os.path.join("page", f"p{i}.xml.xml")
        assert _normalized(os.path.join(root_a, name)) == \
            _normalized(os.path.join(root_b, name)), name
    assert [os.path.basename(p) for p in a["clustered"]] == \
        [os.path.basename(p) for p in b["clustered"]]
    for pa, pb in zip(a["clustered"], b["clustered"]):
        assert _normalized(pa) == _normalized(pb), pb


@pytest.fixture(scope="module")
def nets():
    return dict(
        separator_predictor=SegmentationPredictor(
            os.path.join(NPZ, "separator.npz"), dtype=torch.float32, device="cpu"),
        heading_predictor=SegmentationPredictor(
            os.path.join(NPZ, "heading.npz"), dtype=torch.float32, device="cpu"),
        gnn_predictor=RelationPredictor(os.path.join(NPZ, "gnn.npz"), device="cpu"))


@pytest.fixture(scope="module")
def sequential_run(tmp_path_factory, nets):
    root = str(tmp_path_factory.mktemp("seq") / "c")
    images = _demo_corpus(root)
    result = workflow.run_full_workflow(images, out_dir=os.path.join(root, "out"),
                                        **nets, **KW)
    assert result["skipped"] == [] and len(result["clustered"]) == N_PAGES
    return root, result


PIPELINED_KEYS = {"separator_materialize", "dispatch", "separator_drain",
                  "heading_dispatch", "heading_drain", "heading_finish",
                  "gnn_dispatch", "gnn_materialize", "gnn_clustering",
                  "separator_drain.contours", "separator_drain.write", "total"}


@pytest.mark.parametrize("host_workers", [0, 2])
def test_pipelined_matches_sequential(tmp_path, nets, sequential_run, host_workers):
    seq_root, seq = sequential_run
    root = str(tmp_path / "c")
    images = _demo_corpus(root)
    res = workflow.run_full_workflow_pipelined(
        images, out_dir=os.path.join(root, "out"), host_workers=host_workers,
        **nets, **KW)
    assert res["skipped"] == [] and len(res["clustered"]) == N_PAGES
    _assert_same_outputs(seq, res, seq_root, root, range(N_PAGES))
    host_keys = ({"host_chain"} if host_workers > 1 else
                 {"baseline_clustering", "textregion", "features"})
    assert set(res["timings"]) == PIPELINED_KEYS | host_keys
    assert res["timings"]["total"] > 0


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
def test_pipelined_matches_jax_sequential_with_injected_nets(tmp_path, monkeypatch):
    """Same net outputs (numpy predictors) and the trained relation GNN:
    the port's pipelined driver writes every file the JAX package's
    sequential driver writes, byte for byte (clock frozen on both sides)."""
    from citlab_as_tpu.cli.run_full_workflow import run_full_workflow as jrun
    from citlab_as_tpu.inference import RelationPredictor as JRel
    from citlab_as_tpu.pagexml import page as jpage
    from citlab_as_tpu_torch.pagexml import page as tpage
    from tests.test_torch_workflow import _corpus, _same_tree
    monkeypatch.setattr(jpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    images = _corpus(jroot, seeds=(3, 11, 5))
    shutil.copytree(jroot, troot)
    kw = dict(separator_predictor=_separator_fn, heading_predictor=_benign_fn,
              batch_size=2, clustering_method="dbscan")
    jres = jrun([os.path.join(jroot, os.path.basename(i)) for i in images],
                out_dir=os.path.join(jroot, "out"),
                gnn_predictor=JRel(os.path.join(REPO, "models_ckpt", "gnn", "best", "f1")),
                **kw)
    tres = workflow.run_full_workflow_pipelined(
        [os.path.join(troot, os.path.basename(i)) for i in images],
        out_dir=os.path.join(troot, "out"), device="cpu",
        gnn_predictor=RelationPredictor(os.path.join(NPZ, "gnn.npz"), device="cpu"), **kw)
    assert jres["skipped"] == tres["skipped"] == []
    assert len(tres["clustered"]) == len(images)
    files = _same_tree(jroot, troot)
    assert sum(f.endswith("_clustering.xml") for f in files) == len(images)


def test_visual_net_through_both_drivers(tmp_path):
    """The converted visual relation net (ARU_cutted backbone, page images
    at 288 / 384): the pipelined driver writes the sequential driver's
    feature JSONs (with the regions' polygons) and clustered files."""
    from citlab_as_tpu_torch.pagexml import Page
    visual = RelationPredictor(os.path.join(NPZ, "gnn_visual.npz"), device="cpu",
                               image_input=True, visual_backbone="ARU_cutted_v1",
                               image_min_dimension=288, image_max_dimension=384)
    kw = dict(separator_predictor=_separator_fn, heading_predictor=_benign_fn,
              gnn_predictor=visual, **KW)
    runs = {}
    for name, run in (("seq", workflow.run_full_workflow),
                      ("pipe", workflow.run_full_workflow_pipelined)):
        root = str(tmp_path / name)
        images = _demo_corpus(root, n=3, seed=3)
        runs[name] = (root, run(images, out_dir=os.path.join(root, "out"), **kw))
    (seq_root, seq), (pipe_root, pipe) = runs["seq"], runs["pipe"]
    assert seq["skipped"] == pipe["skipped"] == [] and len(pipe["clustered"]) == 3
    _assert_same_outputs(seq, pipe, seq_root, pipe_root, range(3))
    jsons = sorted(os.path.relpath(os.path.join(d, f), seq_root)
                   for d, _, fs in os.walk(seq_root) for f in fs if f.endswith(".json"))
    assert len(jsons) == 3 and all("v" in os.path.dirname(j) for j in jsons)
    for j in jsons:
        assert _normalized(os.path.join(seq_root, j)) == _normalized(os.path.join(pipe_root, j))
    for path in pipe["clustered"]:
        lines = Page(path).get_textlines()
        assert lines and all(tl.get_article_id() for tl in lines)


def test_pipelined_matches_sequential_on_split_lines_with_empty_text(tmp_path):
    """Text lines with empty text that the separator writer splits at a
    vertical rule: its new lines' empty text is written ``<Unicode></Unicode>``
    and parsed back as nothing, so the later stages must see the parsed
    file, as in the sequential driver, not the writer's own DOM."""
    from citlab_as_tpu_torch.pagexml import Page
    gnn = RelationPredictor(os.path.join(NPZ, "gnn.npz"), device="cpu")
    kw = dict(separator_predictor=_separator_fn, heading_predictor=_benign_fn,
              gnn_predictor=gnn, **KW)
    runs = {}
    for name, run in (("seq", workflow.run_full_workflow),
                      ("pipe", workflow.run_full_workflow_pipelined)):
        root = str(tmp_path / name)
        images = _demo_corpus(root, n=2, seed=1)
        for i in range(2):
            path = os.path.join(root, "page", f"p{i}.xml")
            with open(path) as f:
                xml = re.sub(r"<Unicode>[^<]*</Unicode>", "<Unicode></Unicode>", f.read())
            with open(path, "w") as f:
                f.write(xml)
        runs[name] = (root, run(images, out_dir=os.path.join(root, "out"), **kw))
    (seq_root, seq), (pipe_root, pipe) = runs["seq"], runs["pipe"]
    before = len(Page(os.path.join(seq_root, "page", "p0.xml")).get_textlines())
    after = len(Page(os.path.join(seq_root, "page", "p0.xml.xml")).get_textlines())
    assert after > before, "no line was split"
    _assert_same_outputs(seq, pipe, seq_root, pipe_root, range(2))


def _broken_corpus(root):
    """Five demo pages; page 1's PNG truncated, page 3's PAGE-XML corrupt."""
    images = _demo_corpus(root)
    with open(images[1], "rb") as f:
        data = f.read()
    with open(images[1], "wb") as f:
        f.write(data[:len(data) // 3])
    with open(os.path.join(root, "page", "p3.xml"), "w") as f:
        f.write("<PcGts><Page imageFilename=")
    return images


@pytest.mark.parametrize("host_workers", [0, 2])
def test_pipelined_skip_contract(tmp_path, host_workers):
    gnn = RelationPredictor(os.path.join(NPZ, "gnn.npz"), device="cpu")
    kw = dict(separator_predictor=_separator_fn, heading_predictor=_benign_fn,
              gnn_predictor=gnn, **KW)
    seq_root, pipe_root = str(tmp_path / "seq"), str(tmp_path / "pipe")
    seq = workflow.run_full_workflow(_broken_corpus(seq_root),
                                     out_dir=os.path.join(seq_root, "out"), **kw)
    images = _broken_corpus(pipe_root)
    pipe = workflow.run_full_workflow_pipelined(
        images, out_dir=os.path.join(pipe_root, "out"), host_workers=host_workers, **kw)
    assert [s["page"] for s in pipe["skipped"]] == [images[1], images[3]]
    assert [os.path.basename(s["page"]) for s in seq["skipped"]] == \
        [os.path.basename(s["page"]) for s in pipe["skipped"]]
    assert [s["stage"] for s in pipe["skipped"]] == ["load", "separator"]
    assert len(pipe["clustered"]) == 3
    _assert_same_outputs(seq, pipe, seq_root, pipe_root, (0, 2, 4))
    with pytest.raises(Exception):
        workflow.run_full_workflow_pipelined(
            _broken_corpus(str(tmp_path / "strict")), fault_tolerant=False,
            host_workers=host_workers, **kw)


def test_cli_pipelined_flags(monkeypatch, tmp_path):
    """``--pipelined --host_workers N`` reaches the pipelined driver, and
    the reported total is its wall clock, not the sum of its parts."""
    seen = {}

    def fake(image_paths, *args, **kwargs):
        seen.update(kwargs, images=image_paths)
        return {"pages": [], "clustered": [], "skipped": [],
                "timings": {"dispatch": 1.0, "total": 2.0}}
    monkeypatch.setattr(workflow, "run_full_workflow_pipelined", fake)
    image_list = tmp_path / "images.lst"
    image_list.write_text("a.png\nb.png\n")
    result = workflow.main(["--path_to_image_list", str(image_list), "--pipelined",
                            "--host_workers", "3", "--device", "cpu"])
    assert seen["host_workers"] == 3 and seen["device"] == "cpu"
    assert seen["images"] == ["a.png", "b.png"]
    assert result["timings"]["total"] == 2.0


def test_persistent_pool_skips_failing_items(tmp_path):
    """The host chain in spawned workers: a page that cannot be read is
    skipped and reported, the pool survives for the next call."""
    from citlab_as_tpu_torch.stages.host_chain import host_chain_builder
    from citlab_as_tpu_torch.utils.workers import PersistentPool, run_sharded, split_list
    assert split_list(list(range(7)), 3) == [[0, 1, 2], [3, 4], [5, 6]]
    assert split_list([1], 4) == [[1]]
    missing = {"page_path": str(tmp_path / "page" / "nope.xml"),
               "image_path": str(tmp_path / "nope.png"), "visual": False,
               "line_features": None}
    with PersistentPool(host_chain_builder, 2) as pool:
        for _ in range(2):
            done, skipped = pool.map_items([missing, dict(missing)])
            assert done == [] and len(skipped) == 2
    done, skipped = run_sharded(host_chain_builder, [missing])
    assert done == [] and skipped == [missing]


def test_async_copies_on_cpu_tensors():
    from citlab_as_tpu_torch.utils.async_copy import HostCopy, prefetch, to_numpy, upload
    pages = [np.full((3, 4), i, np.uint8) for i in range(2)]
    batch = upload(pages, torch.device("cpu"))
    assert batch.dtype == torch.uint8 and np.array_equal(batch.numpy(), np.stack(pages))
    copy = prefetch(batch * 2)
    assert isinstance(copy, HostCopy) and copy.event is None
    assert np.array_equal(to_numpy(copy), np.stack(pages) * 2)
    assert np.array_equal(to_numpy(batch), np.stack(pages))


def test_image_cache_under_threads(tmp_path):
    """More threads than cache slots load overlapping images with a short
    switch interval: every load returns the right pixels and the cache
    stays within its bound."""
    from citlab_as_tpu_torch.utils import io as port_io
    paths = []
    for i in range(port_io._IMAGE_CACHE_MAX + 8):
        path = str(tmp_path / f"i{i}.png")
        port_io.save_png(path, np.full((5, 7), i, np.uint8))
        paths.append(path)
    errors = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(200):
                i = int(rng.randint(len(paths)))
                assert int(port_io.load_image(paths[i])[0, 0]) == i
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(port_io._IMAGE_CACHE) <= port_io._IMAGE_CACHE_MAX
