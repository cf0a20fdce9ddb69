"""Port-wide checks: the weight converter, import hygiene (no jax, flax,
citlab_as_tpu, sklearn, lxml, PIL, shapely, openpyxl, matplotlib, msgpack,
nltk, gensim, tensorflow or google inside the port or chip_smoke.py, and
no module of the port imports the repository's top-level ``scripts``, the
JAX side's; chip_smoke.py's imports of the fixture scripts stay allowed),
and device resolution."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "citlab_as_tpu_torch")
NETS = ("separator", "heading")
GNN_NETS = ("gnn", "gnn_pipeline")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "citlab_as_tpu",
             "sklearn", "lxml", "PIL", "shapely", "openpyxl", "matplotlib",
             "msgpack", "nltk", "gensim", "tensorflow", "google",
             "tensorstore", "zstandard", "zstd")


def _npz(net):
    return os.path.join(REPO, "models_ckpt_torch", f"{net}.npz")


@pytest.mark.parametrize("net", NETS)
def test_converter_reproduces_committed_npz(tmp_path, net):
    out = tmp_path / f"{net}.npz"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "convert_weights_to_torch.py"),
         "--model_dir", os.path.join(REPO, "models_ckpt", net), "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(_npz(net)) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("net", GNN_NETS + ("gnn_visual",))
def test_converter_reproduces_committed_gnn_npz(tmp_path, net):
    out = tmp_path / f"{net}.npz"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "convert_weights_to_torch.py"),
         "--kind", "gnn_visual" if net == "gnn_visual" else "gnn", "--model_dir",
         os.path.join(REPO, "models_ckpt", net, "best", "f1"), "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(_npz(net)) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("net", GNN_NETS)
def test_gnn_state_dict_covers_every_parameter(net):
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.weights import gnn_state_dict_from_flax, load_npz
    sd = gnn_state_dict_from_flax(load_npz(_npz(net)))
    model = GraphRelation(node_feature_dim=15, edge_feature_dim=2)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


@pytest.mark.parametrize("net", NETS)
def test_state_dict_covers_every_parameter(net):
    from citlab_as_tpu_torch.models.arunet import ARUNet
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz
    sd = arunet_state_dict_from_flax(load_npz(_npz(net)))
    model = ARUNet()
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    with pytest.raises(KeyError):
        arunet_state_dict_from_flax({"params/logit/dense/kernel": np.zeros(1)})


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_no_jax_and_no_reference(path):
    forbidden = FORBIDDEN + (() if path.endswith("chip_smoke.py") else ("scripts",))
    bad = [m for m in _imports(path)
           if m.split(".")[0] in forbidden and m.split(".")[0] != "citlab_as_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_running_the_slice_loads_no_jax_module():
    """Import the port and run its stages on the CPU, in memory and from
    files to files, then the whole workflow (every clustering method's
    code) and the pipelined workflow with a visual relation net, the JPEG /
    TIFF decoder, the host stage CLIs, the AS measure and K1's backward, in
    a fresh process (conftest.py has loaded jax in this one)."""
    code = r"""
import os, sys, tempfile
import numpy as np, torch
import chip_smoke
import citlab_as_tpu_torch
from citlab_as_tpu_torch.inference import SegmentationPredictor
from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.stages.heading import HeadingNetPostProcessor
from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
pred = SegmentationPredictor(None, graph_params={"featRoot": 4, "scale_space_num": 3,
                             "res_depth": 1, "num_scales_att": 2},
                             dtype=torch.float32, pad_multiple=16, device="cpu")
pages, _ = chip_smoke.synthetic_pages(2, 48, 40, seed=0)
out = SeparatorNetPostProcessor(pages, pred, fixed_height=32).run_batched(2)
assert len(out) == 2 and all(isinstance(d, dict) for d in out)
torch.set_num_threads(1)
pages, _, layouts = chip_smoke.synthetic_newspaper(1, 260, 200, seed=0, headlines=1)
root = tempfile.mkdtemp()
paths = chip_smoke.write_corpus(root, pages, layouts)
sep = SeparatorNetPostProcessor(paths, pred, fixed_height=128, threshold=1.1)
sep.run_batched_fused(1)
outs = [sep._page_path_for(p) + ".xml" for p in paths]
head = HeadingNetPostProcessor(paths, pred, fixed_height=128, page_paths=outs,
                               save_suffix="")
head.use_device_swt = True
written = head.run_batched_fused(1)
assert all(Page.validate(Page(p).page_doc) for p in outs) and len(written) == 1
assert all(tl.get_semantic_type() == "heading" for p in written
           for tl in p.textlines if tl.id.startswith("hl_"))
from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
from citlab_as_tpu_torch.inference import RelationPredictor
def benign(image_grey):      # net outputs with no separator and no heading
    prob = np.zeros(image_grey.shape + (2,), np.float32)
    prob[..., 1] = 1.0
    return prob
res = run_full_workflow(paths, separator_predictor=benign, heading_predictor=benign,
                        gnn_predictor=RelationPredictor(None, device="cpu"),
                        separator_fixed_height=128, heading_fixed_height=128,
                        out_dir=os.path.join(root, "out"), device="cpu",
                        clustering_method="dbscan_std")
assert res["skipped"] == [] and len(res["clustered"]) == 1
from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow_pipelined
visual = RelationPredictor(None, device="cpu", image_input=True,
                           visual_backbone="ARU_cutted_v1", image_min_dimension=64,
                           image_max_dimension=96)
res = run_full_workflow_pipelined(paths, separator_predictor=benign,
                                  heading_predictor=benign, gnn_predictor=visual,
                                  separator_fixed_height=128, heading_fixed_height=128,
                                  out_dir=os.path.join(root, "out"), device="cpu")
assert res["skipped"] == [] and len(res["clustered"]) == 1
# the JPEG / TIFF decoder on the committed fixtures, the stage CLIs and
# the AS measure
import glob
from citlab_as_tpu_torch.utils.io import load_image
for fixture in sorted(glob.glob(os.path.join("tests", "data", "torch_formats", "*.*"))):
    if not fixture.endswith(".json"):
        assert load_image(fixture, "L").shape == (2000, 1420)
from citlab_as_tpu_torch.cli import (run_baseline_clustering, run_conf_to_cluster,
    run_feature_generation, run_gnn_clustering, run_measure, run_net_post_processing,
    run_textregion_generation)
pages = [os.path.join(root, "page", os.path.basename(p)[:-4] + ".xml") for p in paths]
lst = os.path.join(root, "pages.lst")
open(lst, "w").write("\n".join(pages) + "\n")
assert run_baseline_clustering.main(["--path_to_xml_lst", lst]) == []
assert run_textregion_generation.main(["--path_to_xml_lst", lst]) == []
measured = run_measure.main(["--path_to_gt_xml_lst", lst, "--path_to_hy_xml_lst", lst])
assert measured["as"] is not None and abs(measured["as"][2] - 1.0) < 1e-9
x = torch.randn(1, 6, 7, 8, requires_grad=True)
w = torch.randn(8, 8, 3, 3, requires_grad=True)
from citlab_as_tpu_torch.ops.kernels.conv3x3 import conv3x3
conv3x3(x, w, torch.zeros(8, requires_grad=True), relu=True).sum().backward()
assert x.grad is not None and w.grad is not None
for method in ("linkage", "greedy"):
    from citlab_as_tpu_torch.stages.clustering import TextblockClustering
    tb = TextblockClustering({"t": "silhouette"} if method == "linkage" else None)
    tb.set_confs(np.random.RandomState(0).rand(6, 6))
    tb.calc(method)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax",
                                    "citlab_as_tpu", "sklearn", "lxml", "PIL",
                                    "shapely"))
print("LOADED", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_running_the_training_path_loads_no_jax_module():
    """The training path in a fresh process: both trainers (tiny nets, a GT
    directory and feature JSONs written by the port), every optimizer, the
    synthetic pages, LAV, the three training CLIs and the recipes of
    ``citlab_as_tpu_torch/scripts`` (the separator recipe, the synthetic
    GNN recipe, a visual relation net's train step, the page generators),
    then no module of jax, flax, optax, orbax, sklearn, PIL, the JAX package
    or the repository's top-level ``scripts`` is loaded."""
    code = r"""
import json, os, sys, tempfile
import numpy as np, torch
import chip_smoke
from citlab_as_tpu_torch.cli import run_lav, run_train_gnn, run_train_segmentation
from citlab_as_tpu_torch.train import optimizer, synthetic_data
root = tempfile.mkdtemp()
gt = chip_smoke.write_seg_gt(os.path.join(root, "gt"), 2, (96, 80), seed=0)
out = run_train_segmentation.main(["--model_dir", os.path.join(root, "seg"),
    "--train_gt_dir", gt, "--eval_gt_dir", gt, "--epochs", "1", "--steps_per_epoch", "1",
    "--batch_size", "1", "--crop_size", "64", "64", "--graph", "RU", "--device", "cpu"])
assert np.isfinite(out["history"][0]["loss"])
rng = np.random.RandomState(0)
paths = []
for g in range(3):
    n = 5
    edges = [[i, j] for i in range(n) for j in range(n) if i != j]
    graph = {"num_nodes": n, "interacting_nodes": edges, "node_features":
             rng.rand(n, 15).tolist(), "edge_features": rng.rand(len(edges), 2).tolist(),
             "gt_relations": [[1, i, j] for i in range(n) for j in range(n)
                              if (i < 3) == (j < 3)]}
    paths.append(os.path.join(root, f"g{g}.json"))
    json.dump(graph, open(paths[-1], "w"))
lst = chip_smoke._write_list(os.path.join(root, "g.lst"), paths)
run_train_gnn.main(["--model_dir", os.path.join(root, "gnn"), "--train_list", lst,
                    "--eval_list", lst, "--epochs", "1", "--samples_per_epoch", "4",
                    "--batch_size", "2", "--sample_num_relations", "8", "--device", "cpu"])
assert np.isfinite(run_lav.main(["--model_dir", os.path.join(root, "gnn"), "--eval_list",
                                 lst, "--device", "cpu"])["best_f1"])
for name in ("adam", "nadam", "rmsprop", "sgd"):
    opt = optimizer.build_optimizer({"optimizer": name}, 2, 4, grad_accum_steps=2)
    p = {"w": torch.ones(3)}
    s = opt.init(p)
    for _ in range(2):
        opt.step(p, {"w": torch.full((3,), 0.5)}, s)
img, lab = synthetic_data.synthetic_batch(torch.Generator().manual_seed(0), 1, 64, 64)
assert img.shape == (1, 64, 64, 1)
from citlab_as_tpu_torch.scripts import (eval_visual_gnn, hard_corpus, train_pipeline_gnn,
    train_synthetic_gnn, train_synthetic_separator)
acc = train_synthetic_separator.main(["--model_dir", os.path.join(root, "sep"), "--steps",
    "1", "--batch", "1", "--crop", "64", "--device", "cpu"])[0]
assert 0.0 <= acc <= 1.0
out = train_synthetic_gnn.main(["--model_dir", os.path.join(root, "sg"), "--num_pages", "6",
    "--epochs", "2", "--samples_per_epoch", "8", "--batch_size", "2", "--device", "cpu"])
assert np.isfinite(out["history"][-1]["loss"])
hard_corpus.make_hard_article_page(root, "hard", np.random.RandomState(0), h=700)
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.train.trainer import TrainerGNN
from citlab_as_tpu_torch.utils.io import save_png
for g, path in enumerate(paths):
    graph = json.load(open(path))
    graph["visual_regions_nodes"] = [[[4, 30, 30, 4], [4, 4, 20, 20]]] * 5
    graph["num_points_visual_regions_nodes"] = [4] * 5
    os.makedirs(os.path.join(root, "json"), exist_ok=True)
    paths[g] = os.path.join(root, "json", f"g{g}.json")
    json.dump(graph, open(paths[g], "w"))
    save_png(os.path.join(root, f"g{g}.png"), rng.randint(0, 255, (60, 40)).astype(np.uint8))
visual = TrainerGNN(os.path.join(root, "vis"), paths, paths[:1], flags={"epochs": 1,
    "samples_per_epoch": 2, "batch_size": 2}, input_params={"image_input": True,
    "resize_min_dim": 64, "resize_max_dim": 64, "sample_num_relations_to_consider": 8},
    device="cpu", model=GraphRelation(15, 2, image_input=True, visual_backbone="ARU_cutted_v1"))
assert np.isfinite(visual.train()["history"][0]["loss"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax",
                                    "citlab_as_tpu", "sklearn", "lxml", "PIL",
                                    "shapely", "scripts"))
print("LOADED", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_running_the_gt_and_eval_path_loads_no_jax_module():
    """Ground truth and evaluation in a fresh process: every generator and
    the AS CLI on a drawn page, the JPEG writer and the resize, the
    comparator with its CSV and XLSX, the checker, the two comparison CLIs
    and the heading grid search, then no module of jax, sklearn, PIL,
    openpyxl, matplotlib or the JAX package is loaded."""
    code = r"""
import os, sys, tempfile
import numpy as np, torch
import chip_smoke
from citlab_as_tpu_torch.utils.io import get_page_path
from citlab_as_tpu_torch.stages.ground_truth import (RegionGroundTruthGenerator,
    create_text_files_from_page_list)
from citlab_as_tpu_torch.stages.bnl_ground_truth import (BNLGroundTruthGenerator,
    BNLHeaderGroundTruthGenerator)
from citlab_as_tpu_torch.cli import min_run_example, run_as_gt_generation, run_compare
from citlab_as_tpu_torch.eval.checker import AsChecker, AsProbCode
from citlab_as_tpu_torch.eval.heading_eval import run_grid_search
torch.set_num_threads(1)
root = tempfile.mkdtemp()
pages, _, layouts = chip_smoke.synthetic_newspaper(1, 800, 560, seed=0)
paths = chip_smoke.write_corpus(root, pages, layouts)
for cls, kw in ((RegionGroundTruthGenerator, {"max_resolution": (400, 0)}),
                (BNLGroundTruthGenerator, {}), (BNLHeaderGroundTruthGenerator, {})):
    gen = cls(paths, **kw)
    assert gen.run_ground_truth_generation(os.path.join(root, cls.__name__))
lst = chip_smoke._write_list(os.path.join(root, "p.lst"), [get_page_path(paths[0])])
assert run_as_gt_generation.main(["--pagexml_list", lst, "--save_folder",
                                  os.path.join(root, "as"), "--device", "cpu"]) == 1
create_text_files_from_page_list([get_page_path(paths[0])], os.path.join(root, "txt"))
spc, ev = min_run_example.main(["--demo", "--work_dir", os.path.join(root, "w"),
                                "--out_dir", os.path.join(root, "wo")])
run_compare.main(["--gt_dir", os.path.join(root, "w"), "--work_dir", os.path.join(root, "w"),
                  "--out_dir", os.path.join(root, "co")])
checker = AsChecker(set(AsProbCode))
checker.page_list = [get_page_path(paths[0])]
checker.check_pages()
checker.probs_to_xlsx(os.path.join(root, "c.xlsx"))
def net(image_grey):
    p0 = (1.0 - image_grey).astype(np.float32)
    return np.stack([p0, 1.0 - p0], axis=-1)
res = run_grid_search(paths, net, fixed_heights=(800,))
assert len(res) == 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "citlab_as_tpu", "sklearn",
                                    "lxml", "PIL", "shapely", "openpyxl", "matplotlib"))
print("LOADED", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_running_the_models_path_loads_no_jax_module():
    """The models slice in a fresh process: ``.frozen`` export and load of
    the three architectures (``run_export`` too), both predictors from
    artifacts, the Inception visual relation net, the .pb importer, the
    flags registry, the word-vector feature CLI, the text-block
    post-processor and the preprocessing CLI; then no module of jax, flax,
    msgpack, nltk, gensim, tensorflow, protobuf or the JAX package is
    loaded."""
    code = r"""
import json, os, shutil, sys, tempfile
import numpy as np, torch
import chip_smoke
from citlab_as_tpu_torch.cli import run_export, run_feature_generation, run_page_preprocessing
from citlab_as_tpu_torch.config import flags
from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
from citlab_as_tpu_torch.models.arunet import ARUNet
from citlab_as_tpu_torch.models.gnn.model import GraphRelation
from citlab_as_tpu_torch.models.inception_v3 import InceptionV3
from citlab_as_tpu_torch.models.pb_import import import_arunet_weights
from citlab_as_tpu_torch.stages.textblock_postprocess import TextBlockNetPostProcessor, xy_cut
from citlab_as_tpu_torch.train.export import export_frozen, load_frozen
from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict
torch.set_num_threads(1)
root = tempfile.mkdtemp()
gp = {"featRoot": 8, "scale_space_num": 2, "res_depth": 1, "num_scales_att": 2}
aru = ARUNet(graph_params=gp).init_random(0)
path = export_frozen(os.path.join(root, "aru.frozen"), "arunet", aru,
                     {"graph_params": gp, "dtype": torch.bfloat16})
pred = SegmentationPredictor(path, device="cpu")
assert pred(np.random.rand(40, 30).astype(np.float32)).shape == (40, 30, 2)
np.savez(os.path.join(root, "aru.npz"), **arunet_flax_from_state_dict(aru.state_dict()))
assert run_export.main(["--checkpoint_dir", os.path.join(root, "aru.npz"), "--out",
                        os.path.join(root, "aru2.frozen"), "--architecture", "arunet",
                        "--model_kwargs", json.dumps({"graph_params": gp})])
inc = export_frozen(os.path.join(root, "inc.frozen"), "inception_v3", InceptionV3().init_random(0))
assert load_frozen(inc)[0](torch.rand(1, 80, 80, 1))[0].shape == (1, 1, 1, 2048)
gnn = GraphRelation(15, 2, image_input=True, visual_backbone="inception_v3")
gnn.visual.backbone.init_random(1)
gpath = export_frozen(os.path.join(root, "gnn.frozen"), "graph_relation", gnn,
                      {"image_input": True, "visual_backbone": "inception_v3"})
rng = np.random.RandomState(0)
graph = {"num_nodes": 4, "interacting_nodes": [[0, 1], [1, 2], [2, 3]],
         "node_features": rng.rand(4, 15).tolist(), "edge_features": rng.rand(3, 2).tolist(),
         "visual_regions_nodes": [[[10, 50, 50, 10], [10, 10, 40, 40]]] * 4,
         "num_points_visual_regions_nodes": [4] * 4}
conf = RelationPredictor(gpath, device="cpu", image_input=True, visual_backbone="inception_v3",
                         image_min_dimension=96, image_max_dimension=128
                         ).confidences(graph, rng.randint(0, 255, (200, 150)).astype(np.uint8))
assert conf.shape == (4, 4) and np.isfinite(conf).all()
flat = arunet_flax_from_state_dict(aru.state_dict())
assert import_arunet_weights(b"", flat)[1] == []
reg = flags.Flags()
reg.define_integer("k", 1, "k")
assert reg.parse_flags(["--k", "3"]) == [] and reg.k == 3
prob = np.zeros((60, 50, 2), np.float32)
prob[10:30, 10:30, 0] = 1.0
post = TextBlockNetPostProcessor(device="cpu")
assert len(post.run_on_probability_map(prob)) == 1 and xy_cut(np.zeros((40, 30), np.uint8))
data = os.path.join("tests", "data", "torch_preprocessing")
work = os.path.join(root, "pre")
shutil.copytree(data, work)
pages = [os.path.join(work, d, "page", f) for d in ("a", "b")
         for f in sorted(os.listdir(os.path.join(work, d, "page")))]
lst = chip_smoke._write_list(os.path.join(root, "pre.lst"), pages)
run_page_preprocessing.main(["--page_path_list", lst, "--delete_border_textlines"])
run_page_preprocessing.main(["--page_path_list", lst, "--fix_incorrect_regions"])
pages, _, layouts = chip_smoke.synthetic_newspaper(1, 400, 300, seed=0, headlines=1)
paths = chip_smoke.write_corpus(os.path.join(root, "c"), pages, layouts)
from citlab_as_tpu_torch.utils.io import get_page_path
wv = os.path.join(root, "wv.txt")
open(wv, "w").write("2 3\nzeitung 1 0 0\nstadt 0 1 0\n")
lst = chip_smoke._write_list(os.path.join(root, "p.lst"), [get_page_path(paths[0])])
run_feature_generation.main(["--pagexml_list", lst, "--out_path", os.path.join(root, "j"),
                             "--language", "german", "--wv_path", wv])
# torch itself loads the ``google`` namespace (``google.cloud``); protobuf
# is what a .pb reader would have pulled in
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax", "citlab_as_tpu",
                                    "msgpack", "nltk", "gensim", "tensorflow",
                                    "sklearn", "lxml", "PIL", "shapely")
             or m.startswith("google.protobuf"))
print("LOADED", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_only_the_mesh_imports_torch_distributed():
    users = sorted(os.path.relpath(p, REPO) for p in _port_files()
                   if p.startswith(PORT)
                   and any(m.startswith("torch.distributed") for m in _imports(p)))
    assert users == [os.path.join("citlab_as_tpu_torch", "parallel", "mesh.py")]


def test_running_the_parallel_and_plot_paths_loads_no_jax_module():
    """The data-parallel path and the plotting path in a fresh process: a
    sharded ARU predictor and relation net over a 2-shard CPU mesh, the
    pipelined workflow over it, ``run_net_post_processing --sharded``,
    ``initialize_multihost``, the page plots, ``plot_net_output``, the
    image transforms and the corpus, KWS and profiling tools; then no
    module of jax, matplotlib, PIL, sklearn or the JAX package is loaded."""
    code = r"""
import os, sys, tempfile
import numpy as np, torch
import chip_smoke
from citlab_as_tpu_torch.cli import plot_net_output, run_net_post_processing
from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow_pipelined
from citlab_as_tpu_torch.inference import (RelationPredictor, SegmentationPredictor,
                                           ShardedSegmentationPredictor)
from citlab_as_tpu_torch.ops.image_utils import apply_transform, shape_to_mask
from citlab_as_tpu_torch.pagexml import plot
from citlab_as_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from citlab_as_tpu_torch.utils import corpus_tools, kws_eval, profiling
from citlab_as_tpu_torch.utils.io import get_page_path, save_png
torch.set_num_threads(1)
mesh = make_mesh(["cpu", "cpu"])
gp = {"featRoot": 4, "scale_space_num": 3, "res_depth": 1, "num_scales_att": 2}
sharded = ShardedSegmentationPredictor(None, mesh=mesh, graph_params=gp,
                                       dtype=torch.float32, pad_multiple=16)
assert len(sharded.predict_batch([np.random.rand(30, 20).astype(np.float32)] * 3)) == 3
root = tempfile.mkdtemp()
pages, _, layouts = chip_smoke.synthetic_newspaper(2, 260, 200, seed=0, headlines=1)
paths = chip_smoke.write_corpus(root, pages, layouts)
def benign(image_grey):
    prob = np.zeros(image_grey.shape + (2,), np.float32)
    prob[..., 1] = 1.0
    return prob
res = run_full_workflow_pipelined(paths, separator_predictor=benign,
                                  heading_predictor=sharded,
                                  gnn_predictor=RelationPredictor(None, device="cpu"),
                                  separator_fixed_height=128, heading_fixed_height=128,
                                  batch_size=1, out_dir=os.path.join(root, "out"),
                                  device="cpu", mesh=mesh)
assert res["skipped"] == [] and len(res["clustered"]) == 2
lst = chip_smoke._write_list(os.path.join(root, "img.lst"), paths)
run_net_post_processing._mesh_for = lambda device: mesh
assert len(run_net_post_processing.main(["--path_to_image_list", lst, "--mode", "heading",
    "--sharded", "--batch_size", "1", "--fixed_height", "128", "--device", "cpu"])) == 2
assert initialize_multihost() is False
canvas = plot.plot_pagexml(res["clustered"][0], paths[0], plot_legend=True,
                           save_path=os.path.join(root, "plot.png"))
assert len(canvas) > 0 and os.path.exists(os.path.join(root, "plot_legend.json"))
assert plot.plot_folder(root, out_dir=os.path.join(root, "folder"))
assert len(plot_net_output.main(["--path_to_img_lst", lst, "--save_folder",
    os.path.join(root, "net"), "--fixed_height", "64", "--device", "cpu"])) == 2
img = np.random.RandomState(0).randint(0, 255, (30, 40)).astype(np.uint8)
for kind in ("rect", "ellipse", "cross"):
    apply_transform(img, "gradient", (3, 3), kind, device="cpu")
for shape in ("circle", "rectangle", "line", "point", None):
    pts = {"circle": [(10, 10), (14, 12)], "rectangle": [(2, 2), (9, 9)],
           "line": [(1, 1), (20, 20)], "point": [(5, 5)]}.get(shape, [(1, 1), (9, 2), (5, 8)])
    assert shape_to_mask((30, 40), pts, shape).any()
corpus_tools.get_page_stats(get_page_path(paths[0]))
assert kws_eval.evaluate_queries({"A": []}, ["a"]) == {"a": []}
with profiling.profile_trace(os.path.join(root, "trace")):
    with profiling.annotate("x"):
        torch.ones(2).sum()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax", "citlab_as_tpu",
                                    "sklearn", "lxml", "PIL", "shapely", "matplotlib"))
print("LOADED", bad)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from citlab_as_tpu_torch.device import resolve_device
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentationPredictor(None, graph_params={"featRoot": 4, "scale_space_num": 2})
    from citlab_as_tpu_torch.train.seg_trainer import TrainerSegmentation
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerGNN("unused", [], [])
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainerSegmentation("unused", "unused")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_refuses_without_cuda_and_alone(tmp_path):
    """chip_smoke.py exits nonzero and prints no result on a machine
    without a card, and in a directory holding nothing else of the repo."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    for script in (os.path.join(REPO, "chip_smoke.py"), str(lone)):
        r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_reading_orbax_checkpoints_loads_no_forbidden_module():
    """In a fresh process, every committed orbax checkpoint restored, the
    predictors loaded from ``models_ckpt/`` and one frozen from it: none of
    jax, orbax, tensorstore, zstandard, a CRC or hash package, zarr or
    another forbidden module loads (``google``'s namespace package aside,
    which the interpreter's site setup imports)."""
    code = r"""
import glob, os, sys, tempfile
import numpy as np, torch
from citlab_as_tpu_torch.train.orbax import restore
from citlab_as_tpu_torch.train.checkpoint import checkpoint_variables, restore_checkpoint
from citlab_as_tpu_torch.train.export import export_checkpoint_frozen
from citlab_as_tpu_torch.inference import SegmentationPredictor
dirs = sorted(os.path.dirname(p) for p in glob.glob("models_ckpt/**/_METADATA", recursive=True))
assert len(dirs) == 9
for d in dirs:
    assert restore(d)
state, step = restore_checkpoint("models_ckpt/gnn")
assert step == 29 and "opt_state" in state
SegmentationPredictor("models_ckpt/separator", device="cpu")
variables, _ = checkpoint_variables("models_ckpt/gnn_visual/best/f1")
assert len(variables) == 36
with tempfile.TemporaryDirectory() as tmp:
    export_checkpoint_frozen("models_ckpt/heading", os.path.join(tmp, "h.frozen"), "arunet")
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("LOADED", bad)
""" % (tuple(m for m in FORBIDDEN if m != "google")    # site loads google's namespace
       + ("google_crc32c", "xxhash", "ml_dtypes", "numcodecs", "zarr"),)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout, r.stdout
