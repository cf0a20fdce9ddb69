"""The JAX package's orbax model directories where the port takes a model:
the predictors (their state dicts from ``models_ckpt/`` equal the converted
``models_ckpt_torch/*.npz`` loads bit for bit) and every CLI with the JAX
CLIs' ``--model_dir`` flag, on the CPU (the workflow CLI's three flags:
``tests/test_torch_orbax_workflow.py``)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
from flax import traverse_util  # noqa: E402

from citlab_as_tpu_torch.inference import (  # noqa: E402
    RelationPredictor, SegmentationPredictor, ShardedSegmentationPredictor,
)
from tests.test_seg_training import gt_dir  # noqa: E402,F401  (fixture: JAX GT generator)
from tests.torch_jax_native import jax_native  # noqa: E402,F401
from tests.test_training import _write_graph_jsons  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models_ckpt")
NPZ = os.path.join(REPO, "models_ckpt_torch")


def _same_state(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _graph(n=4, visual=False):
    from citlab_as_tpu_torch.models.gnn.graph import fully_connected_edges
    edges = fully_connected_edges(n)
    graph = {"num_nodes": n, "node_features": np.zeros((n, 15), np.float32),
             "interacting_nodes": edges,
             "edge_features": np.zeros((len(edges), 2), np.float32)}
    if visual:
        graph["visual_regions_nodes"] = [[[0, 10, 10, 0], [0, 0, 10, 10]]] * n
        graph["num_points_visual_regions_nodes"] = [4] * n
    return graph


def _relation(path, visual=False):
    kw = dict(image_input=True, visual_backbone="ARU_cutted_v1", image_min_dimension=288,
              image_max_dimension=384) if visual else {}
    pred = RelationPredictor(path, device="cpu", **kw)
    images = [np.zeros((64, 48), np.uint8)] if visual else None
    inputs, _ = pred._batch_inputs([_graph(visual=visual)], images)
    pred._ensure_params(inputs)
    return pred


@pytest.mark.parametrize("net", ["separator", "heading"])
def test_segmentation_predictors_from_orbax_equal_the_npz(net):
    orbax = SegmentationPredictor(os.path.join(CKPT, net), device="cpu")
    _same_state(orbax.model, SegmentationPredictor(os.path.join(NPZ, f"{net}.npz"),
                                                   device="cpu").model)
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    sharded = ShardedSegmentationPredictor(os.path.join(CKPT, net),
                                           mesh=make_mesh(devices=[torch.device("cpu")]))
    _same_state(sharded.model, orbax.model)
    with pytest.raises(FileNotFoundError, match="No checkpoint found"):
        SegmentationPredictor(os.path.join(CKPT, net, "3000"), device="cpu")


@pytest.mark.parametrize("net,npz", [("gnn/best/f1", "gnn"), ("gnn_pipeline/best/f1",
                                                             "gnn_pipeline"),
                                     ("gnn_visual/best/f1", "gnn_visual")])
def test_relation_predictors_from_orbax_equal_the_npz(net, npz):
    visual = npz == "gnn_visual"
    _same_state(_relation(os.path.join(CKPT, net), visual).model,
                _relation(os.path.join(NPZ, f"{npz}.npz"), visual).model)


def _recording(cls, seen):
    class Recording(cls):
        def __init__(self, model_path=None, *args, **kwargs):
            seen.append(model_path)
            super().__init__(model_path, *args, **kwargs)
    return Recording


@pytest.mark.parametrize("entry", ["SegmentationPredictor", "ShardedSegmentationPredictor",
                                   "RelationPredictor", "run_full_workflow",
                                   "run_full_workflow_pipelined"])
def test_entry_points_take_the_jax_packages_model_dir_keywords(entry, monkeypatch, tmp_path):
    """The JAX package's keywords where the port's entry points say
    ``model_path``: ``model_dir=`` at the predictors (the same state as the
    path given positionally), ``separator_model_dir=`` /
    ``heading_model_dir=`` / ``gnn_model_dir=`` at the workflow drivers (run
    on no page: the predictors they build get the three directories); both
    names of one argument raise."""
    from citlab_as_tpu_torch import inference
    from citlab_as_tpu_torch.cli import run_full_workflow as wf
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    sep, gnn = os.path.join(CKPT, "separator"), os.path.join(CKPT, "gnn", "best", "f1")
    if entry == "SegmentationPredictor":
        _same_state(SegmentationPredictor(model_dir=sep, device="cpu").model,
                    SegmentationPredictor(sep, device="cpu").model)
        with pytest.raises(TypeError, match="model_path and model_dir"):
            SegmentationPredictor(sep, model_dir=sep, device="cpu")
    elif entry == "ShardedSegmentationPredictor":
        mesh = make_mesh(["cpu"] * 2)
        _same_state(ShardedSegmentationPredictor(model_dir=sep, mesh=mesh).model,
                    ShardedSegmentationPredictor(sep, mesh=mesh).model)
        with pytest.raises(TypeError, match="model_path and model_dir"):
            ShardedSegmentationPredictor(sep, mesh=mesh, model_dir=sep)
    elif entry == "RelationPredictor":
        pred = RelationPredictor(model_dir=gnn, device="cpu")
        assert pred.model_path == gnn
        inputs, _ = pred._batch_inputs([_graph()], None)
        pred._ensure_params(inputs)
        _same_state(pred.model, _relation(gnn).model)
        with pytest.raises(TypeError, match="model_path and model_dir"):
            RelationPredictor(gnn, model_dir=gnn, device="cpu")
    else:
        seen_seg, seen_gnn = [], []
        monkeypatch.setattr(inference, "SegmentationPredictor",
                            _recording(SegmentationPredictor, seen_seg))
        monkeypatch.setattr(inference, "RelationPredictor",
                            _recording(RelationPredictor, seen_gnn))
        heading = os.path.join(CKPT, "heading")
        driver = getattr(wf, entry)
        result = driver([], separator_model_dir=sep, heading_model_dir=heading,
                        gnn_model_dir=gnn, out_dir=str(tmp_path), device="cpu")
        assert result["pages"] == [] and seen_seg == [sep, heading] and seen_gnn == [gnn]
        for stage in ("separator", "heading", "gnn"):
            with pytest.raises(TypeError, match=f"{stage}_model_path and {stage}_model_dir"):
                driver([], **{f"{stage}_model_path": sep, f"{stage}_model_dir": sep},
                       device="cpu")


def test_relation_predictor_takes_the_newest_numbered_step():
    """``models_ckpt/gnn`` holds steps 28 and 29 (trainer states) beside
    best/f1: the predictor takes step 29's params, as the JAX predictor's
    ``restore_checkpoint`` does."""
    import orbax.checkpoint as ocp
    from citlab_as_tpu_torch.weights import gnn_flax_from_state_dict
    pred = _relation(os.path.join(CKPT, "gnn"))
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler())
    path = os.path.join(CKPT, "gnn", "29")
    meta = ckptr.metadata(path)
    args = jax.tree_util.tree_map(lambda m: ocp.RestoreArgs(restore_type=np.ndarray),
                                  meta.item_metadata.tree)
    state = ckptr.restore(path, args=ocp.args.PyTreeRestore(restore_args=args))
    want = traverse_util.flatten_dict(state["params"], sep="/")
    got = gnn_flax_from_state_dict(dict(pred.model.named_parameters()))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_run_export_freezes_an_orbax_directory_as_the_jax_cli(tmp_path):
    """``run_export`` of the port and of the JAX package on the same orbax
    directories (a numbered run, a best export): the same config and the
    same variables, bit for bit."""
    from citlab_as_tpu.cli import run_export as jexport
    from citlab_as_tpu_torch.cli import run_export as texport
    from citlab_as_tpu_torch.train.export import read_frozen
    for src, arch in (("separator", "arunet"), ("gnn/best/f1", "graph_relation"),
                      ("gnn", "graph_relation")):
        outs = []
        for side, mod in (("j", jexport), ("t", texport)):
            out = str(tmp_path / f"{side}_{src.replace('/', '_')}.frozen")
            mod.main(["--checkpoint_dir", os.path.join(CKPT, src), "--out", out,
                      "--architecture", arch])
            outs.append(read_frozen(out))
        (jconf, jvars), (tconf, tvars) = outs
        assert tconf == jconf
        assert sorted(tvars) == sorted(jvars)
        for k in jvars:
            assert tvars[k].dtype == jvars[k].dtype and tvars[k].tobytes() == jvars[k].tobytes(), k


def test_stage_clis_take_orbax_model_dirs(tmp_path, monkeypatch, jax_native):  # noqa: F811
    """``run_net_post_processing`` and ``plot_net_output`` with
    ``--model_dir models_ckpt/separator`` on a 128 x 128 crop of the demo
    page, ``run_gnn_clustering`` with ``--model_dir models_ckpt/gnn/best/f1``
    on the page's feature JSON: each writes what it writes with ``--model``
    and the converted ``.npz``."""
    from PIL import Image
    from scripts.bench_e2e import make_demo_page
    from citlab_as_tpu_torch.cli import plot_net_output, run_gnn_clustering
    from citlab_as_tpu_torch.cli import run_net_post_processing
    from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
    from citlab_as_tpu_torch.pagexml import page as tpage
    monkeypatch.setattr(tpage, "_utc_now", lambda: "2024-01-02T03:04:05Z")
    base = tmp_path / "base"
    base.mkdir()
    img, _ = make_demo_page(str(base), "d0", np.random.RandomState(3))
    Image.open(img).crop((0, 0, 128, 128)).save(base / "small.png")
    run_full_workflow([img], gnn_model_path=os.path.join(NPZ, "gnn.npz"),   # the feature JSON
                      separator_predictor=_rule, heading_predictor=_rule,
                      out_dir=str(base / "wf"), device="cpu")
    runs = {}
    for kind in ("orbax", "npz"):
        root = tmp_path / kind
        shutil.copytree(base, root)
        lst = root / "images.lst"
        lst.write_text(str(root / "small.png") + "\n")
        sep = (["--model_dir", os.path.join(CKPT, "separator")] if kind == "orbax"
               else ["--model", os.path.join(NPZ, "separator.npz")])
        run_net_post_processing.main(["--path_to_image_list", str(lst), "--mode", "separator",
                                      "--device", "cpu"] + sep)
        plot_net_output.main(["--path_to_img_lst", str(lst), "--save_folder",
                              str(root / "plots"), "--fixed_height", "128",
                              "--device", "cpu"] + sep)
        jsons = [os.path.join(d, f) for d, _, names in os.walk(root) for f in names
                 if f.endswith(".json")]
        elst = root / "eval.lst"
        elst.write_text("\n".join(jsons) + "\n")
        monkeypatch.chdir(root)
        gnn = (["--model_dir", os.path.join(CKPT, "gnn", "best", "f1")] if kind == "orbax"
               else ["--model", os.path.join(NPZ, "gnn.npz")])
        written = run_gnn_clustering.main(["--eval_list", str(elst), "--out_dir", "gc",
                                           "--device", "cpu", "--save_conf"] + gnn)
        assert len(written) == 1
        runs[kind] = root
    files = sorted(os.path.relpath(os.path.join(d, f), runs["npz"])
                   for d, _, names in os.walk(runs["npz"]) for f in names
                   if not f.endswith(".lst"))
    assert any(f.endswith("_clustering.xml") for f in files)
    assert any(f.startswith("plots") for f in files)
    assert any(f.startswith("page") and "small" in f for f in files)
    for rel in files:
        a = open(runs["npz"] / rel, "rb").read()
        b = open(runs["orbax"] / rel, "rb").read()
        if rel.endswith(".json") or rel.endswith(".xml"):
            a, b = (x.replace(str(runs[k]).encode(), b"ROOT") for x, k in ((a, "npz"), (b, "orbax")))
        assert a == b, rel


def _rule(image_grey):
    h, w = image_grey.shape
    prob = np.zeros((h, w, 2), np.float32)
    prob[10:h - 10, w // 2 - 2:w // 2 + 2, 0] = 0.9
    prob[..., 1] = 1.0 - prob[..., 0]
    return prob


def test_run_lav_on_an_orbax_run_equals_jax(tmp_path):
    """``run_lav --model_dir`` on an orbax run whose step holds ``{params}``
    (the committed relation net's variables, saved by the JAX package's
    ``save_checkpoint``; the JAX CLI's restore refuses a step that also
    holds ``opt_state``) on graphs of the net's widths: the JAX CLI's result
    within 1e-5 (``tests/test_torch_gnn_training.py``'s LAV tolerance)."""
    from citlab_as_tpu.cli import run_lav as jlav
    from citlab_as_tpu.train.checkpoint import save_checkpoint
    from citlab_as_tpu_torch.cli import run_lav as tlav
    from citlab_as_tpu_torch.train.orbax import restore
    run = str(tmp_path / "run")
    save_checkpoint(run, 5, {"params": restore(os.path.join(CKPT, "gnn", "best", "f1"))})
    graphs = _write_graph_jsons(tmp_path, n_graphs=3)
    lst = tmp_path / "eval.lst"
    lst.write_text("\n".join(graphs) + "\n")
    args = ["--model_dir", run, "--eval_list", str(lst), "--num_p_r_thresholds", "8"]
    want = jlav.main(args)
    got = tlav.main(args + ["--device", "cpu"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["gnn", "segmentation"])
def test_training_clis_resume_a_jax_model_dir(tmp_path, kind, gt_dir):  # noqa: F811
    """A ``--model_dir`` the JAX package wrote (orbax step 0 with optax's
    state and ``current_epoch.info``: by its ``run_train_gnn``, or, for the
    full-width RU net of ``run_train_segmentation --graph RU``, by its
    ``save_checkpoint`` of the state its trainer keeps, initial weights
    and adam's ``init``, sparing the test an XLA compile of that net): the
    port's CLI, given a copy and two epochs, resumes at the second."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "gnn":
        from citlab_as_tpu.cli import run_train_gnn as jcli
        from citlab_as_tpu_torch.cli import run_train_gnn as tcli
        graphs = _write_graph_jsons(tmp_path, n_graphs=4)
        train, evl = tmp_path / "train.lst", tmp_path / "eval.lst"
        train.write_text("\n".join(graphs[:3]) + "\n")
        evl.write_text(graphs[3] + "\n")
        common = ["--train_list", str(train), "--eval_list", str(evl), "--samples_per_epoch",
                  "4", "--batch_size", "2", "--sample_num_relations", "16"]
        jcli.main(["--model_dir", jdir, "--epochs", "1"] + common)
    else:
        import jax.numpy as jnp
        from citlab_as_tpu.train.checkpoint import save_checkpoint, write_epoch_info
        from citlab_as_tpu.train.optimizer import build_optimizer
        from citlab_as_tpu_torch.cli import run_train_segmentation as tcli
        from citlab_as_tpu_torch.train.segmentation import create_model, init_params
        from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict
        common = ["--train_gt_dir", gt_dir, "--eval_gt_dir", gt_dir, "--steps_per_epoch", "1",
                  "--batch_size", "1", "--crop_size", "64", "64", "--n_classes", "3",
                  "--graph", "RU"]
        net = init_params(create_model(3, {"graph": "RU"}), seed=3)
        variables = traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in
             arunet_flax_from_state_dict(dict(net.named_parameters())).items()})
        opt = build_optimizer(None, 1, 1, "final_decay")
        save_checkpoint(jdir, 0, {"params": variables, "opt_state": opt.init(variables)})
        write_epoch_info(jdir, 1, extra={"best_metrics": {}})
    assert json.load(open(os.path.join(jdir, "current_epoch.info")))["current_epoch"] == 1
    shutil.copytree(jdir, tdir)
    out = tcli.main(["--model_dir", tdir, "--epochs", "2", "--device", "cpu"] + common)
    assert [r["epoch"] for r in out["history"]] == [1]
    assert np.isfinite(out["history"][0]["loss"])
    assert sorted(d for d in os.listdir(tdir) if d.isdigit()) == ["0", "1"]
