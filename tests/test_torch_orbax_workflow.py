"""Both packages' workflow CLIs with the JAX CLI's three model-directory
flags naming the committed orbax checkpoints (``--separator_model_dir
models_ckpt/separator --heading_model_dir models_ckpt/heading
--gnn_model_dir models_ckpt/gnn/best/f1``) on the demo page, on the CPU:
the port reads them without orbax (``train/orbax.py``), the JAX package
through orbax, and every text line gets the same article. Its own file, so
that the JAX package's compile of both ARU-Nets runs beside the other
orbax tests."""
import os
import shutil

import pytest

pytest.importorskip("orbax.checkpoint")

from tests.torch_jax_native import jax_native  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models_ckpt")


def test_workflow_with_the_jax_clis_three_model_dir_flags_equals_jax(tmp_path, monkeypatch,
                                                                     jax_native):  # noqa: F811
    """Both packages' ``run_full_workflow`` CLIs on the demo page with
    ``--separator_model_dir models_ckpt/separator --heading_model_dir
    models_ckpt/heading --gnn_model_dir models_ckpt/gnn/best/f1``: every
    text line gets the same article. (The separator polygons may differ by
    a pixel: both ARU-Nets run in bf16, each with its own rounding.)"""
    from citlab_as_tpu.cli.run_full_workflow import main as jmain
    from citlab_as_tpu.pagexml import Page as JPage
    from citlab_as_tpu_torch.cli.run_full_workflow import main as tmain
    from tests.test_torch_workflow import _corpus
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    images = _corpus(jroot, seeds=(11,))
    shutil.copytree(jroot, troot)
    flags = ["--separator_model_dir", os.path.join(CKPT, "separator"),
             "--heading_model_dir", os.path.join(CKPT, "heading"),
             "--gnn_model_dir", os.path.join(CKPT, "gnn", "best", "f1")]
    results = {}
    for side, root, main, extra in (("j", jroot, jmain, []), ("t", troot, tmain,
                                                              ["--device", "cpu"])):
        lst = os.path.join(root, "images.lst")
        with open(lst, "w") as f:
            f.write(os.path.join(root, os.path.basename(images[0])) + "\n")
        monkeypatch.chdir(root)
        results[side] = main(["--path_to_image_list", lst] + flags + extra)
        assert results[side]["skipped"] == [] and len(results[side]["clustered"]) == 1
    lines = [[(tl.id, tl.get_article_id()) for tl in JPage(results[s]["clustered"][0])
              .get_textlines()] for s in ("j", "t")]
    assert lines[0] == lines[1] and len(lines[0]) > 20
    assert all(article for _, article in lines[1])
    assert len({article for _, article in lines[1]}) >= 2
