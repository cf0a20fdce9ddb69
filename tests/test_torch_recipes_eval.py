"""The blind evaluation recipe (``citlab_as_tpu_torch/scripts/
eval_visual_gnn.py``) against the JAX script, on the CPU: one seed's drawn
page, article ids stripped, through each package's whole workflow with the
committed separator and heading nets and the committed visual relation net
(``models_ckpt/gnn_visual/best/f1``, ARU_cutted_v1 at 288 / 384), scored
by each package's AS measure: the same AS F.
"""
import os
import sys

import pytest

from citlab_as_tpu_torch.scripts import eval_visual_gnn

SEED = "31"


def test_eval_visual_gnn_equals_jax(monkeypatch, capsys):
    # the JAX script sets the 8-device CPU platform when imported (as this
    # suite's conftest has done already); keep its environment change here
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(sys, "argv", ["eval_visual_gnn", "--seeds", SEED])
    import scripts.eval_visual_gnn as jeval
    want = jeval.main()
    got = eval_visual_gnn.main(["--seeds", SEED, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"seed {SEED}: n_articles=" in out and "mean F=" in out
    assert 0.5 < want <= 1.0
    assert got == pytest.approx(want, abs=1e-12)
