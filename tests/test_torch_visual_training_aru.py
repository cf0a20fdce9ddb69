"""The visual relation GNN with the full ``ARU_v1`` backbone trained in the
port against the JAX package, on the CPU (the helpers and the
``ARU_cutted_v1`` case are in ``test_torch_visual_training.py``).

From the JAX trainer's own init, over the same visual batches (96 x 96
images, node bucket 8, 16 relations, weight decay 1e-6): each of the 3 step
losses within 1e-5, every parameter leaf within 1e-5 relative after them
(the backbone's logit, attention and up-path layers, which the end points
do not reach, moved by the weight decay alone, as under ``jax.grad``), the
eval metrics equal; under autograd every train step runs the ARU-Net's 69
K1 convs through ``Conv3x3Function``.

The parameters are compared by the norm of each leaf's difference, not
element by element: Adam divides each gradient by its own root mean
square, so an element whose gradient is near Adam's eps (1e-8), as in the
deepest convs at 6 x 6 cells, turns the two libraries' float32 summation
orders into a larger step difference (2 of the 147,456 elements of
``unet_down_4/convR_2`` at 3.2e-5 of the leaf's largest value, the leaf's
difference norm at 5e-7 of its own).
"""
import pytest

from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
from citlab_as_tpu_torch.weights import gnn_flax_from_state_dict
from tests.test_torch_visual_training import (
    FLAGS, assert_close_leaves, assert_same_runs, flat, train_both,
)


def test_aru_v1_visual_trainer_steps_equal_jax(tmp_path, monkeypatch):
    calls = []
    apply = k1.Conv3x3Function.apply

    def counting_apply(*args):
        calls.append(args[0].shape)
        return apply(*args)

    monkeypatch.setattr(k1.Conv3x3Function, "apply", counting_apply)
    _, runs = train_both(str(tmp_path), "ARU_v1", dict(FLAGS, ema_decay=0.0,
                                                       export_curves=False))
    assert len(runs["port"]["losses"]) == 3
    assert len(calls) == 69 * 3
    assert {shape[1:3] for shape in calls} >= {(96, 96), (48, 48), (24, 24)}
    assert_same_runs(runs["port"], runs["jax"])
    state, jstate = runs["port"]["result"]["state"], runs["jax"]["result"]["state"]
    assert "visual.backbone.logit.weight" in state["params"]
    assert_close_leaves(gnn_flax_from_state_dict(state["params"]), flat(jstate["params"]),
                        norm=True)
    assert runs["port"]["result"]["best_metrics"] == pytest.approx(
        runs["jax"]["result"]["best_metrics"], abs=0)
