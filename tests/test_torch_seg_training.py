"""The port's segmentation training (``train/segmentation.py``,
``seg_input_pipeline.py``, ``synthetic_data.py``, ``seg_trainer.py``,
``models/backbones.py``) against the JAX package, on the CPU, with tiny
nets (featRoot 4, 3 scales, res_depth 1) and the JAX init carried across
by ``weights.arunet_state_dict_from_flax``.

Tolerances:
- ``segmentation_loss`` with a mask and class weights: 1e-6 relative;
- loss and every gradient of a tiny RU and a tiny ARU net against
  ``jax.value_and_grad`` of the flax net: in f32, 1e-5 of each gradient's
  largest entry. In bf16 compute (float32 weights cast at use), the loss
  within 2e-2 relative of the JAX bf16 loss; the detCNN's and the logit
  layer's kernel gradients within 2e-2 of their scale of the JAX bf16
  gradients, and all their gradients, biases included, within 2e-2 of the
  JAX net's f32 gradients. The JAX bf16 bias gradients are no reference at
  that tolerance: XLA reduces them over B x H x W in bf16 and lands 5-55 %
  from its own f32 value on these nets, where the port's reduction (float32
  accumulation) stays within 1 %. The attention CNN's gradients are bf16
  noise on both sides (the JAX bf16 ones lie 4-12 % from the JAX f32 ones):
  each of the port's lies within 2e-2, or within twice the JAX bf16
  gradient's own distance, of the JAX f32 gradient;
- dataset crops, labels and masks: bit for bit; the synthetic composition
  fed the JAX draws: bit for bit;
- ``TrainerSegmentation`` in f32 over 2 epochs and a resumed third, with
  EMA (evaluated and exported in place of the live weights): the per-epoch
  train and eval losses within 1e-5 relative of the JAX trainer's (run in
  f32) from the same init, the resumed run's weights within 1e-5;
- K1 routing under autograd: 69 conv3x3 calls per train step and per eval
  step of the full-width ARU-Net, with 23 distinct (once-cast) weights.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from citlab_as_tpu.models.arunet import ARUNet as JARUNet
from citlab_as_tpu.train import seg_trainer as jseg_trainer
from citlab_as_tpu.train import synthetic_data as jsyn
from citlab_as_tpu.train.seg_input_pipeline import (
    SegmentationDataset as JDataset, find_gt_examples as jfind,
)
from citlab_as_tpu.train.segmentation import segmentation_loss as jloss
from citlab_as_tpu_torch.models import arunet as tarunet
from citlab_as_tpu_torch.models.backbones import get_backbone
from citlab_as_tpu_torch.train import seg_trainer, synthetic_data
from citlab_as_tpu_torch.train.seg_input_pipeline import (
    SegmentationDataset, find_gt_examples,
)
from citlab_as_tpu_torch.train.segmentation import (
    create_model, init_params, make_eval_step, make_train_step, segmentation_loss,
)
from citlab_as_tpu_torch.train.optimizer import build_optimizer
from citlab_as_tpu_torch.weights import (
    arunet_flax_from_state_dict, arunet_state_dict_from_flax,
)
from tests.test_seg_training import gt_dir  # noqa: F401  (fixture: JAX GT generator)

TINY = {"RU": {"graph": "RU", "featRoot": 4, "scale_space_num": 3, "res_depth": 1},
        "ARU": {"graph": "ARU", "featRoot": 4, "scale_space_num": 3, "res_depth": 1,
                "num_scales_att": 2}}


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@functools.cache
def _jax_init(graph, hw=64, n_classes=3):
    model = JARUNet(n_classes=n_classes, graph_params=TINY[graph])
    return _flat(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 1))))


def test_segmentation_loss_with_mask_and_class_weights_equals_jax():
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 9, 7, 3)).astype(np.float32)
    labels = rng.randint(0, 3, (2, 9, 7)).astype(np.int32)
    mask = (rng.rand(2, 9, 7) > 0.3).astype(np.float32)
    cw = np.array([1.0, 3.0, 0.5], np.float32)
    for m, w in ((None, None), (mask, None), (None, cw), (mask, cw)):
        want = float(jloss(jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m),
                           None if w is None else jnp.asarray(w)))
        got = float(segmentation_loss(torch.tensor(logits), torch.tensor(labels),
                                      None if m is None else torch.tensor(m), w))
        assert got == pytest.approx(want, rel=1e-6)


def _grad_case(seed=0, hw=64):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, hw, hw, 1).astype(np.float32),
            rng.randint(0, 3, (2, hw, hw)).astype(np.int32),
            (rng.rand(2, hw, hw) > 0.2).astype(np.float32))


@functools.cache
def _jax_value_and_grad(graph, dtype_name):
    img, lab, mask = _grad_case()
    model = JARUNet(n_classes=3, graph_params=TINY[graph],
                    dtype=getattr(jnp, dtype_name))

    def loss_fn(v):
        logits, _ = model.apply(v, jnp.asarray(img))
        return jloss(logits, jnp.asarray(lab), jnp.asarray(mask))

    flat = _jax_init(graph)
    variables = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                             sep="/")
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    return float(loss), _flat(grads)


def _port_value_and_grad(graph, dtype):
    img, lab, mask = _grad_case()
    model = create_model(3, TINY[graph], dtype)
    model.load_state_dict(arunet_state_dict_from_flax(_jax_init(graph)))
    loss = segmentation_loss(model(torch.from_numpy(img)), torch.from_numpy(lab),
                             torch.from_numpy(mask))
    loss.backward()
    grads = arunet_flax_from_state_dict({k: p.grad for k, p in model.named_parameters()})
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return float(loss.detach()), grads


def _grad_errors(got, want, keys):
    return {k: float(np.abs(got[k] - want[k]).max()) / max(float(np.abs(want[k]).max()), 1e-30)
            for k in keys}


@pytest.mark.parametrize("graph", ["RU", "ARU"])
def test_loss_and_every_gradient_equal_jax_f32(graph):
    want_loss, want = _jax_value_and_grad(graph, "float32")
    got_loss, got = _port_value_and_grad(graph, torch.float32)
    assert sorted(got) == sorted(want)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    errors = _grad_errors(got, want, want)
    assert max(errors.values()) <= 1e-5, max(errors.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("graph", ["RU", "ARU"])
def test_loss_and_every_gradient_equal_jax_bf16(graph):
    want_loss, want = _jax_value_and_grad(graph, "bfloat16")
    _, want_f32 = _jax_value_and_grad(graph, "float32")
    got_loss, got = _port_value_and_grad(graph, torch.bfloat16)
    assert got_loss == pytest.approx(want_loss, rel=2e-2)
    det = [k for k in want if not k.startswith("params/attMapG/")]
    att = [k for k in want if k.startswith("params/attMapG/")]
    kernels = [k for k in det if k.endswith("kernel")]
    errors = _grad_errors(got, want, kernels)
    assert max(errors.values()) <= 2e-2, max(errors.items(), key=lambda kv: kv[1])
    errors = _grad_errors(got, want_f32, det)
    assert max(errors.values()) <= 2e-2, max(errors.items(), key=lambda kv: kv[1])
    ref_noise = _grad_errors(want, want_f32, att)
    errors = _grad_errors(got, want_f32, att)
    for k in att:
        assert errors[k] <= max(2e-2, 2 * ref_noise[k]), (k, errors[k], ref_noise[k])


def test_dataset_crops_equal_jax(gt_dir):  # noqa: F811
    assert find_gt_examples(gt_dir) == jfind(gt_dir)
    examples = find_gt_examples(gt_dir)
    for crop, augment, seed in (((128, 96), True, 3), ((256, 256), True, 0),
                                ((64, 200), False, 7)):
        jds = JDataset(examples, crop_size=crop, augment=augment, seed=seed)
        tds = SegmentationDataset(examples, crop_size=crop, augment=augment, seed=seed)
        for jb, tb in zip(jds.batches(3, 4), tds.batches(3, 4)):
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k


def _jax_draws(key, batch, h, w):
    """The random inputs ``synthetic_data._page_sample`` draws from each
    page's key, in its order."""
    out = {k: [] for k in ("col_x", "col_w", "v_y0", "v_y1", "rule_y", "rule_thick",
                           "rule_left", "line_spacing", "words_low", "head_y",
                           "head_h", "noise_low")}
    rint = jax.random.randint
    for page_key in jax.random.split(key, batch):
        keys = jax.random.split(page_key, 10)
        out["col_x"].append(rint(keys[0], (), int(0.3 * w), int(0.7 * w)))
        out["col_w"].append(rint(keys[1], (), 2, 5))
        out["v_y0"].append(rint(keys[2], (), 0, h // 4))
        out["v_y1"].append(rint(keys[3], (), 3 * h // 4, h))
        ys, thick, left = [], [], []
        for i in range(3):
            k1, k2, k3 = jax.random.split(keys[4 + i], 3)
            ys.append(rint(k1, (), int(0.1 * h), int(0.9 * h)))
            thick.append(rint(k2, (), 2, 4))
            left.append(jax.random.bernoulli(k3))
        out["rule_y"].append(ys)
        out["rule_thick"].append(thick)
        out["rule_left"].append(left)
        out["line_spacing"].append(rint(keys[7], (), 18, 30))
        out["words_low"].append(jax.random.uniform(keys[8], (-(-h // 6), -(-w // 6))))
        k_h1, k_h2 = jax.random.split(keys[9])
        out["head_y"].append(rint(k_h1, (), int(0.1 * h), int(0.8 * h)))
        out["head_h"].append(rint(k_h2, (), 24, 40))
        out["noise_low"].append(jax.random.uniform(keys[0], (-(-h // 2), -(-w // 2))))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("heading_mode,hw", [(False, (96, 128)), (True, (131, 77))])
def test_synthetic_composition_of_jax_draws_equals_jax(heading_mode, hw):
    h, w = hw
    key = jax.random.PRNGKey(5)
    want_img, want_lab = jsyn.synthetic_batch(key, 3, h, w, heading_mode=heading_mode)
    img, lab = synthetic_data.compose_pages(_jax_draws(key, 3, h, w), h, w, heading_mode)
    assert img.dtype == torch.float32 and lab.dtype == torch.int32
    assert np.array_equal(img.numpy(), np.asarray(want_img))
    assert np.array_equal(lab.numpy(), np.asarray(want_lab))


def test_synthetic_batch_draws_on_its_generator():
    gen = torch.Generator().manual_seed(0)
    draws = synthetic_data.page_draws(gen, 2, 90, 120)
    assert {k: tuple(v.shape) for k, v in draws.items()}["words_low"] == (2, 15, 20)
    img, lab = synthetic_data.synthetic_batch(torch.Generator().manual_seed(0), 2, 90, 120)
    again, _ = synthetic_data.synthetic_batch(torch.Generator().manual_seed(0), 2, 90, 120)
    assert img.shape == (2, 90, 120, 1) and lab.shape == (2, 90, 120)
    assert torch.equal(img, again) and set(lab.unique().tolist()) == {0, 1}
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


@pytest.mark.parametrize("name", ["ARU_v1", "RU_v2", "U_v1", "ARU_cutted_v1"])
def test_backbones_equal_jax_parameter_trees(name):
    """Every backbone name builds the JAX package's parameter tree: the same
    flat flax paths and shapes (``jax.eval_shape`` of the flax init)."""
    from citlab_as_tpu.models.backbones import get_backbone as jget_backbone
    jmodel = jget_backbone(name, n_classes=3)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1), jnp.float32))
    want = {k: tuple(v.shape) for k, v in traverse_util.flatten_dict(shapes, sep="/").items()}
    model = get_backbone(name, n_classes=3, dtype=torch.bfloat16)
    got = {k: v.shape for k, v in arunet_flax_from_state_dict(model.state_dict()).items()}
    assert got == want
    # the ARU-Nets keep float32 weights and compute in bf16; the cutted
    # extractor computes in its weights' dtype
    want_dtype = torch.bfloat16 if name == "ARU_cutted_v1" else torch.float32
    assert all(p.dtype == want_dtype for p in model.parameters())
    with pytest.raises(ValueError):
        get_backbone("nope")


def test_train_and_eval_step_route_69_k1_convs_with_23_weights(monkeypatch):
    """A train step of the full-width ARU-Net in bf16 compute: 69 conv3x3
    calls (the 23 K1 convs of the detCNN at three scales), every weight
    cast once per forward, so 23 distinct bf16 weights; gradients reach
    every float32 parameter. The eval step routes the same 69."""
    calls = []
    real = tarunet.conv3x3

    def counting(x, weight, bias, relu=False):
        calls.append((id(weight), weight.dtype, x.dtype))
        return real(x, weight, bias, relu)

    monkeypatch.setattr(tarunet, "conv3x3", counting)
    model = init_params(create_model(2, None, torch.bfloat16), seed=0)
    params = dict(model.named_parameters())
    opt = build_optimizer({"optimizer": "adam"}, 4, 2)
    state = opt.init(params)
    rng = np.random.RandomState(0)
    batch = {"image": torch.tensor(rng.rand(1, 64, 64, 1).astype(np.float32)),
             "label": torch.tensor(rng.randint(0, 2, (1, 64, 64)).astype(np.int32)),
             "mask": torch.ones(1, 64, 64)}
    before = {k: v.detach().clone() for k, v in params.items()}
    loss = make_train_step(model, opt)(params, state, batch)
    assert torch.isfinite(loss)
    assert len(calls) == 69 and len({c[0] for c in calls}) == 23
    assert all(c[1] == c[2] == torch.bfloat16 for c in calls)
    assert all(not torch.equal(before[k], v) for k, v in params.items())
    calls.clear()
    out = make_eval_step(model)(batch)
    assert len(calls) == 69 and 0.0 <= float(out["accuracy"]) <= 1.0


def test_trainer_two_epochs_and_resume_equal_jax_f32(gt_dir, tmp_path, monkeypatch):  # noqa: F811
    flags = {"epochs": 2, "steps_per_epoch": 2, "batch_size": 1, "crop_size": (64, 64),
             "eval_steps": 1, "n_classes": 3, "ema_decay": 0.5}
    gp = TINY["RU"]
    monkeypatch.setattr(jseg_trainer, "ARUNet",
                        lambda **kw: JARUNet(**{**kw, "dtype": jnp.float32}))
    runs = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name)
        for epochs in (2, 3):
            f = dict(flags, epochs=epochs)
            if name == "jax":
                trainer = jseg_trainer.TrainerSegmentation(
                    d, gt_dir, eval_gt_dir=gt_dir, flags=f, graph_params=gp)
            else:
                trainer = seg_trainer.TrainerSegmentation(
                    d, gt_dir, eval_gt_dir=gt_dir, flags=f, graph_params=gp,
                    device="cpu", compute_dtype=torch.float32,
                    init_params=_jax_init("RU"))
            runs[(name, epochs)] = trainer.train()
    for epochs in (2, 3):
        want, got = runs[("jax", epochs)], runs[("port", epochs)]
        assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]]
        for w, g in zip(want["history"], got["history"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5), (g, w)
            assert g["accuracy"] == pytest.approx(w["accuracy"], abs=1e-4), (g, w)
        assert set(got["best_metrics"]) == {"accuracy"}
    assert runs[("port", 3)]["history"][0]["epoch"] == 2
    # the resumed run's parameters equal the JAX trainer's
    jparams = _flat(runs[("jax", 3)]["state"]["params"])
    tparams = arunet_flax_from_state_dict(runs[("port", 3)]["state"]["params"])
    for k in jparams:
        scale = max(float(np.abs(jparams[k]).max()), 1e-30)
        assert float(np.abs(tparams[k] - jparams[k]).max()) / scale <= 1e-5, k
