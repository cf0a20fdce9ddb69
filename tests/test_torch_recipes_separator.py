"""The separator recipe (``citlab_as_tpu_torch/scripts/
train_synthetic_separator.py``) against the JAX script's ``step`` and
``eval_metrics`` bodies, on the CPU, in float32 (the script computes in
bf16; float32 makes the two libraries comparable at float32's tolerance).

From the same flax init (converted) and the same two numpy batches of
synthetic 64 x 64 pages: each step's class-weighted loss within 1e-5
relative, the parameters after the steps within 1e-5 relative per leaf,
and accuracy, precision and recall of class 0 on an eval batch within one
pixel's share. The recipe's checkpoint loads in the JAX package's
``SegmentationPredictor`` with the port's probabilities (1e-5), and the
recipe's ``main`` runs end to end.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from citlab_as_tpu.inference import SegmentationPredictor as JSegmentationPredictor
from citlab_as_tpu.models.arunet import ARUNet as JARUNet
from citlab_as_tpu.train.segmentation import segmentation_loss as jsegmentation_loss
from citlab_as_tpu_torch.inference import SegmentationPredictor
from citlab_as_tpu_torch.scripts import train_synthetic_separator as recipe
from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict, arunet_state_dict_from_flax

CROP, BATCH, STEPS, LR, WEIGHT = 64, 2, 2, 1e-3, 8.0
CPU = torch.device("cpu")


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(tree).items()}


def _jax_recipe():
    """The JAX script's model, optimizer, ``step`` and ``eval_metrics``
    (scripts/train_synthetic_separator.py:36-78), fed numpy batches in
    place of its on-device generator."""
    model = JARUNet(n_classes=2, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 1)))
    optimizer = optax.adam(optax.cosine_decay_schedule(LR, STEPS, alpha=0.1))
    class_weights = jnp.asarray([WEIGHT, 1.0])

    @jax.jit
    def step(params, opt_state, image, label):
        def loss_fn(p):
            logits, _ = model.apply(p, image, train=True)
            return jsegmentation_loss(logits, label, class_weights=class_weights)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def eval_metrics(params, image, label):
        logits, _ = model.apply(params, image)
        pred = jnp.argmax(logits, axis=-1)
        acc = jnp.mean((pred == label).astype(jnp.float32))
        target = label == 0
        hit = (pred == 0) & target
        recall = hit.sum() / jnp.maximum(target.sum(), 1)
        precision = hit.sum() / jnp.maximum((pred == 0).sum(), 1)
        return acc, precision, recall

    return params, optimizer.init(params), step, eval_metrics


def _numpy_batch(step):
    batch = recipe.recipe_batch(0, step, BATCH, CROP, False, CPU)
    return batch["image"].numpy(), batch["label"].numpy()


def test_separator_recipe_steps_and_checkpoint_equal_jax(tmp_path):
    jparams, jstate, jstep, jeval = _jax_recipe()
    model, params, opt_state, step = recipe.build(STEPS, LR, WEIGHT, 0, CPU,
                                                  dtype=torch.float32)
    model.load_state_dict(arunet_state_dict_from_flax(_flat(jparams)))
    for i in range(STEPS):
        image, label = _numpy_batch(i)
        assert label.dtype == np.int32 and (label == 0).any()
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(image), jnp.asarray(label))
        loss = step(params, opt_state, {"image": torch.from_numpy(image),
                                        "label": torch.from_numpy(label)})
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), i
    got = arunet_flax_from_state_dict(model.state_dict())
    for k, want in _flat(jparams).items():
        assert np.linalg.norm(got[k] - want) <= 1e-5 * np.linalg.norm(want), k
    image, label = _numpy_batch(recipe.EVAL_STEP)
    want = [float(v) for v in jeval(jparams, jnp.asarray(image), jnp.asarray(label))]
    got = recipe.evaluate(model, {"image": torch.from_numpy(image),
                                  "label": torch.from_numpy(label)})
    assert got == pytest.approx(want, abs=1.0 / (BATCH * CROP * CROP))

    path = recipe.save(str(tmp_path / "model"), STEPS, model)
    assert path.endswith(f"/{STEPS}")
    page = np.random.RandomState(3).rand(96, 128).astype(np.float32)
    want = JSegmentationPredictor(str(tmp_path / "model"), dtype=jnp.float32)(page)
    got = SegmentationPredictor(str(tmp_path / "model"), dtype=torch.float32, device="cpu")(page)
    assert got.shape == want.shape == (96, 128, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_separator_recipe_main_runs(tmp_path, capsys):
    acc, precision, recall = recipe.main([
        "--model_dir", str(tmp_path / "m"), "--steps", "2", "--batch", "1",
        "--crop", "64", "--device", "cpu"])
    assert all(0.0 <= v <= 1.0 for v in (acc, precision, recall))
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "step 1: loss=" in out and "final: acc=" in out
    assert (tmp_path / "m" / "2" / "manifest.ocdbt").is_file()
