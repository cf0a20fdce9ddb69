"""The port's ARU-Net against the flax ARU-Net, at float32 on the CPU, with
the same parameters carried across by ``weights.arunet_state_dict_from_flax``
and the same numpy inputs. Tolerance: atol 1e-4 on logits (float32 convs
summed in another order)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn
from flax import traverse_util

from citlab_as_tpu.models.arunet import ARUNet as FlaxARUNet
from citlab_as_tpu.models.arunet import _upsample_sum as flax_upsample_sum
from citlab_as_tpu_torch.models import arunet as tarunet
from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEP_NPZ = os.path.join(REPO, "models_ckpt_torch", "separator.npz")


def _flat(variables):
    return {k: v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v)
            for k, v in traverse_util.flatten_dict(variables, sep="/").items()}


def _unflatten(flat):
    return traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _port(flat, gp):
    model = tarunet.ARUNet(n_classes=2, graph_params=gp)
    model.load_state_dict(arunet_state_dict_from_flax(flat))   # strict
    return model.eval()


@pytest.mark.parametrize("gp,shape", [
    ({"graph": "RU", "featRoot": 8, "scale_space_num": 3, "res_depth": 1},
     (1, 37, 53, 1)),
    ({"graph": "RU", "featRoot": 8, "scale_space_num": 3, "res_depth": 1},
     (2, 48, 64, 1)),
    ({"graph": "ARU", "featRoot": 8, "scale_space_num": 3, "res_depth": 1,
      "num_scales_att": 2}, (2, 45, 61, 1)),
    ({"graph": "ARU", "featRoot": 8, "scale_space_num": 3, "res_depth": 1,
      "num_scales_att": 2, "mvn": True}, (1, 33, 40, 1)),
    ({"graph": "U", "featRoot": 4, "scale_space_num": 3}, (1, 30, 41, 1)),
])
def test_arunet_random_params_match_flax(gp, shape):
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    fm = FlaxARUNet(n_classes=2, graph_params=gp)
    shapes = _flat(jax.eval_shape(fm.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.RandomState(3)
    # flax's init scale, sqrt(2 / (kh*kw*cin + cout)); biases near 0.1
    flat = {k: (rng.randn(*s.shape) * (np.sqrt(2.0 / (np.prod(s.shape[:3]) + s.shape[3]))
                                       if k.endswith("kernel") else 0.02) + (
                0.0 if k.endswith("kernel") else 0.1)).astype(np.float32)
            for k, s in shapes.items()}
    want, _ = jax.jit(fm.apply)(_unflatten(flat), jnp.asarray(x))
    with torch.no_grad():
        got = _port(flat, gp)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_arunet_trained_separator_weights_match_flax():
    """The committed separator.npz, full config (featRoot 8, 5 scales,
    3 attention scales, res_depth 3), on a 128 x 192 input."""
    flat = load_npz(SEP_NPZ)
    assert sum(v.size for v in flat.values()) == 1043839 and len(flat) == 90
    x = np.random.RandomState(5).rand(1, 128, 192, 1).astype(np.float32)
    want, _ = jax.jit(FlaxARUNet(n_classes=2).apply)(_unflatten(flat),
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = _port(flat, None)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_k1_routing_counts_69_convs_per_forward():
    """The convs routed to K1 are exactly those JAX routes to its Pallas
    kernel: 23 per detCNN pass at the separator config, 3 passes."""
    model = tarunet.ARUNet()
    routed = [m for m in model.featMapG.modules()
              if isinstance(m, tarunet._Conv) and m.use_k1]
    assert len(routed) == 23
    pairs = {(m.weight.shape[1], m.weight.shape[0]) for m in routed}
    assert pairs == {(8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (64, 32),
                     (32, 16), (16, 8)}
    assert not any(m.use_k1 for m in model.attMapG.modules()
                   if isinstance(m, tarunet._Conv))
    assert not model.logit.use_k1
    assert len(routed) * model.gp["num_scales_att"] == 69


def test_k1_instance_table_of_the_chip_check_matches_a_forward(monkeypatch):
    """``chip_smoke.k1_main_path_instances`` (the 24 (pair, shape) rows
    timed on the card) lists exactly what one ARU forward sends through
    K1: same shapes, same launch counts."""
    import collections

    import chip_smoke
    monkeypatch.setattr(chip_smoke, "K1_SHAPE", (1, 64, 48))
    seen = collections.Counter()
    real = tarunet.conv3x3

    def recording(x, weight, bias, relu=False):
        seen[(x.shape[3], weight.shape[0], x.shape[1], x.shape[2])] += 1
        return real(x, weight, bias, relu)

    model = tarunet.ARUNet().init_random(0)
    monkeypatch.setattr(tarunet, "conv3x3", recording, raising=True)
    # _Conv.forward looks conv3x3 up in the module at call time
    with torch.no_grad():
        model(torch.zeros(1, 64, 48, 1))
    want = {(cin, cout, h, w): n
            for cin, cout, h, w, n in chip_smoke.k1_main_path_instances()}
    assert len(want) == 24 and dict(seen) == want


@pytest.mark.parametrize("n", [5, 6, 7, 8])
def test_conv_transpose_same_matches_flax(n):
    """flax ConvTranspose(padding="SAME", strides=2) — unflipped kernel,
    lax.conv_transpose padding — equals the port's _Deconv (flipped
    kernel, F.conv_transpose2d) before and after the crop."""
    rng = np.random.RandomState(n)
    x = rng.randn(1, n, n + 1, 4).astype(np.float32)
    layer = nn.ConvTranspose(3, (3, 3), strides=(2, 2), padding="SAME")
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.maximum(np.asarray(layer.apply(variables, jnp.asarray(x))), 0)
    assert want.shape == (1, 2 * n, 2 * (n + 1), 3)
    deconv = tarunet._Deconv(4, 3, 3, 2, "relu")
    sd = arunet_state_dict_from_flax(
        {f"d/deconv/{k}": np.asarray(v) for k, v in variables["params"].items()})
    deconv.load_state_dict({"weight": sd["d.weight"], "bias": sd["d.bias"]})
    with torch.no_grad():
        full = deconv(torch.from_numpy(x), (2 * n, 2 * (n + 1)))
        crop = deconv(torch.from_numpy(x), (2 * n - 1, 2 * n + 1))
    np.testing.assert_allclose(full.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(crop.numpy(), want[:, :2 * n - 1, :2 * n + 1], atol=1e-5)


def test_even_4x4_same_conv_pads_1_2():
    x = np.random.RandomState(0).randn(1, 9, 10, 3).astype(np.float32)
    layer = nn.Conv(5, (4, 4), padding="SAME")
    variables = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))
    conv = tarunet._Conv(3, 5, 4, None)
    sd = arunet_state_dict_from_flax(
        {f"c/conv/{k}": np.asarray(v) for k, v in variables["params"].items()})
    conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (5, 12)])
def test_same_pools_match_flax_on_odd_sizes(hw):
    x = np.random.RandomState(sum(hw)).randn(2, *hw, 3).astype(np.float32)
    for flax_pool, port_pool in ((nn.max_pool, tarunet._max_pool),
                                 (nn.avg_pool, tarunet._avg_pool)):
        want = np.asarray(flax_pool(jnp.asarray(x), (2, 2), strides=(2, 2),
                                    padding="SAME"))
        got = port_pool(torch.from_numpy(x), 2)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_upsample_sum_quirk_matches():
    x = np.arange(24, dtype=np.float32).reshape(1, 3, 4, 2)
    want = np.asarray(flax_upsample_sum(jnp.asarray(x), 2, (5, 7), 3))
    got = tarunet._upsample_sum(torch.from_numpy(x), 2, (5, 7), 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_to_multiple():
    padded, hw = tarunet.pad_to_multiple(torch.zeros(1, 30, 45, 1), 16)
    assert tuple(padded.shape) == (1, 32, 48, 1) and hw == (30, 45)


def test_predictor_cpu_softmax_and_crop():
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    pred = SegmentationPredictor(None, graph_params={
        "graph": "RU", "featRoot": 8, "scale_space_num": 3, "res_depth": 1},
        dtype=torch.float32, pad_multiple=32, device="cpu")
    images = [np.random.RandomState(i).rand(40, 50).astype(np.float32)
              for i in range(2)]
    out = pred.predict_batch(images)
    assert [o.shape for o in out] == [(40, 50, 2)] * 2
    np.testing.assert_allclose(out[0].sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(pred(images[1]), out[1], atol=1e-6)


def test_predict_is_the_softmax_of_the_logits_as_in_flax():
    """``ARUNet.predict``: the JAX package's ``ARUNet.predict(variables,
    inputs)`` at tiny widths from the same (converted) random parameters,
    the probabilities within 1e-5, float32, [B, H, W, n_classes]."""
    gp = {"graph": "ARU", "featRoot": 4, "scale_space_num": 3, "res_depth": 1,
          "num_scales_att": 2}
    x = np.random.RandomState(11).rand(2, 40, 56, 1).astype(np.float32)
    fm = FlaxARUNet(n_classes=3, graph_params=gp)
    variables = jax.jit(fm.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(jax.jit(fm.predict)(variables, jnp.asarray(x)))
    model = tarunet.ARUNet(n_classes=3, graph_params=gp)
    model.load_state_dict(arunet_state_dict_from_flax(_flat(variables)))
    with torch.no_grad():
        got = model.eval().predict(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 40, 56, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
