"""K1 (``ops/kernels/conv3x3.py``) under autograd, on the CPU: the wrapper's
``Conv3x3Function`` against autograd through ``conv3x3_plain`` and against
``jax.grad`` of the JAX package's flax conv layer at the same numpy
weights; a tiny ARU-Net gets a gradient for every parameter; under
``no_grad`` the Function is never entered; the packed-weight cache repacks
after an in-place optimizer update.

Tolerance: f32 gradients within 1e-5 relative to their largest entry
(sums of up to 9 * Cin * B * H * W products in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1

PAIRS = [(8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (16, 8), (32, 16), (64, 32)]
RTOL = 1e-5


def _inputs(cin, cout, seed, b=2, h=11, w=13):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wt = (rng.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin + cout))).astype(np.float32)
    bias = (0.1 + 0.02 * rng.randn(cout)).astype(np.float32)
    gy = rng.randn(b, h, w, cout).astype(np.float32)
    return x, wt, bias, gy


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= RTOL, f"{what}: error {err:.3g} of the largest entry"


def _torch_grads(fn, x, wt, bias, gy, relu):
    ts = [torch.tensor(a, requires_grad=True) for a in (x, wt, bias)]
    y = fn(*ts, relu=relu)
    y.backward(torch.tensor(gy))
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


def _flax_grads(x, wt, bias, gy, relu):
    """jax.grad of the reference's flax ``_Conv`` (SAME 3x3 + bias, then
    ReLU or nothing) with the kernel in flax's HWIO layout."""
    from citlab_as_tpu.models.arunet import _Conv
    layer = _Conv(features=wt.shape[0], kernel=3, act=jax.nn.relu if relu else None)

    def loss(xj, kj, bj):
        y = layer.apply({"params": {"conv": {"kernel": kj, "bias": bj}}}, xj)
        return jnp.sum(y * gy), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(bias))
    gx, gk, gb = (np.asarray(g) for g in grads)
    return np.asarray(y), [gx, gk.transpose(3, 2, 0, 1), gb]


@pytest.mark.parametrize("relu", [False, True], ids=["identity", "relu"])
@pytest.mark.parametrize("cin,cout", PAIRS)
def test_gradients_equal_plain_and_flax(cin, cout, relu):
    x, wt, bias, gy = _inputs(cin, cout, seed=cin * 100 + cout + relu)
    y, grads = _torch_grads(k1.conv3x3, x, wt, bias, gy, relu)
    y_plain, grads_plain = _torch_grads(k1.conv3x3_plain, x, wt, bias, gy, relu)
    y_flax, grads_flax = _flax_grads(x, wt, bias, gy, relu)
    _close(y, y_flax, "forward vs flax")
    for name, g, gp, gf in zip(("x", "weight", "bias"), grads, grads_plain, grads_flax):
        assert g.shape == gp.shape == gf.shape, name
        _close(g, gp, f"d{name} vs plain autograd")
        _close(g, gf, f"d{name} vs jax.grad")


def test_tiny_arunet_gets_every_gradient():
    from citlab_as_tpu_torch.models.arunet import ARUNet
    torch.manual_seed(0)
    model = ARUNet(n_classes=2, graph_params={"featRoot": 8, "scale_space_num": 2,
                                              "res_depth": 1, "num_scales_att": 2})
    model.init_random(0)
    entered = []
    real = k1.Conv3x3Function.apply

    def counting(*args):
        entered.append(1)
        return real(*args)
    k1.Conv3x3Function.apply = counting
    try:
        x = torch.rand(1, 32, 40, 1)
        model(x).square().mean().backward()
    finally:
        k1.Conv3x3Function.apply = real
    assert entered, "no conv went through K1's Function"
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or not p.grad.abs().sum() > 0]
    assert not missing, f"no gradient for {missing}"


def test_no_grad_never_enters_the_function(monkeypatch):
    from citlab_as_tpu_torch.models.arunet import ARUNet
    model = ARUNet(n_classes=2, graph_params={"featRoot": 8, "scale_space_num": 2,
                                              "res_depth": 1, "num_scales_att": 2})
    model.init_random(0)

    def refuse(*args):
        raise AssertionError("Conv3x3Function entered under no_grad")
    monkeypatch.setattr(k1.Conv3x3Function, "apply", refuse)
    with torch.no_grad():
        y = model(torch.rand(1, 32, 40, 1))
    assert torch.isfinite(y).all()
    x, wt, bias, _ = _inputs(8, 16, seed=1)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, wt, bias)]
    with torch.no_grad():
        y = k1.conv3x3(*ts, relu=True)
    assert not y.requires_grad
    # inference tensors that need no grad take the direct path under grad too
    y = k1.conv3x3(*(torch.tensor(a) for a in (x, wt, bias)), relu=True)
    assert not y.requires_grad


@pytest.mark.parametrize("foreach", [False, True])
def test_packed_weights_follow_in_place_optimizer_updates(foreach):
    w = torch.nn.Parameter(torch.randn(16, 8, 3, 3))
    first = k1._packed_weights(w)
    assert k1._packed_weights(w) is first              # cached
    w.grad = torch.randn_like(w)
    torch.optim.SGD([w], lr=0.1, foreach=foreach).step()
    second = k1._packed_weights(w)
    assert second is not first
    assert torch.equal(second, k1.pack_weights(w.detach()))
    assert not torch.equal(second, first)


def test_unsupported_inputs_still_raise_by_name():
    """On a CPU tensor the plain version runs; the Function keeps the
    wrapper's checks on a non-CPU, non-CUDA tensor."""
    x = torch.randn(1, 4, 4, 8, device="meta", requires_grad=True)
    w = torch.randn(16, 8, 3, 3, device="meta", requires_grad=True)
    b = torch.randn(16, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        k1.conv3x3(x, w, b)
