"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
neither jax nor the JAX package, so on the machine with the card it runs
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2


def _k1_inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    w3 = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)   # HWIO
    bias = rng.randn(cout).astype(np.float32)
    return x, w3, bias


def _to_oihw(w3):
    return torch.from_numpy(np.ascontiguousarray(w3.transpose(3, 2, 0, 1)))


def _synthetic(h=96, w=300, seed=0):
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w), np.float32)
    img[40:43, 10:290] = 255.0          # horizontal rule
    img[5:90, 150:153] = 255.0          # vertical rule
    img[(rng.rand(h, w) < 0.01)] = 255.0  # noise
    return img


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the main path's smallest instance (4 x 96 x 68) has fewer tiles than the
# card has SMs; (3, 37, 131) is ragged against every tile size
_K1_CASES = [(pair, (2, 45, 70)) for pair in [
    (8, 8), (8, 16), (16, 32), (64, 32), (32, 16), (12, 8), (16, 16), (32, 32),
    (16, 8), (10, 8)]] + [((32, 16), (4, 96, 68)), ((64, 32), (4, 96, 68)),
                 ((8, 8), (3, 37, 131)), ((24, 32), (1, 7, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("pair,bhw", _K1_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain(cuda, pair, bhw, dtype):
    cin, cout = pair
    x, w3, bias = _k1_inputs(bhw + (cin, cout), seed=cin + cout)
    xt = torch.from_numpy(x).to(cuda, dtype)
    wt = _to_oihw(w3).to(cuda, dtype)
    bt = torch.from_numpy(bias).to(cuda, dtype)
    before = k1.launches
    got = k1.conv3x3(xt, wt, bt, relu=True)
    assert k1.launches == before + 1
    want = k1.conv3x3_plain(xt, wt, bt, relu=True)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= (1e-4 if dtype == torch.float32 else 2e-2 * scale), err


@pytest.mark.cuda
@pytest.mark.parametrize("kernels,hw", [
    ((15, 30, 10), (150, 700)), ((4, 6, 2), (150, 700)), ((45, 30, 25), (150, 700)),
    ((48, 30, 32), (150, 3200)), ((15, 30, 10), (131, 333))])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_separator_morphology_kernel_matches_plain(cuda, kernels, hw, dtype):
    imgs = np.stack([_synthetic(h=hw[0], w=hw[1], seed=s) for s in (0, 1, 2)])
    x = torch.from_numpy(imgs).to(cuda, dtype)
    before = k2.launches
    got_h, got_v = k2.separator_morphology(x, *kernels)
    assert k2.launches == before + 1
    want_h, want_v = k2.separator_morphology_plain(x, *kernels)
    assert torch.equal(got_v, want_v) and torch.equal(got_h, want_h)
    # a batch element that starts off a 16-byte boundary (odd H * W)
    got_h1, got_v1 = k2.separator_morphology(x[1:], *kernels)
    assert torch.equal(got_v1, want_v[1:]) and torch.equal(got_h1, want_h[1:])
