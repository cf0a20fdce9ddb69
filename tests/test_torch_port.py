"""Port-wide checks: the weight converter, import hygiene (no jax, flax or
citlab_as_tpu inside the port or chip_smoke.py), and device resolution."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "citlab_as_tpu_torch")
SEP_NPZ = os.path.join(REPO, "models_ckpt_torch", "separator.npz")
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "citlab_as_tpu")


def test_converter_reproduces_committed_npz(tmp_path):
    out = tmp_path / "separator.npz"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "convert_weights_to_torch.py"),
         "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stdout + r.stderr
    with np.load(SEP_NPZ) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_covers_every_parameter():
    from citlab_as_tpu_torch.models.arunet import ARUNet
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz
    sd = arunet_state_dict_from_flax(load_npz(SEP_NPZ))
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
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN and m.split(".")[0] != "citlab_as_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_running_the_slice_loads_no_jax_module():
    """Import the port and run the separator slice on the CPU in a fresh
    process (conftest.py has loaded jax in this one)."""
    code = r"""
import sys
import numpy as np, torch
import chip_smoke
import citlab_as_tpu_torch
from citlab_as_tpu_torch.inference import SegmentationPredictor
from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
pred = SegmentationPredictor(None, graph_params={"featRoot": 4, "scale_space_num": 3,
                             "res_depth": 1, "num_scales_att": 2},
                             dtype=torch.float32, pad_multiple=16, device="cpu")
pages, _ = chip_smoke.synthetic_pages(2, 48, 40, seed=0)
out = SeparatorNetPostProcessor(pages, pred, fixed_height=32).run_batched(2)
assert len(out) == 2 and all(isinstance(d, dict) for d in out)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax",
                                    "citlab_as_tpu"))
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
