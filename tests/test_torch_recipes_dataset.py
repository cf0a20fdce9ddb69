"""The pipeline recipe's dataset (``citlab_as_tpu_torch/scripts/
train_pipeline_gnn.py::build_dataset``) against the JAX script's, on the
CPU: two drawn pages through the committed separator net
(``models_ckpt/separator``, bf16), the blind text regions with the GT
article ids restored, and the feature generator. The feature JSONs equal
the JAX script's: the same keys, graphs, edges, relations and region
polygons, the float features within 1e-6.
"""
import json
import os

from citlab_as_tpu_torch.scripts.train_pipeline_gnn import build_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEPARATOR = os.path.join(REPO, "models_ckpt", "separator")


def _assert_same_json(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_json(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_build_dataset_equals_jax(tmp_path):
    from scripts.train_pipeline_gnn import build_dataset as jbuild_dataset
    want_paths = jbuild_dataset(str(tmp_path / "jax"), 2, SEPARATOR, seed=0)
    got_paths = build_dataset(str(tmp_path / "port"), 2, SEPARATOR, seed=0, device="cpu")
    assert [os.path.basename(p) for p in got_paths] == [os.path.basename(p) for p in want_paths]
    assert len(got_paths) == 2
    for got_path, want_path in zip(got_paths, want_paths):
        with open(got_path) as g, open(want_path) as w:
            got, want = json.load(g), json.load(w)
        assert want["num_nodes"] >= 4 and want["gt_num_relations"] >= want["num_nodes"]
        assert "visual_regions_nodes" in want
        _assert_same_json(got, want)
