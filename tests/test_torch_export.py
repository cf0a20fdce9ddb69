"""The port's ``.frozen`` artifacts and its stdlib msgpack codec against the
JAX package's, on the CPU.

- ``utils/msgpack.py``: bytes equal to ``flax.serialization.to_bytes`` of
  the same nested dict; flax's bytes read back to bit-equal arrays (f32,
  bf16, int32, bool, 0-d, empty); chunked arrays over a lowered chunk size
  both ways;
- ``train/export.py``: a JAX ``export_frozen`` of an ARU-Net, a relation
  GNN and an Inception v3 loads in the port to bit-equal parameters and
  forwards within 1e-5 of flax's; a port-written artifact loads in the JAX
  ``load_frozen`` to bit-equal leaves; unknown architectures raise;
- the predictors: a frozen ARU-Net forward bit-equal to the ``.npz`` one
  with the 69 K1-routed convs, a frozen relation GNN beside the JAX
  predictor on the same artifact, ``run_export`` from a port trainer
  checkpoint served by ``RelationPredictor`` with the trainer's
  confidences (1e-6), and ``--model_dir x.frozen`` accepted by the CLIs.
"""
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization, traverse_util

from citlab_as_tpu.inference import RelationPredictor as JRelationPredictor
from citlab_as_tpu.models.arunet import ARUNet as JARUNet
from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
from citlab_as_tpu.models.inception_v3 import InceptionV3 as JInceptionV3
from citlab_as_tpu.train import export as jexport
from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
from citlab_as_tpu_torch.models import arunet as tarunet
from citlab_as_tpu_torch.train import export as texport
from citlab_as_tpu_torch.utils import msgpack as tmsgpack
from citlab_as_tpu_torch.weights import arunet_flax_from_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TOL = 1e-5
SMALL_ARU = {"featRoot": 8, "scale_space_num": 3, "res_depth": 1, "num_scales_att": 2}


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _unflat(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _seeded(shapes, seed):
    """Seeded float32 values on a flax variable tree's shapes (flax's
    constant starts would hide a mis-mapped bias or statistic)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(shapes, sep="/").items():
        if path.endswith("kernel"):
            value = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif path.endswith(("scale", "var")):
            value = rng.rand(*leaf.shape) * 0.5 + 0.75
        else:
            value = rng.randn(*leaf.shape) * 0.1
        out[path] = value.astype(np.float32)
    return out


# ---------------------------------------------------------------- msgpack

def test_msgpack_bytes_equal_flax():
    rng = np.random.RandomState(0)
    tree = {"params": {"conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32),
                                "bias": np.zeros(4, np.float32)},
                       "Dense_0": {"kernel": rng.randn(70, 3).astype(np.float32)}},
            "batch_stats": {"mean": np.arange(5, dtype=np.int64), "scalar": np.float32(1.5)},
            "meta": {"int": 7, "neg": -300, "big": 2 ** 40, "float": 0.25, "flag": False,
                     "none": None, "text": "é" * 40, "blob": b"\x00\x01" * 200,
                     "seq": [1, (2.5, "x")], "complex": complex(1, -2),
                     "wide": {str(i): i for i in range(20)}}}
    assert tmsgpack.packb(tree) == serialization.to_bytes(tree)


def test_msgpack_reads_flax_arrays_bit_for_bit():
    rng = np.random.RandomState(1)
    bf16 = jnp.asarray(rng.randn(3, 5), jnp.bfloat16)
    tree = {"f32": rng.randn(4, 3).astype(np.float32), "bf16": np.asarray(bf16),
            "i32": rng.randint(-9, 9, (2, 2, 2)).astype(np.int32),
            "bool": rng.rand(7) > 0.5, "zero_d": np.asarray(3.25, np.float32),
            "empty": np.zeros((0, 3), np.float32), "npscalar": np.int32(-4)}
    got = tmsgpack.unpackb(serialization.to_bytes(tree))
    for key in ("f32", "i32", "bool", "zero_d", "empty"):
        assert got[key].dtype == tree[key].dtype and got[key].shape == tree[key].shape
        np.testing.assert_array_equal(got[key], tree[key])
    assert got["bf16"].dtype == torch.bfloat16 and tuple(got["bf16"].shape) == (3, 5)
    np.testing.assert_array_equal(got["bf16"].view(torch.int16).numpy(),
                                  np.asarray(bf16).view(np.int16))
    assert got["npscalar"] == -4 and got["npscalar"].dtype == np.int32
    # and the port's bf16 tensors write flax's bytes
    tree["bf16"] = got["bf16"]
    restored = serialization.msgpack_restore(tmsgpack.packb(tree))
    np.testing.assert_array_equal(np.asarray(restored["bf16"]).view(np.int16),
                                  np.asarray(bf16).view(np.int16))


def test_msgpack_chunked_arrays_both_ways(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 100)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 100)
    rng = np.random.RandomState(2)
    tree = {"a": {"big": rng.randn(9, 7).astype(np.float32),
                  "small": np.arange(3, dtype=np.float32)}, "b": rng.randn(40)}
    flax_bytes = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in flax_bytes
    assert tmsgpack.packb(tree) == flax_bytes
    for got in (tmsgpack.unpackb(flax_bytes),
                serialization.msgpack_restore(tmsgpack.packb(tree))):
        np.testing.assert_array_equal(got["a"]["big"], tree["a"]["big"])
        np.testing.assert_array_equal(got["b"], tree["b"])


# ---------------------------------------------------------------- .frozen

def _jax_artifact(tmp_path, name, model, example, kwargs, seed):
    flat = _seeded(jax.eval_shape(model.init, jax.random.PRNGKey(0), example), seed)
    path = str(tmp_path / f"{name}.frozen")
    jexport.export_frozen(path, name, _unflat(flat), model_kwargs=kwargs,
                          metadata={"seed": seed})
    return path, flat


def _assert_same_leaves(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_jax_frozen_arunet_loads_in_the_port(tmp_path):
    x = np.random.RandomState(3).rand(2, 48, 40, 1).astype(np.float32)
    kwargs = {"graph_params": SMALL_ARU, "dtype": jnp.float32}
    jmodel = JARUNet(**kwargs)
    path, flat = _jax_artifact(tmp_path, "arunet", jmodel, jnp.asarray(x), kwargs, 4)
    model, variables, meta = texport.load_frozen(path)
    assert meta == {"seed": 4} and isinstance(model, tarunet.ARUNet)
    _assert_same_leaves(variables, flat)
    _assert_same_leaves(arunet_flax_from_state_dict(model.state_dict()), flat)
    want = np.asarray(jmodel.apply(_unflat(flat), jnp.asarray(x))[0])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_jax_frozen_inception_loads_in_the_port(tmp_path):
    x = np.random.RandomState(5).rand(1, 75, 83, 1).astype(np.float32)
    jmodel = JInceptionV3()
    path, flat = _jax_artifact(tmp_path, "inception_v3", jmodel, jnp.asarray(x), {}, 6)
    assert any(k.startswith("batch_stats/") for k in flat)
    model, variables, _ = texport.load_frozen(path)
    _assert_same_leaves(variables, flat)
    _assert_same_leaves(texport.flax_variables("inception_v3", model), flat)
    want, _ = jmodel.apply(_unflat(flat), jnp.asarray(x))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _graphs(rng, sizes, dn=15, de=2):
    out = []
    for n in sizes:
        edges = [[i, j] for i in range(n) for j in range(n) if i != j and rng.rand() < 0.5]
        out.append({"num_nodes": n, "interacting_nodes": edges,
                    "node_features": rng.rand(n, dn).tolist(),
                    "edge_features": rng.rand(len(edges), de).tolist()})
    return out


@pytest.mark.parametrize("kwargs", [
    {},
    {"gnn_params": {"compress_node_feature_dim": 12, "output_type": "concat_final_hidden_and_input"},
     "message_params": {"use_attention": True, "num_attention_heads": 2},
     "classifier_hidden": [24]},
], ids=["defaults", "compressed-attention"])
def test_jax_frozen_graph_relation_serves_in_the_port(tmp_path, kwargs):
    """The JAX predictor and the port's on one artifact: the port reads the
    GNN's input widths off its variables, confidences within 1e-5."""
    rng = np.random.RandomState(7)
    graphs = _graphs(rng, (5, 9, 4), dn=13, de=3)
    jpred = JRelationPredictor(None)
    batch, _ = jpred._batch_inputs(graphs, None)
    path, flat = _jax_artifact(tmp_path, "graph_relation", JGraphRelation(**kwargs),
                               batch, kwargs, 8)
    model, variables, _ = texport.load_frozen(path)
    _assert_same_leaves(variables, flat)
    assert model.GraphLSTM1.out_dim > 0
    want = JRelationPredictor(path).confidences_batch(graphs)
    got = RelationPredictor(path, device="cpu").confidences_batch(graphs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


def test_port_frozen_loads_in_jax(tmp_path):
    """Artifacts the port writes (from modules and from flat variables)
    load in the JAX package's ``load_frozen`` to bit-equal leaves and the
    same config."""
    from citlab_as_tpu_torch.models.gnn.model import GraphRelation
    from citlab_as_tpu_torch.models.inception_v3 import InceptionV3
    aru = tarunet.ARUNet(graph_params=SMALL_ARU).init_random(1)
    gnn = GraphRelation(7, 2)
    inc = InceptionV3().init_random(2)
    with torch.no_grad():
        for buf in inc.buffers():
            if buf.dtype.is_floating_point:
                buf.uniform_(0.5, 1.5)
    for name, module, kwargs in (("arunet", aru, {"graph_params": SMALL_ARU,
                                                   "dtype": torch.bfloat16}),
                                 ("graph_relation", gnn, {"num_classes": 2}),
                                 ("inception_v3", inc, {})):
        path = str(tmp_path / f"{name}.frozen")
        texport.export_frozen(path, name, module, model_kwargs=kwargs)
        want = texport.flax_variables(name, module)
        jmodel, jvars, meta = jexport.load_frozen(path)
        assert meta == {}
        _assert_same_leaves(_flat(jvars), want)
        with zipfile.ZipFile(path) as zf:
            config = json.loads(zf.read("config.json"))
        assert config["architecture"] == name
        if name == "arunet":
            assert config["model_kwargs"]["dtype"] == "bfloat16"
            assert jmodel.dtype == jnp.bfloat16
        # the port reads its own artifact back to the same leaves
        _assert_same_leaves(texport.read_frozen(path)[1], want)


def test_unknown_architecture_raises(tmp_path):
    with pytest.raises(ValueError, match="Unknown architecture"):
        texport.export_frozen(str(tmp_path / "x.frozen"), "resnet", {})
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("config.json", json.dumps({"format_version": 1, "architecture": "resnet",
                                               "model_kwargs": {}}))
        zf.writestr("params.msgpack", tmsgpack.packb({}))
    path = tmp_path / "y.frozen"
    path.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="Unknown architecture"):
        texport.load_frozen(str(path))
    with pytest.raises(ValueError, match="Unknown architecture"):
        jexport.load_frozen(str(path))


def test_frozen_arunet_predictor_equals_npz(tmp_path, monkeypatch):
    """The committed separator net, exported to a bf16 ``.frozen``: the
    predictor's probabilities equal the ``.npz`` predictor's bit for bit,
    and each forward routes 69 convs to K1 (counted through the plain
    version here)."""
    npz = os.path.join(REPO, "models_ckpt_torch", "separator.npz")
    frozen = str(tmp_path / "separator.frozen")
    texport.export_checkpoint_frozen(npz, frozen, "arunet",
                                     model_kwargs={"dtype": "bfloat16"})
    calls = []
    plain = tarunet.conv3x3

    def counting(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    monkeypatch.setattr(tarunet, "conv3x3", counting)
    image = np.random.RandomState(9).rand(70, 90).astype(np.float32)
    outs = []
    for path in (npz, frozen):
        calls.clear()
        pred = SegmentationPredictor(path, device="cpu")
        assert next(pred.model.parameters()).dtype == torch.bfloat16
        outs.append(pred.predict_batch([image, image[:50]]))
        assert len(calls) == 69
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_run_export_from_a_trainer_checkpoint(tmp_path):
    """``run_export`` freezes the newest numbered checkpoint of a port
    trainer; ``RelationPredictor`` serves it with the trainer's
    confidences, and ``run_gnn_clustering`` takes it as ``--model_dir``."""
    from citlab_as_tpu_torch.cli import run_export
    from citlab_as_tpu_torch.cli.common import model_path
    from citlab_as_tpu_torch.train.input_pipeline import torch_batch
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    rng = np.random.RandomState(10)
    paths = []
    for g, graph in enumerate(_graphs(rng, (6, 5, 7))):
        n = graph["num_nodes"]
        graph["gt_relations"] = [[1, i, j] for i in range(n) for j in range(n)
                                 if (i < 3) == (j < 3)]
        paths.append(str(tmp_path / f"g{g}.json"))
        with open(paths[-1], "w") as f:
            json.dump(graph, f)
    model_dir = str(tmp_path / "gnn")
    trainer = TrainerGNN(model_dir, paths, [], flags={"epochs": 1, "samples_per_epoch": 4,
                                                       "batch_size": 2},
                         seed=0, device="cpu")
    trainer.train()
    out = str(tmp_path / "gnn.frozen")
    assert run_export.main(["--checkpoint_dir", model_dir, "--out", out,
                            "--architecture", "graph_relation"]) == out
    pred = RelationPredictor(out, device="cpu")
    for path in paths:
        batch_np, _, graph = next(trainer.input_fn.eval_batches([path]))
        n = int(graph["num_nodes"])
        with torch.no_grad():
            want = trainer.predict(torch_batch(batch_np, "cpu")).numpy()[0, :n * n]
        got = pred.confidences(graph)
        np.testing.assert_allclose(got, want.reshape(n, n), rtol=0, atol=1e-6)
    assert model_path(None, out) == out and model_path("m.npz", None) == "m.npz"
    # a trainer's model directory is taken as --model_dir (the JAX CLIs'
    # orbax directories and the port's own): its newest step's params
    assert model_path(None, model_dir) == model_dir
    direct = RelationPredictor(model_dir, device="cpu")
    for path in paths:
        graph = next(trainer.input_fn.eval_batches([path]))[2]
        np.testing.assert_array_equal(direct.confidences(graph), pred.confidences(graph))
    with pytest.raises(ValueError, match="not both"):
        model_path("m.npz", out)


# ---------------------------------------------------------------- flags

def _registry(module):
    flags = module.Flags()
    flags.define_string("name", "x", "a string")
    flags.define_integer("steps", 3, "an int")
    flags.define_float("rate", 0.5, "a float")
    flags.define_boolean("verbose", False, "a bool")
    flags.define_list("layers", ["a"], "a list")
    flags.define_list("sizes", [1], "int list", flag_type=int)
    flags.define_choices("mode", ["fast", "slow"], "fast", str, "a choice")
    flags.define_dict("graph_params", {}, "a dict")
    return flags


def test_flag_registry_equals_jax(tmp_path, capsys):
    """``Flags`` with every ``define_*``, a config file read through
    ``@file`` (comments, ``=`` separators), ``print_flags`` and
    ``update_params``: values and printed output equal the JAX module's."""
    from citlab_as_tpu.config import flags as jflags
    from citlab_as_tpu_torch.config import flags as tflags
    config = tmp_path / "train.cfg"
    config.write_text("# a comment line\n--steps = 7   # trailing comment\n"
                      "--verbose t\n--layers a b c\n--sizes 4 5\n"
                      "--graph_params featRoot=12 mvn=True scale=0.25 lst=[1,2,x] bad\n")
    argv = ["@" + str(config), "--rate", "2.5", "--mode", "slow", "--unknown", "1"]
    outs = {}
    for name, module in (("jax", jflags), ("port", tflags)):
        flags = _registry(module)
        unparsed = flags.parse_flags(argv)
        module.print_flags(flags)
        merged = module.update_params({"featRoot": 8, "mvn": False}, flags.graph_params,
                                      name="graph", print_params=True)
        flags.extra = "set"
        outs[name] = (unparsed, flags.as_dict(), merged, flags.has_key("extra"),
                      flags.hasKey("nope"), capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["steps"] == 7 and outs["port"][1]["graph_params"]["lst"] == [1, 2, "x"]
    for module in (jflags, tflags):
        assert module.reset_flags() is module.FLAGS
        module.define_integer("k", 2, "k")
        assert module.FLAGS.parse_flags(["--k", "5"]) == [] and module.FLAGS.k == 5
        module.reset_flags()
    assert tflags.parse_dict_flag("a=1,b=[x],c=f") == jflags.parse_dict_flag("a=1,b=[x],c=f")
    with pytest.raises(AttributeError):
        getattr(_registry(tflags), "_private")


def test_line_argument_parser_reads_arg_files_as_jax(tmp_path):
    from citlab_as_tpu.config.flags import LineArgumentParser as JParser
    from citlab_as_tpu_torch.config.flags import LineArgumentParser as TParser
    args = tmp_path / "export.args"
    args.write_text("--checkpoint_dir = ckpt  # the run\n--out out.frozen\n"
                    "# --architecture inception_v3\n--architecture arunet\n")
    parsed = []
    for cls in (JParser, TParser):
        p = cls(fromfile_prefix_chars="@")
        for flag in ("--checkpoint_dir", "--out", "--architecture"):
            p.add_argument(flag)
        parsed.append(vars(p.parse_args(["@" + str(args)])))
    assert parsed[0] == parsed[1] == {"checkpoint_dir": "ckpt", "out": "out.frozen",
                                      "architecture": "arunet"}
