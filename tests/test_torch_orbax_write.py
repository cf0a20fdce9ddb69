"""The port's orbax checkpoints (``train/orbax.py`` ``save`` over
``utils/{ocdbt,zarr,zstd}.py``) held to the JAX package's, on the CPU, with
orbax, tensorstore and zstandard as the oracle.

Each test writes one state twice, with ``citlab_as_tpu.train.checkpoint``
and with the port, and runs the same JAX call on both directories:
``restore_checkpoint`` with each JAX trainer's template (adam, nadam,
rmsprop, sgd; with and without ``grad_accum_steps=2`` and EMA),
``restore_best``, ``warmstart_params`` with renames, both predictors of
``citlab_as_tpu.inference`` and ``export_checkpoint_frozen``; the results
are equal bit for bit (a call that fails on one fails on the other with
the same error). The JAX trainers resume a ``--model_dir`` the port's
trainers wrote, and their next epoch equals the port's own resumed epoch
within 1e-5 relative (the trainer parity tests' tolerance). Below them:
zstd frames against ``zstandard`` and the port's decoder, zarr arrays
against orbax's ``.zarray`` and tensorstore's reads, the OCDBT writer
against tensorstore, and the nine committed ``models_ckpt/`` directories
restored, re-written by the port and restored by orbax, leaf for leaf."""
import functools
import json
import os
import pathlib
import shutil
import tempfile
import zipfile

import numpy as np
import pytest
import torch

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

from citlab_as_tpu.train import checkpoint as jck  # noqa: E402
from citlab_as_tpu.train import input_pipeline as jinput  # noqa: E402
from citlab_as_tpu.train import optimizer as jopt  # noqa: E402
from citlab_as_tpu_torch import weights  # noqa: E402
from citlab_as_tpu_torch.train import checkpoint as tck  # noqa: E402
from citlab_as_tpu_torch.train import optimizer as topt  # noqa: E402
from citlab_as_tpu_torch.train import orbax as port  # noqa: E402
from citlab_as_tpu_torch.utils import ocdbt, zarr, zstd  # noqa: E402
from tests.test_seg_training import gt_dir  # noqa: E402,F401  (fixture: JAX GT generator)
from tests.test_torch_gnn_training import TRAINER_FLAGS, TRAINER_INPUT, _graphs  # noqa: E402
from tests.test_torch_orbax import COMMITTED, REPO, assert_same_tree, orbax_restore  # noqa: E402
from tests.test_training import _write_graph_jsons  # noqa: E402

RTOL = 1e-5
OPT_PARAMS = {"learning_rate": 0.01, "learning_circle": 1, "final_epochs": 2}
TINY_RU = {"graph": "RU", "featRoot": 4, "scale_space_num": 3, "res_depth": 1}


# ---------------------------------------------------------------- zstd frames

_RNG = np.random.default_rng(23)
FRAMES = {
    "empty": b"",
    "one_byte": b"\x07",
    "block_minus_1": _RNG.bytes(128 * 1024 - 1),
    "block": _RNG.bytes(128 * 1024),
    "block_plus_1": _RNG.bytes(128 * 1024 + 1),
    "zeros_block_plus_1": bytes(128 * 1024 + 1),
    "all_zero_1mb": bytes(1 << 20),
    "size_255": _RNG.bytes(255),
    "size_256": _RNG.bytes(256),
    "size_65791": _RNG.bytes(65791),
    "size_65792": _RNG.bytes(65792),
    "runs_and_noise": bytes(3 * 128 * 1024) + _RNG.bytes(999) + b"\xff" * 200_000,
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_zstd_frames_decode_in_zstandard_and_the_port(name):
    data = FRAMES[name]
    frame = zstd.compress(data)
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == len(data) and not params.has_checksum
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompressobj().decompress(frame) == data
    assert zstd.decompress(frame) == data
    # raw blocks cost 3 bytes per 128 KiB, a repeated byte 4 bytes a block
    blocks = max(1, -(-len(data) // (128 * 1024)))
    assert len(frame) <= len(data) + 3 * blocks + 18
    if data and data == bytes(len(data)):
        assert len(frame) <= 4 * blocks + 18


# ---------------------------------------------------------------- zarr arrays

def _bf16(values):
    return torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)


ARRAYS = {
    "f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
    "f16": np.linspace(-2, 2, 6).astype(np.float16),
    "f64": np.linspace(-2, 2, 5),
    "i8": np.array([-3, 4], np.int8),
    "i16": np.array([-300, 4], np.int16),
    "i32_count": np.int32(41),
    "i64": np.array([[-5], [7]], np.int64),
    "u8": np.array([0, 255], np.uint8),
    "u16": np.array([9], np.uint16),
    "u32": np.array([2 ** 31], np.uint32),
    "u64": np.array([2 ** 63], np.uint64),
    "bool": np.array([True, False, True]),
    "f32_scalar": np.float32(-0.25),
    "bf16": _bf16([[1.5, -2.0, 3.25], [0.0, 1e-3, 7.0]]),
    "bf16_scalar": _bf16(0.75),
    "tensor_f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
    "tensor_i32_count": torch.tensor(5, dtype=torch.int32),
}


def _as_jax(value):
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            import ml_dtypes
            return jnp.asarray(value.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
        return jnp.asarray(value.numpy())
    return value


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_zarr_arrays_as_orbax_writes_them(tmp_path, name):
    """The port's ``.zarray`` of every dtype the trainers save (bf16 and 0-d
    counts among them) equals orbax's byte for byte, its chunk key is
    orbax's, and tensorstore and orbax read the port's array as written."""
    value = ARRAYS[name]
    jdir = jck.save_checkpoint(str(tmp_path / "j"), 0, {"x": _as_jax(value)})
    pdir = port.save(str(tmp_path / "p"), {"x": value})
    jstore, pstore = ocdbt.OcdbtStore(jdir), ocdbt.OcdbtStore(pdir)
    assert pstore.list() == jstore.list()
    assert pstore.read("x/.zarray") == jstore.read("x/.zarray")
    got = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": "file://" + pdir,
                                                  "path": "x/"}}).result().read().result()
    want = np.asarray(_as_jax(value))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert_same_tree(port.restore(pdir), orbax_restore(jdir))
    assert_same_tree(port.restore(pdir), orbax_restore(pdir))
    jmeta = json.load(open(os.path.join(jdir, port.METADATA_FILE)))
    pmeta = json.load(open(os.path.join(pdir, port.METADATA_FILE)))
    # a tensor is a jax.Array as the JAX trainers hold it; numpy stays numpy
    assert pmeta == jmeta


def test_zarr_writer_refuses_what_orbax_refuses(tmp_path):
    with pytest.raises(port.OrbaxError, match="zero size"):
        port.save(str(tmp_path / "a"), {"x": np.zeros((0, 3), np.float32)})
    with pytest.raises(port.OrbaxError, match="dtype"):
        port.save(str(tmp_path / "b"), {"x": np.zeros(2, np.complex64)})
    with pytest.raises(port.OrbaxError, match="str"):
        port.save(str(tmp_path / "c"), {"x": "text"})
    assert not os.path.exists(tmp_path / "a")


# ---------------------------------------------------------------- OCDBT writer

def test_ocdbt_config_is_orbax_s(tmp_path):
    """Every config field of the store orbax writes but its uuid, at both
    of orbax's levels."""
    jdir = jck.save_checkpoint(str(tmp_path / "j"), 0, {"x": np.ones(3, np.float32)})
    pdir = port.save(str(tmp_path / "p"), {"x": np.ones(3, np.float32)})
    got = ocdbt.OcdbtStore(pdir).config._replace(uuid=b"")
    for level in ("", "ocdbt.process_0"):
        assert ocdbt.OcdbtStore(os.path.join(jdir, level)).config._replace(uuid=b"") == got
    assert ocdbt.OcdbtStore(pdir).config.uuid != ocdbt.OcdbtStore(jdir).config.uuid


@pytest.mark.parametrize("keys,node_bytes", [(1, None), (60, None), (2500, 2000),
                                             (4000, 1500)])
def test_ocdbt_writer_against_tensorstore(tmp_path, monkeypatch, keys, node_bytes):
    """Values inline (up to 1024 bytes) and indirect, empty values, keys
    sharing long prefixes; a node limit that forces interior nodes. Every
    key reads as tensorstore reads it, and tensorstore's dump shows the
    written version."""
    rng = np.random.default_rng(keys)
    values = {}
    for i in range(keys):
        key = f"p.{rng.integers(0, 40)}.{'x' * int(rng.integers(0, 6))}/{i:05d}"
        values[key] = rng.bytes(int(rng.choice([0, 7, 1024, 1025, 5000])))
    path = str(tmp_path / "s")
    if node_bytes is not None:      # a small node limit forces interior nodes
        monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", node_bytes)
    writer = ocdbt.OcdbtWriter(path)
    for key, value in values.items():
        writer.put(key, value)
    writer.commit()
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path}).result()
    assert sorted(k.decode() for k in kv.list().result()) == sorted(values)
    for key in sorted(values)[::max(1, keys // 300)]:
        assert kv.read(key).result().value == values[key], key
    store = ocdbt.OcdbtStore(path)
    assert store.list() == sorted(values)
    dump = ts.ocdbt.dump(ts.KvStore.open("file://" + path + "/").result()).result()
    (version,) = dump["versions"]
    stats = version["root"]["statistics"]
    assert version["generation_number"] == 1
    assert stats["num_keys"] == keys
    assert stats["num_indirect_value_bytes"] == sum(len(v) for v in values.values()
                                                    if len(v) > 1024)
    assert (store.version.root_height > 0) == (node_bytes is not None)
    with pytest.raises(ocdbt.OcdbtError, match="already holds"):
        again = ocdbt.OcdbtWriter(path)
        again.put("k", b"v")
        again.commit()


# ---------------------------------------------------------------- twin states

def _same_jax(a, b, where=""):
    """Two results of a JAX call: the same tree, leaf types, dtypes, shapes,
    shardings and bytes."""
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb, where
    for x, y in zip(la, lb):
        assert type(x) is type(y), (where, type(x), type(y))
        x_, y_ = np.asarray(x), np.asarray(y)
        assert (x_.dtype, x_.shape) == (y_.dtype, y_.shape), where
        assert x_.tobytes() == y_.tobytes(), where
        if isinstance(x, jax.Array):
            assert x.sharding == y.sharding, where


def _layout(tree):
    """A state's containers by name (a NamedTuple's class and fields in
    order) and its leaves by dtype and shape."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple((f, _layout(getattr(tree, f))) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_layout(v) for v in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _layout(tree[k])) for k in sorted(tree)))
    value = np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)
    return (value.dtype.name, value.shape)


def _outcome(fn, *paths):
    """``fn()``'s result, or its exception's type and message with the
    directories it names taken out."""
    try:
        return "ok", fn()
    except Exception as e:   # the JAX call's own failure, held to its twin's
        message = str(e)
        for p in paths:
            message = message.replace(os.path.abspath(p), "<dir>")
        return "error", (type(e).__name__, message)


def _same_outcome(fn_j, fn_p, jdir, pdir, where=""):
    j, p = _outcome(fn_j, jdir), _outcome(fn_p, pdir)
    assert j[0] == p[0], (where, j, p)
    if j[0] == "error":
        assert j[1] == p[1], where
    return j, p


@functools.cache
def _gnn_setup():
    """A JAX relation GNN's variables (the JAX trainer's init at its
    defaults) and a graph to run it on."""
    from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
    root = pathlib.Path(tempfile.mkdtemp(prefix="orbax_write_gnn_"))
    graphs = _write_graph_jsons(root, n_graphs=4)
    batch = next(jinput.InputGNN(TRAINER_INPUT, seed=0).train_batches(graphs, 2, 1))
    variables = jax.jit(JGraphRelation(num_classes=2).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    with open(graphs[0]) as f:
        graph = json.load(f)
    return variables, graph


@functools.cache
def _seg_variables():
    from citlab_as_tpu.models.arunet import ARUNet as JARUNet
    return jax.jit(JARUNet(n_classes=2, graph_params=TINY_RU).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 1)))


def _port_net(kind):
    if kind == "gnn":
        from citlab_as_tpu_torch.models.gnn.model import GraphRelation
        return (GraphRelation(15, 2), weights.gnn_flax_from_state_dict,
                weights.gnn_state_dict_from_flax)
    from citlab_as_tpu_torch.models.arunet import ARUNet
    return (ARUNet(n_classes=2, graph_params=TINY_RU), weights.arunet_flax_from_state_dict,
            weights.arunet_state_dict_from_flax)


def _jax_trainer_state(kind, name, k, ema, updates=3):
    """A JAX trainer's state after ``updates`` optax updates of random
    gradients (a MultiSteps run stops between two gradient steps) and its
    template (``TrainerGNN._init_state``, ``TrainerSegmentation.train``)."""
    variables = _gnn_setup()[0] if kind == "gnn" else _seg_variables()
    tx = jopt.build_optimizer(dict(OPT_PARAMS, optimizer=name), 1, 4, "final_decay", k)
    rng = np.random.default_rng(len(name) + k)
    params, opt_state = variables, tx.init(variables)
    for _ in range(updates):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
        step, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, step)
    state = {"params": params, "opt_state": opt_state}
    template = {"params": variables, "opt_state": tx.init(variables)}
    if ema:
        state["ema"] = jax.tree_util.tree_map(lambda p: p * 0.5 + 0.25, params)
        template["ema"] = jck.ema_init(variables)
    return state, template


def _port_twin(kind, name, k, ema, jdir):
    """The port trainer's live tensors holding the state saved in the JAX
    ``jdir`` (``load_trainer_state``)."""
    model, to_flax, from_flax = _port_net(kind)
    params = dict(model.named_parameters())
    tx = topt.build_optimizer(dict(OPT_PARAMS, optimizer=name), 1, 4, "final_decay", k)
    opt_state = tx.init(params)
    shadow = tck.ema_init(params) if ema else None
    saved, _ = tck.restore_checkpoint(jdir)
    tck.load_trainer_state(saved, params, opt_state, shadow, from_flax)
    return params, opt_state, shadow, to_flax


STATES = ([("gnn", name, k, ema) for name in ("adam", "nadam", "rmsprop", "sgd")
           for k in (1, 2) for ema in (False, True)]
          + [("seg", name, 1, ema) for name in ("adam", "sgd") for ema in (False, True)])


@pytest.mark.parametrize("kind,name,k,ema", STATES)
def test_restore_checkpoint_with_each_jax_trainers_template(tmp_path, kind, name, k, ema):
    state, template = _jax_trainer_state(kind, name, k, ema)
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jck.save_checkpoint(jdir, 3, state)
    params, opt_state, shadow, to_flax = _port_twin(kind, name, k, ema, jdir)
    written = tck.trainer_state(params, opt_state, shadow, to_flax)
    path = tck.save_checkpoint(pdir, 3, written)
    assert tck.CHECKPOINT_FILE not in os.listdir(path)
    for tmpl in (template, None):
        (_, j), (_, p) = _same_outcome(lambda: jck.restore_checkpoint(jdir, tmpl),
                                       lambda: jck.restore_checkpoint(pdir, tmpl), jdir, pdir)
        _same_jax(j, p, f"template {tmpl is not None}")
    _same_jax(jck.restore_checkpoint(pdir, template)[0], state)
    # the same tree as optax's own state: class and field names, their order
    assert _layout(written["opt_state"]) == _layout(state["opt_state"])
    jmeta = json.load(open(os.path.join(jdir, "3", port.METADATA_FILE)))
    pmeta = json.load(open(os.path.join(pdir, "3", port.METADATA_FILE)))
    assert pmeta == jmeta
    assert list(pmeta["tree_metadata"]) == list(jmeta["tree_metadata"])
    # and the port's own reader gives the live tensors back, bit for bit
    restored = port.named_arrays(tck.restore_checkpoint(pdir)[0])
    live = port.named_arrays(written)
    assert sorted(restored) == sorted(live)
    for key, value in live.items():
        assert np.asarray(restored[key]).tobytes() == value.detach().numpy().tobytes(), key


def test_restore_best_equals_on_the_twin(tmp_path):
    state, template = _jax_trainer_state("gnn", "adam", 1, True)
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jck.export_best(jdir, "f1", state["ema"])
    jck.save_checkpoint(jdir, 0, state)
    params, opt_state, shadow, to_flax = _port_twin("gnn", "adam", 1, True, jdir)
    path = tck.export_best(pdir, "f1", tck.variables(to_flax(shadow)))
    assert path == tck.best_path(pdir, "f1") and tck.CHECKPOINT_FILE not in os.listdir(path)
    for tmpl in (template["params"], None):
        (_, j), (_, p) = _same_outcome(lambda: jck.restore_best(jdir, "f1", tmpl),
                                       lambda: jck.restore_best(pdir, "f1", tmpl), jdir, pdir)
        _same_jax(j, p)
    _same_jax(jck.restore_best(pdir, "f1", template["params"]), state["ema"])
    with open(os.path.join(path, port.METADATA_FILE)) as f:
        assert json.load(f) == json.load(open(os.path.join(jdir, "best", "f1",
                                                           port.METADATA_FILE)))


@pytest.mark.parametrize("include", [None, r"hidden_0|GraphLSTM1"])
def test_warmstart_params_with_renames_equals_on_the_twin(tmp_path, include):
    state, template = _jax_trainer_state("gnn", "nadam", 2, False)
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    jck.save_checkpoint(jdir, 5, state)
    tck.save_checkpoint(pdir, 5, tck.trainer_state(*_port_twin("gnn", "nadam", 2, False, jdir)))
    flat = traverse_util.flatten_dict(template["params"]["params"], sep="/")
    fresh = {"params": {"params": traverse_util.unflatten_dict(
        {tuple(k.replace("Classification", "Head").split("/")): v - 1.0
         for k, v in flat.items()})}}
    rename = {r"Classification": "Head"}
    (_, j), (_, p) = _same_outcome(
        lambda: jck.warmstart_params(fresh, jdir, template, rename_map=rename,
                                     include_pattern=include),
        lambda: jck.warmstart_params(fresh, pdir, template, rename_map=rename,
                                     include_pattern=include), jdir, pdir)
    _same_jax(j, p)
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(p),
                                                       jax.tree_util.tree_leaves(fresh)))


def test_jax_predictors_from_a_port_model_dir(tmp_path):
    """``RelationPredictor`` on a trainer's numbered step and on a best
    export, ``SegmentationPredictor`` on a trainer's step and on a step of
    variables alone (``{"params": variables}``, as the JAX training
    scripts save): the same confidences and probabilities, or the same
    failure, on the port's directory as on orbax's."""
    from citlab_as_tpu.inference import RelationPredictor as JRel
    from citlab_as_tpu.inference import SegmentationPredictor as JSeg
    _, graph = _gnn_setup()
    state, _ = _jax_trainer_state("gnn", "adam", 2, True)
    jdir, pdir = str(tmp_path / "gj"), str(tmp_path / "gp")
    jck.save_checkpoint(jdir, 1, state)
    jck.export_best(jdir, "f1", state["ema"])
    params, opt_state, shadow, to_flax = _port_twin("gnn", "adam", 2, True, jdir)
    tck.save_checkpoint(pdir, 1, tck.trainer_state(params, opt_state, shadow, to_flax))
    tck.export_best(pdir, "f1", tck.variables(to_flax(shadow)))
    for sub in ("", "best/f1"):
        j, p = _same_outcome(lambda: JRel(os.path.join(jdir, sub)).confidences(graph),
                             lambda: JRel(os.path.join(pdir, sub)).confidences(graph),
                             jdir, pdir, sub)
        if j[0] == "ok":
            np.testing.assert_array_equal(p[1], j[1])
    image = np.random.default_rng(5).random((40, 48)).astype(np.float32)
    for with_opt in (True, False):
        state, _ = _jax_trainer_state("seg", "adam", 1, False)
        if not with_opt:
            state = {"params": state["params"]}
        jdir, pdir = str(tmp_path / f"sj{with_opt}"), str(tmp_path / f"sp{with_opt}")
        jck.save_checkpoint(jdir, 2, state)
        if with_opt:
            tree = tck.trainer_state(*_port_twin("seg", "adam", 1, False, jdir))
        else:
            model, to_flax, from_flax = _port_net("seg")
            model.load_state_dict(from_flax(_flat(state["params"])))
            tree = {"params": tck.variables(to_flax(model.state_dict()))}
        tck.save_checkpoint(pdir, 2, tree)

        def predict(d):
            return JSeg(d, graph_params=TINY_RU, dtype=jnp.float32, pad_multiple=16)(image)

        j, p = _same_outcome(lambda: predict(jdir), lambda: predict(pdir), jdir, pdir,
                             f"seg {with_opt}")
        if j[0] == "ok":
            np.testing.assert_array_equal(p[1], j[1])
        else:
            assert with_opt


def _frozen_members(path):
    with zipfile.ZipFile(path) as zf:
        return {info.filename: zf.read(info) for info in zf.infolist()}


@pytest.mark.parametrize("sub", ["", "best/f1"])
def test_export_checkpoint_frozen_equals_on_the_twin(tmp_path, sub):
    """The JAX exporter freezes the port's directory (a trainer's newest
    step, a best export) into the bytes it makes of orbax's: each zip
    member equal, only the zip's timestamps free. Both are written in turn
    at one path, as the artifact records its source's path."""
    from citlab_as_tpu.train.export import export_checkpoint_frozen
    state, _ = _jax_trainer_state("gnn", "rmsprop", 1, True)
    model_dir = str(tmp_path / "run")
    frozen = {}
    for side in ("jax", "port"):
        shutil.rmtree(model_dir, ignore_errors=True)
        jck.save_checkpoint(model_dir, 4, state)
        jck.export_best(model_dir, "f1", state["ema"])
        if side == "port":
            twin = _port_twin("gnn", "rmsprop", 1, True, model_dir)
            shutil.rmtree(model_dir)
            tck.save_checkpoint(model_dir, 4, tck.trainer_state(*twin))
            tck.export_best(model_dir, "f1", tck.variables(twin[3](twin[2])))
            assert not os.path.isdir(os.path.join(model_dir, "4", "ocdbt.process_0"))
        out = str(tmp_path / f"{side}.frozen")
        export_checkpoint_frozen(os.path.join(model_dir, sub), out, "graph_relation",
                                 {"num_classes": 2})
        frozen[side] = out
    assert _frozen_members(frozen["port"]) == _frozen_members(frozen["jax"])
    assert os.path.getsize(frozen["port"]) == os.path.getsize(frozen["jax"])


# ---------------------------------------------------------------- resume

def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _assert_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(np.asarray(got[k]) - want[k]).max()) / scale <= RTOL, f"{what} {k}"


def test_jax_gnn_trainer_resumes_a_port_model_dir(tmp_path):
    """The port's GNN trainer writes epoch 0 (weight decay, EMA, gradient
    accumulation: a ``MultiStepsState``); the JAX trainer resumes a copy
    of its model_dir with the port's state, bit for bit, and its second
    epoch equals the port's own resumed second epoch."""
    from citlab_as_tpu.models.gnn.model import GraphRelation as JGraphRelation
    from citlab_as_tpu.train.trainer import TrainerGNN as JTrainerGNN
    from citlab_as_tpu_torch.train.trainer import TrainerGNN
    graphs = _graphs(tmp_path / "data", 6)
    batch_np = next(jinput.InputGNN(TRAINER_INPUT, seed=0).train_batches(graphs[:4], 2, 1))
    init = _flat(jax.jit(JGraphRelation(num_classes=2).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch_np.items()}))
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")

    def port_run(epochs):
        return TrainerGNN(tdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=epochs),
                          input_params=TRAINER_INPUT, seed=0, device="cpu",
                          init_params=init).train()

    first = port_run(1)
    assert sorted(os.listdir(tdir)) == ["0", "best", "current_epoch.info", "curves"]
    for written in [os.path.join(tdir, "0")] + [os.path.join(tdir, "best", m)
                                                for m in os.listdir(os.path.join(tdir, "best"))]:
        assert port.is_orbax_checkpoint(written)
        assert tck.CHECKPOINT_FILE not in os.listdir(written)
    shutil.copytree(tdir, jdir)

    # resumed with nothing left to train: the JAX trainer's state is the port's
    jresumed = JTrainerGNN(jdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=1),
                           input_params=TRAINER_INPUT, seed=0).train()
    assert jresumed["history"] == []
    jstate = jresumed["state"]
    assert type(jstate["opt_state"]).__name__ == "MultiStepsState"
    live = first["state"]
    for key in ("params", "ema"):
        got, want = _flat(jstate[key]), weights.gnn_flax_from_state_dict(live[key])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    inner = jstate["opt_state"].inner_opt_state
    assert int(inner[0].count) == int(inner[1].count) == live["opt_state"]["count"] == \
        int(jstate["opt_state"].gradient_step)
    assert int(jstate["opt_state"].mini_step) == live["opt_state"]["mini_step"]

    want = JTrainerGNN(jdir, graphs[:4], graphs[4:], flags=dict(TRAINER_FLAGS, epochs=2),
                       input_params=TRAINER_INPUT, seed=0).train()
    got = port_run(2)
    assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]] == [1]
    for w, g in zip(want["history"], got["history"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=RTOL)
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=RTOL), (k, g, w)
    _assert_close(weights.gnn_flax_from_state_dict(got["state"]["params"]),
                  _flat(want["state"]["params"]), "params")
    _assert_close(weights.gnn_flax_from_state_dict(got["state"]["ema"]),
                  _flat(want["state"]["ema"]), "ema")


def test_jax_segmentation_trainer_resumes_a_port_model_dir(tmp_path, monkeypatch, gt_dir):  # noqa: F811
    from citlab_as_tpu.models.arunet import ARUNet as JARUNet
    from citlab_as_tpu.train import seg_trainer as jseg_trainer
    from citlab_as_tpu_torch.train import seg_trainer
    from tests.test_torch_seg_training import TINY, _jax_init
    flags = {"epochs": 1, "steps_per_epoch": 2, "batch_size": 1, "crop_size": (64, 64),
             "eval_steps": 1, "n_classes": 3, "ema_decay": 0.5}
    gp = TINY["RU"]
    monkeypatch.setattr(jseg_trainer, "ARUNet",
                        lambda **kw: JARUNet(**{**kw, "dtype": jnp.float32}))
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")

    def port_run(epochs):
        return seg_trainer.TrainerSegmentation(
            tdir, gt_dir, eval_gt_dir=gt_dir, flags=dict(flags, epochs=epochs),
            graph_params=gp, device="cpu", compute_dtype=torch.float32,
            init_params=_jax_init("RU")).train()

    first = port_run(1)
    assert port.is_orbax_checkpoint(tck.best_path(tdir, "accuracy"))
    shutil.copytree(tdir, jdir)
    jresumed = jseg_trainer.TrainerSegmentation(jdir, gt_dir, eval_gt_dir=gt_dir, flags=flags,
                                                graph_params=gp).train()
    jstate = jresumed["state"]
    assert jresumed["history"] == []
    for key in ("params", "ema"):
        got = _flat(jstate[key])
        want = weights.arunet_flax_from_state_dict(first["state"][key])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    adam, schedule = jstate["opt_state"]
    assert int(adam.count) == int(schedule.count) == first["state"]["opt_state"]["count"]

    want = jseg_trainer.TrainerSegmentation(jdir, gt_dir, eval_gt_dir=gt_dir,
                                            flags=dict(flags, epochs=2), graph_params=gp).train()
    got = port_run(2)
    assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]] == [1]
    for w, g in zip(want["history"], got["history"]):
        assert g["loss"] == pytest.approx(w["loss"], rel=RTOL), (g, w)
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=1e-4), (g, w)
    _assert_close(weights.arunet_flax_from_state_dict(got["state"]["params"]),
                  _flat(want["state"]["params"]), "params")


# ---------------------------------------------------------------- committed dirs

def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, names in os.walk(path)
               for f in names)


@pytest.mark.parametrize("rel", COMMITTED)
def test_committed_directories_rewritten_by_the_port_restore_in_orbax(tmp_path, rel):
    """Each committed directory read by the port, its arrays held as
    tensors (``jax.Array``s, as orbax wrote them), written again: orbax
    restores every leaf equal, the ``_METADATA`` is the committed one, and
    the directory takes at most 1.10 x the committed bytes."""
    src = os.path.join(REPO, rel)
    tree = jax.tree_util.tree_map(
        lambda v: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)),
        port.restore(src))
    out = port.save(str(tmp_path / "rewritten"), tree)
    assert_same_tree(orbax_restore(out), orbax_restore(src), rel)
    with open(os.path.join(src, port.METADATA_FILE)) as f:
        want = json.load(f)
    with open(os.path.join(out, port.METADATA_FILE)) as f:
        assert json.load(f) == want
    assert _dir_bytes(out) <= 1.10 * _dir_bytes(src), (_dir_bytes(out), _dir_bytes(src))
