"""The port's reader of orbax checkpoints in zarr v3 (``use_zarr3``;
``utils/zarr.py`` ``read_array_v3``) against orbax and tensorstore, on the
CPU: the committed fixture ``tests/data/torch_orbax_zarr3/`` (the relation
GNN's best export re-saved by ``PyTreeCheckpointHandler(use_zarr3=True)``,
``scripts/make_orbax_zarr3_fixture.py``) reads equal to
``models_ckpt/gnn/best/f1`` bit for bit; fresh v3 checkpoints of every
dtype the trainers save read as orbax restores them; the layouts
tensorstore writes as zarr3 in orbax's codec chain (shards with
several inner chunks, inner CRC-32C, chunks never stored, edge shards)
read as tensorstore reads them; the layouts outside that chain that
tensorstore writes (the index at the shard's start, no sharding), other
codecs and damaged shards are refused by name."""
import json
import os

import numpy as np
import pytest
import torch

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from citlab_as_tpu_torch.train import checkpoint as tck  # noqa: E402
from citlab_as_tpu_torch.train import orbax as port  # noqa: E402
from citlab_as_tpu_torch.utils import ocdbt, zarr  # noqa: E402
from tests.test_torch_orbax import REPO, _mixed_tree, assert_same_tree, orbax_restore  # noqa: E402

FIXTURE = os.path.join(REPO, "tests", "data", "torch_orbax_zarr3")
SOURCE = os.path.join(REPO, "models_ckpt", "gnn", "best", "f1")


def test_port_reads_the_committed_zarr3_fixture():
    with open(os.path.join(FIXTURE, port.METADATA_FILE)) as f:
        assert json.load(f)["use_zarr3"] is True
    store = ocdbt.OcdbtStore(FIXTURE)
    assert any(k.endswith("/zarr.json") for k in store.list())
    assert not any(k.endswith("/.zarray") for k in store.list())
    got = port.restore(FIXTURE)
    assert_same_tree(got, port.restore(SOURCE))
    assert_same_tree(got, orbax_restore(FIXTURE))
    assert_same_tree(got, orbax_restore(SOURCE))
    # the predictors' and the exporter's path takes it as it takes the v2 one
    flat, where = tck.checkpoint_variables(FIXTURE)
    want, _ = tck.checkpoint_variables(SOURCE)
    assert where == FIXTURE and sorted(flat) == sorted(want) and len(flat) == 18
    for k in want:
        assert flat[k].dtype == want[k].dtype and flat[k].tobytes() == want[k].tobytes(), k


def _trainer_state():
    rng = np.random.default_rng(3)
    params = {"params": {"dense": {"kernel": jnp.asarray(rng.standard_normal((5, 3)),
                                                         jnp.float32),
                                   "bias": jnp.zeros((3,), jnp.float32)}}}
    tx = optax.MultiSteps(optax.adam(optax.constant_schedule(0.1)), every_k_schedule=2)
    return {"params": params, "opt_state": tx.init(params), "ema": params,
            "bf16": jnp.asarray(rng.standard_normal((4, 2)), jnp.bfloat16),
            "count": jnp.int32(7), "flag": jnp.asarray([True, False])}


@pytest.mark.parametrize("tree", ["mixed0", "mixed1", "trainer"])
def test_zarr3_checkpoints_orbax_writes(tmp_path, tree):
    from citlab_as_tpu.train.checkpoint import _arrayify
    # the JAX package's numbers as 0-d arrays, as its save_checkpoint gives them
    value = _arrayify(_trainer_state() if tree == "trainer" else _mixed_tree(int(tree[-1])))
    path = str(tmp_path / "ckpt")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(path, value)
    assert port.read_metadata(path)["use_zarr3"] is True
    assert_same_tree(port.restore(path), orbax_restore(path), tree)


CASES = {
    # name: (data_type, shape, shard, inner, inner codecs, fill)
    "shards_zstd": ("float32", [7, 9], [4, 6], [2, 3], ["zstd"], 0.0),
    "inner_crc": ("int16", [5, 7], [4, 4], [2, 2], ["crc32c"], 3),
    "inner_zstd_and_crc": ("float64", [10], [4], [2], ["zstd", "crc32c"], "NaN"),
    "bool_fill_true": ("bool", [3, 3], [2, 2], [1, 2], [], True),
    "bf16": ("bfloat16", [4, 5], [4, 5], [2, 5], ["zstd"], 1.5),
    "zero_d": ("int32", [], [], [], ["zstd"], 0),
    "zero_size": ("uint8", [0, 3], [1, 2], [1, 1], ["zstd"], 0),
}


def _spec(dtype, shape, shard, inner, codecs, fill, location="end", sharded=True):
    chain = [{"name": "bytes", "configuration": {"endian": "little"}}] + [
        {"name": c} if c == "crc32c" else {"name": "zstd", "configuration": {"level": 3}}
        for c in codecs]
    if sharded:
        chain = [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": inner, "codecs": chain, "index_location": location,
            "index_codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                             {"name": "crc32c"}]}}]
    return {"shape": shape, "data_type": dtype, "fill_value": fill, "codecs": chain,
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": shard}}}


def test_zarr3_layouts_tensorstore_writes(tmp_path):
    """Every case partly written (the rest of the array never stored, so
    whole shards and inner chunks are absent), read as tensorstore reads
    it."""
    import ml_dtypes
    base = "file://" + str(tmp_path)
    rng = np.random.default_rng(0)
    for name, case in CASES.items():
        arr = ts.open({"driver": "zarr3", "kvstore": {"driver": "ocdbt", "base": base,
                                                       "path": name + "/"},
                       "metadata": _spec(*case), "create": True}).result()
        dtype, shape = case[0], case[1]
        np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
        data = (rng.standard_normal(shape) * 10).astype(np_dtype)
        if shape and shape[0] > 2:
            arr[:3].write(data[:3]).result()
        else:
            arr.write(data).result()
    store = ocdbt.OcdbtStore(str(tmp_path))

    def read(key):
        return store.read(key) if key in store else None

    for name, (dtype, *_rest) in CASES.items():
        want = ts.open({"driver": "zarr3", "kvstore": {"driver": "ocdbt", "base": base,
                                                        "path": name + "/"}}
                       ).result().read().result()
        got = zarr.read_array_v3(read, name)
        if dtype == "bfloat16":
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_zarr3_layouts_outside_orbax_s_chain_refused_by_name(tmp_path):
    base = "file://" + str(tmp_path)
    case = ("int16", [5, 7], [4, 4], [2, 2], ["zstd"], 3)
    refused = {"start": ({"location": "start"}, "index_location 'start'"),
               "unsharded": ({"sharded": False}, r"\(only sharding_indexed\)")}
    for name, (kw, _) in refused.items():
        arr = ts.open({"driver": "zarr3", "kvstore": {"driver": "ocdbt", "base": base,
                                                       "path": name + "/"},
                       "metadata": _spec(*case, **kw), "create": True}).result()
        arr.write(np.ones(case[1], np.int16)).result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    for name, (_, match) in refused.items():
        with pytest.raises(zarr.ZarrError, match=match):
            zarr.read_array_v3(lambda k: store.read(k) if k in store else None, name)


def _fixture_values():
    store = ocdbt.OcdbtStore(FIXTURE)
    return {k: store.read(k) for k in store.list()}


NAME = "params.Classification.hidden_0.kernel"


def _changed(meta, path, value):
    node = meta
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return meta


SHARDING = ("codecs", 0, "configuration")
REFUSED = [
    (("codecs", 0, "name"), "gzip", "codec 'gzip' is not read"),
    (("chunk_key_encoding",), {"name": "default", "configuration": {"separator": "."}},
     "chunk_key_encoding"),
    (SHARDING + ("codecs", 1, "name"), "blosc", "codec 'blosc' is not read"),
    (SHARDING + ("codecs", 0), {"name": "transpose", "configuration": {"order": [1, 0]}},
     "codec 'transpose' is not read"),
    (SHARDING + ("codecs", 0, "configuration", "endian"), "big", "endian 'big'"),
    (SHARDING + ("index_location",), "middle", "index_location 'middle'"),
    (SHARDING + ("index_codecs",), [{"name": "bytes"}, {"name": "zstd"}],
     "compressed shard index"),
    (SHARDING + ("chunk_shape",), [3, 7], "do not divide"),
    (("chunk_key_encoding",), {"name": "v2"}, "chunk_key_encoding"),
    (("chunk_grid", "name"), "rectilinear", "chunk_grid"),
    (("data_type",), "complex64", "data_type 'complex64'"),
    (("data_type",), "r16", "data_type 'r16'"),
    (("fill_value",), "0x7fc00000", "fill_value '0x7fc00000'"),
    (("zarr_format",), 2, "zarr_format 2"),
    (("storage_transformers",), [{"name": "x"}], "storage_transformers"),
]


@pytest.mark.parametrize("path,value,match", REFUSED, ids=[r[2] for r in REFUSED])
def test_zarr3_variants_refused_by_name(path, value, match):
    values = _fixture_values()
    meta = json.loads(values[f"{NAME}/zarr.json"])
    assert zarr.read_array_v3(values.get, NAME).shape == tuple(meta["shape"])
    values[f"{NAME}/zarr.json"] = json.dumps(_changed(meta, path, value)).encode()
    with pytest.raises(zarr.ZarrError, match=match):
        zarr.read_array_v3(values.get, NAME)


def test_zarr3_damaged_shards_raise():
    values = _fixture_values()
    key = f"{NAME}/c/0/0"
    shard = bytearray(values[key])
    for at, match in ((len(shard) - 1, "index: CRC-32C mismatch"), (0, None)):
        damaged = bytearray(shard)
        damaged[at] ^= 0x40
        values[key] = bytes(damaged)
        with pytest.raises(zarr.ZarrError, match=match):
            zarr.read_array_v3(values.get, NAME)
    values[key] = bytes(shard[:10])
    with pytest.raises(zarr.ZarrError, match="shorter than its index"):
        zarr.read_array_v3(values.get, NAME)
