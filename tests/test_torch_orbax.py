"""The port's reader of the JAX package's orbax checkpoints
(``utils/ocdbt.py``, ``utils/zarr.py``, ``train/orbax.py``; its own zstd
and CRC-32C) against tensorstore and orbax, which the port never imports:
every key and value of the nine committed checkpoint directories and of
fresh trees the JAX package's ``save_checkpoint`` / ``export_best`` write
(every dtype it stores, 0-d leaves, Python numbers, lists and tuples, empty
containers, thousands of leaves over b-tree interior nodes, a step
overwritten and pruned), zarr arrays tensorstore writes (0-size, chunks
never stored, edge chunks, fill values), a store with version-tree nodes,
the variants refused by name, and damaged files."""
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from citlab_as_tpu.train import checkpoint as jck  # noqa: E402
from citlab_as_tpu_torch.train import orbax as port  # noqa: E402
from citlab_as_tpu_torch.utils import ocdbt, zarr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = sorted(os.path.relpath(os.path.dirname(p), REPO) for p in
                   glob.glob(os.path.join(REPO, "models_ckpt", "**", "_METADATA"),
                             recursive=True))


def orbax_restore(path):
    """orbax's restore of every leaf as numpy, as the JAX package's
    exporter restores a checkpoint (``citlab_as_tpu/train/export.py``)."""
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler())
    meta = ckptr.metadata(os.path.abspath(path))
    args = jax.tree_util.tree_map(lambda m: ocp.RestoreArgs(restore_type=np.ndarray),
                                  meta.item_metadata.tree)
    return ckptr.restore(os.path.abspath(path), args=ocp.args.PyTreeRestore(restore_args=args))


def assert_same_tree(got, want, where=""):
    """Structure, dtype, shape and bytes equal (bf16: a torch tensor here,
    an ml_dtypes array from orbax, the same 16-bit patterns)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{where}/{i}")
    elif want is None:
        assert got is None, where
    else:
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert isinstance(got, np.ndarray), where
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        assert got.tobytes() == want.tobytes(), where


def assert_same_store(path):
    store = ocdbt.OcdbtStore(path)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + os.path.abspath(path)}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.list() == keys
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key
    return store


@pytest.mark.parametrize("rel", COMMITTED)
def test_committed_checkpoints_read_as_tensorstore_and_orbax(rel):
    path = os.path.join(REPO, rel)
    assert port.is_orbax_checkpoint(path)
    assert_same_store(path)
    assert_same_tree(port.restore(path), orbax_restore(path), rel)


def test_nine_committed_checkpoint_directories():
    assert len(COMMITTED) == 9
    assert {"models_ckpt/separator/3000", "models_ckpt/heading/3000",
            "models_ckpt/gnn/28", "models_ckpt/gnn/29", "models_ckpt/gnn/best/f1",
            "models_ckpt/gnn_pipeline/22", "models_ckpt/gnn_pipeline/23",
            "models_ckpt/gnn_pipeline/best/f1", "models_ckpt/gnn_visual/best/f1"} == set(COMMITTED)


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "f64": rng.standard_normal((3,)),
        "i32": rng.integers(-9, 9, (4,), dtype=np.int32),
        "i8": rng.integers(-9, 9, (3, 1), dtype=np.int8),
        "u16": rng.integers(0, 9, (2,), dtype=np.uint16),
        "i64": rng.integers(-9, 9, (2,), dtype=np.int64),
        "u8": rng.integers(0, 255, (6,), dtype=np.uint8),
        "bool": rng.integers(0, 2, (7,)).astype(bool),
        "scalar0d": np.float32(rng.standard_normal()),
        "count": np.int32(seed),
        "py_int": int(seed) + 3,
        "py_float": float(seed) / 7,
        "seq": [rng.standard_normal((2,)).astype(np.float32),
                (np.int32(1), {"deep": rng.standard_normal((1, 2, 3)).astype(np.float32)})],
        "none": None,
        "empty_dict": {},
        "empty_tuple": (),
        "nested": {"a": {"b": {"c": jnp.asarray(rng.standard_normal((2, 3)), jnp.float32)}}},
    }


@pytest.fixture
def small_nodes(monkeypatch):
    """orbax writing b-tree nodes of at most 1500 decoded bytes, so that a
    few thousand keys need interior nodes (its default, 100 MB, keeps
    every checkpoint's tree in one leaf)."""
    import orbax.checkpoint._src.serialization.tensorstore_utils as tsu
    original = tsu.add_ocdbt_write_options

    def small(spec, *args, **kwargs):
        original(spec, *args, **kwargs)
        spec["config"]["max_decoded_node_bytes"] = 1500
    monkeypatch.setattr(tsu, "add_ocdbt_write_options", small)


@pytest.mark.parametrize("seed", [0, 1])
def test_fresh_trees_of_save_checkpoint_and_export_best(tmp_path, seed):
    tree = _mixed_tree(seed)
    step = jck.save_checkpoint(str(tmp_path), 7, tree)
    best = jck.export_best(str(tmp_path), "f1", tree)
    for path in (step, best):
        assert_same_store(path)
        got = port.restore(path)
        assert_same_tree(got, orbax_restore(path))
        assert got["empty_dict"] == {} and got["empty_tuple"] == [] and got["none"] is None
        assert got["py_int"].shape == () and got["py_int"] == seed + 3


def test_thousands_of_leaves_over_interior_nodes(tmp_path, small_nodes):
    rng = np.random.default_rng(5)
    tree = {"params": {f"layer_{i:04d}": {"kernel": rng.standard_normal((2, 3)).astype(np.float32),
                                          "bias": np.float32(i)} for i in range(1500)},
            "opt_state": [{"count": np.int32(3)}, None]}
    path = jck.save_checkpoint(str(tmp_path), 1, tree)
    store = assert_same_store(path)
    assert store.version.root_height >= 2 and store.version.num_keys == 6002
    assert_same_tree(port.restore(path), orbax_restore(path))


def test_overwritten_and_pruned_steps(tmp_path):
    d = str(tmp_path)
    jck.save_checkpoint(d, 1, _mixed_tree(1))
    jck.save_checkpoint(d, 1, _mixed_tree(2))          # overwrites step 1
    for step in (2, 3):
        jck.save_checkpoint(d, step, _mixed_tree(10 + step))
    assert sorted(os.listdir(d)) == ["2", "3"]         # keep_checkpoint_max=2
    from citlab_as_tpu_torch.train.checkpoint import latest_checkpoint_step, restore_checkpoint
    assert latest_checkpoint_step(d) == 3
    state, step = restore_checkpoint(d)
    assert step == 3
    assert_same_tree(state, orbax_restore(os.path.join(d, "3")))
    want = _mixed_tree(13)
    np.testing.assert_array_equal(state["f32"], want["f32"])


def test_zarr_arrays_tensorstore_writes(tmp_path):
    """Multi-chunk grids with edge chunks, 0-size and 0-d arrays, chunks
    never written (fill values NaN, a number, True, null) and bf16,
    against tensorstore's reads of the same arrays."""
    import ml_dtypes
    base = "file://" + str(tmp_path)
    rng = np.random.default_rng(0)
    cases = {
        "grid": ("<f4", [5, 7], [2, 3], None, "."),
        "empty": ("<i2", [0, 3], [1, 2], None, "."),
        "zero_d": ("|u1", [], [], None, "."),
        "nan_fill": ("<f8", [10], [4], "NaN", "."),
        "bool_fill": ("|b1", [3, 3], [2, 2], True, "."),
        "bf16": ("bfloat16", [4, 5], [3, 3], 1.5, "."),
        "int_fill": ("<i8", [6, 2], [4, 1], 7, "."),
    }
    for name, (dtype, shape, chunks, fill, sep) in cases.items():
        arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base,
                                                      "path": name + "/"},
                       "metadata": {"shape": shape, "chunks": chunks, "dtype": dtype,
                                    "compressor": {"id": "zstd", "level": 3},
                                    "fill_value": fill, "dimension_separator": sep},
                       "create": True}).result()
        np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
        data = (rng.standard_normal(shape) * 10).astype(np_dtype)
        if fill is not None and shape:
            arr[:2].write(data[:2]).result()    # the other chunks stay unwritten
        else:
            arr.write(data).result()
    store = ocdbt.OcdbtStore(str(tmp_path))

    def read(key):
        return store.read(key) if key in store else None

    for name, (dtype, *_rest) in cases.items():
        want = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base,
                                                       "path": name + "/"}}).result().read().result()
        got = zarr.read_array(read, name)
        if dtype == "bfloat16":
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_store_with_version_tree_nodes(tmp_path):
    """Forty commits of a store whose version tree has arity 4: the
    manifest's inline versions and version-node references are read as
    tensorstore's dump shows them, and the newest version's keys equal
    tensorstore's."""
    base = "file://" + str(tmp_path)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base,
                          "config": {"max_decoded_node_bytes": 2000,
                                     "version_tree_arity_log2": 2}}).result()
    rng = np.random.default_rng(1)
    for gen in range(40):
        with ts.Transaction() as txn:
            for k in range(gen * 20, gen * 20 + 20):
                size = 3000 if k % 7 == 0 else k % 40
                kv.with_transaction(txn)[f"key/{k:05d}/x"] = rng.bytes(size)
    store = assert_same_store(str(tmp_path))
    dump = ts.ocdbt.dump(ts.KvStore.open(base + "/").result()).result()
    assert [v.generation for v in store.versions] == [
        v["generation_number"] for v in dump["versions"]]
    assert [(n.generation, n.num_generations, n.height, n.node.offset, n.node.length)
            for n in store.version_nodes] == [
        (n["generation_number"], n["num_generations"], n["height"],
         int(n["location"].split(":")[-2]), int(n["location"].split(":")[-1]))
        for n in dump["version_tree_nodes"]]
    assert store.version_nodes and store.version.root_height >= 1
    assert store.config.max_decoded_node_bytes == 2000 and store.config.compression == "zstd"


def test_variants_refused_by_name(tmp_path):
    tree = {"w": np.ones(3, np.float32)}
    path = jck.save_checkpoint(str(tmp_path / "a"), 1, tree)
    meta_path = os.path.join(path, port.METADATA_FILE)
    meta = json.load(open(meta_path))
    # use_zarr3 over zarr v2 arrays: the v3 reader finds no zarr.json
    for key, value, match in (("use_zarr3", True, "w/zarr.json: not stored"),
                              ("use_ocdbt", False, "without OCDBT")):
        changed = dict(meta, **{key: value})
        with open(meta_path, "w") as f:
            json.dump(changed, f)
        with pytest.raises(port.OrbaxError, match=match):
            port.restore(path)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    # a numbered manifest
    numbered = str(tmp_path / "numbered")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + numbered,
                          "config": {"manifest_kind": "numbered"}}).result()
    kv["k"] = b"v"
    with pytest.raises(ocdbt.OcdbtError, match="numbered"):
        ocdbt.OcdbtStore(numbered)
    # zarr metadata this reader does not read
    values = {"w/.zarray": None, "w/0": b""}
    base_meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
                 "compressor": None, "fill_value": None, "filters": None, "order": "C"}
    for change, match in (({"compressor": {"id": "blosc"}}, "compressor"),
                          ({"order": "F"}, "order"), ({"dtype": "<c8"}, "dtype"),
                          ({"dtype": "|S4"}, "dtype"), ({"dtype": ">f4"}, "dtype"),
                          ({"dtype": "|i4"}, "dtype"), ({"dimension_separator": "/"}, "separator"),
                          ({"filters": [{"id": "delta"}]}, "filters"),
                          ({"zarr_format": 3}, "zarr_format")):
        values["w/.zarray"] = json.dumps(dict(base_meta, **change)).encode()
        with pytest.raises(zarr.ZarrError, match=match):
            zarr.read_array(values.get, "w")


def _damaged_copies(src, dst, rng):
    """(file, damage, path) for copies of ``src`` with one file cut or one
    byte flipped."""
    files = sorted(os.path.relpath(os.path.join(d, f), src)
                   for d, _, names in os.walk(src) for f in names)
    out = []
    for i, rel in enumerate(files):
        size = os.path.getsize(os.path.join(src, rel))
        for kind in ("cut", "flip", "flip"):
            path = os.path.join(dst, f"{i}_{kind}_{len(out)}")
            shutil.copytree(src, path)
            target = os.path.join(path, rel)
            data = bytearray(open(target, "rb").read())
            if kind == "cut":
                data = data[:int(rng.integers(0, max(1, size)))]
            else:
                data[int(rng.integers(size))] ^= 1 << int(rng.integers(8))
            open(target, "wb").write(bytes(data))
            out.append((rel, kind, path))
    return out


def test_damaged_files_raise_or_read_as_orbax_reads_them(tmp_path):
    """A cut or a flipped byte in the manifest or the b-tree node the
    restore reads (both carry a CRC-32C) raises. Damage elsewhere raises or
    gives what orbax restores from the same damaged files: a file the
    restore does not read (``ocdbt.process_0/``'s own manifest and nodes),
    the unreferenced tail of a data file, or a flip in a zarr chunk's
    literal bytes (a chunk's zstd frame carries no checksum, so no reader
    can tell those values changed)."""
    rng = np.random.default_rng(2)
    src = os.path.join(REPO, "models_ckpt", "gnn", "best", "f1")
    clean = ocdbt.OcdbtStore(src)
    assert clean.version.root_height == 0
    framed = {"manifest.ocdbt", clean.version.root.path}
    raised = 0
    for rel, kind, path in _damaged_copies(src, str(tmp_path), rng):
        if rel in ("_CHECKPOINT_METADATA", "_sharding") or rel.startswith("array_metadatas"):
            continue   # not read by a restore on the host
        try:
            got = port.restore(path)
        except (ValueError, KeyError, OSError) as e:
            got = e
        if rel in framed:
            assert isinstance(got, Exception), (rel, kind)
        if isinstance(got, Exception):
            raised += 1
            continue
        try:
            want = orbax_restore(path)
        except Exception:   # noqa: BLE001 - orbax's own errors vary
            want = None
        assert want is not None, (rel, kind, "the port read what orbax refuses")
        assert_same_tree(got, want, f"{rel} {kind}")
    assert raised > 10
