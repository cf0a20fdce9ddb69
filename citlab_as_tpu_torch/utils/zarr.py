"""zarr arrays in a key-value store, as tensorstore writes them
for orbax inside OCDBT.

zarr v2 (orbax's default): ``<name>/.zarray`` (JSON metadata) and one value
per chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array).

- Read: dtypes ``<f2 <f4 <f8``, ``|i1 <i2 <i4 <i8``, ``|u1 <u2 <u4 <u8``,
  ``|b1`` and ``bfloat16`` (read as a ``torch.bfloat16`` tensor, the way
  ``utils/msgpack.py`` holds bf16, since numpy has no bfloat16); ``order``
  "C"; any shape, 0-d and 0-size included, cut into ``chunks`` (the edge
  chunks stored whole, as zarr pads them); ``dimension_separator`` ".";
  the compressor zstd or none; ``fill_value`` (a number, "NaN",
  "Infinity", "-Infinity", a bool, or null for zeros) where a chunk was
  never stored.
- Write (:func:`write_array`): the ``.zarray`` orbax writes (its fields and
  key order, ``compressor`` zstd level 1, ``fill_value`` null) and the
  whole array as one chunk, orbax's chunk grid for an array on one device,
  in one zstd frame of ``zstd.compress``.

zarr v3 (orbax's ``use_zarr3``), read by :func:`read_array_v3`:
``<name>/zarr.json`` and one value per chunk under the default chunk-key
encoding (``<name>/c/<i>/<j>...``, ``<name>/c`` for a 0-d array). Each
chunk is a shard of ``sharding_indexed``, as orbax writes them: inner
chunks coded ``bytes`` (little-endian) then ``zstd`` (or ``crc32c``), and
at the shard's end an index (offset and length of each inner chunk, both
all ones for one never stored) coded ``bytes`` then ``crc32c``. The same
dtypes as v2, by their v3 names; ``fill_value`` where a chunk or an inner
chunk was never stored.

Anything else (another zarr format, compressor, codec, filter, separator,
order or chunk-key encoding, a big-endian, structured or string dtype, a
fill value given in hex) raises :class:`ZarrError` by name, as does a chunk
whose decoded size is not its chunk's or whose CRC-32C does not match.
"""
from __future__ import annotations

import json
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from citlab_as_tpu_torch.utils import zstd

_KINDS = {"f": (2, 4, 8), "i": (1, 2, 4, 8), "u": (1, 2, 4, 8), "b": (1,)}
_V3_TYPES = {"bool": "|b1", "int8": "|i1", "int16": "<i2", "int32": "<i4",
             "int64": "<i8", "uint8": "|u1", "uint16": "<u2", "uint32": "<u4",
             "uint64": "<u8", "float16": "<f2", "float32": "<f4", "float64": "<f8"}
#: an inner chunk of a shard that was never stored
_ABSENT = 2 ** 64 - 1

Array = Union[np.ndarray, torch.Tensor]


class ZarrError(ValueError):
    """A zarr array this reader does not read, or a damaged one."""


def _dtype(spec, what: str) -> Union[np.dtype, torch.dtype]:
    if spec == "bfloat16":
        return torch.bfloat16
    if not isinstance(spec, str) or len(spec) < 3 or spec[0] not in "<|":
        raise ZarrError(f"{what}: dtype {spec!r} is not read")
    kind, size = spec[1], spec[2:]
    if kind not in _KINDS or not size.isdigit() or int(size) not in _KINDS[kind]:
        raise ZarrError(f"{what}: dtype {spec!r} is not read")
    if (spec[0] == "|") != (int(size) == 1):
        raise ZarrError(f"{what}: dtype {spec!r} is not read")
    return np.dtype(spec)


def _fill(value, dtype, what: str):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
        if value not in named or not (dtype is torch.bfloat16 or dtype.kind == "f"):
            raise ZarrError(f"{what}: fill_value {value!r} is not read")
        return named[value]
    if isinstance(value, (bool, int, float)):
        return value
    raise ZarrError(f"{what}: fill_value {value!r} is not read")


def _json(raw: Optional[bytes], key: str) -> dict:
    if raw is None:
        raise ZarrError(f"{key}: not stored")
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise ZarrError(f"{key}: not JSON ({e})") from None
    if not isinstance(meta, dict):
        raise ZarrError(f"{key}: not a JSON object")
    return meta


def _shape(value, what: str, positive: bool) -> List[int]:
    if (not isinstance(value, list)
            or not all(isinstance(s, int) and not isinstance(s, bool)
                       and s >= (1 if positive else 0) for s in value)):
        raise ZarrError(f"{what} {value!r} malformed")
    return value


class _Out:
    """The array being read: filled with the fill value, chunks placed in
    it, bf16 held as its 16-bit patterns."""

    def __init__(self, shape, dtype, fill):
        self.dtype = dtype
        self.host = np.dtype("<u2") if dtype is torch.bfloat16 else dtype
        if dtype is torch.bfloat16:
            bits = torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16).item()
            self.array = np.full(shape, bits & 0xFFFF, np.uint16)
        else:
            self.array = np.full(shape, fill, dtype)

    def chunk(self, data: bytes, shape: Sequence[int], key: str) -> np.ndarray:
        want = int(np.prod(shape, dtype=np.int64)) * self.host.itemsize
        if len(data) != want:
            raise ZarrError(f"{key}: {len(data)} bytes, the chunk holds {want}")
        chunk = np.frombuffer(data, self.host).reshape(shape)
        if self.host.kind == "b" and chunk.view(np.uint8).max(initial=0) > 1:
            raise ZarrError(f"{key}: bool bytes other than 0 and 1")
        return chunk

    def place(self, chunk: np.ndarray, origin: Sequence[int]) -> None:
        sel = tuple(slice(o, min(o + c, s))
                    for o, c, s in zip(origin, chunk.shape, self.array.shape))
        if all(x.stop > x.start for x in sel):
            self.array[sel] = chunk[tuple(slice(0, x.stop - x.start) for x in sel)]

    def result(self) -> Array:
        if self.dtype is torch.bfloat16:
            return torch.from_numpy(self.array.view(np.int16)).view(torch.bfloat16)
        return self.array


# ---------------------------------------------------------------- zarr v2

def read_array(read: Callable[[str], Optional[bytes]], name: str) -> Array:
    """The zarr v2 array ``name`` of a store whose ``read(key)`` gives a
    value's bytes, or None for a key it lacks. bfloat16 arrays come back as
    ``torch.bfloat16`` tensors, every other dtype as numpy arrays."""
    raw = read(f"{name}/.zarray")
    if raw is None:
        raise ZarrError(f"{name}: no .zarray")
    meta = _json(raw, f"{name}/.zarray")
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')!r} is not read (only 2)")
    dtype = _dtype(meta.get("dtype"), name)
    if meta.get("order", "C") != "C":
        raise ZarrError(f"{name}: order {meta.get('order')!r} is not read (only \"C\")")
    if meta.get("filters") not in (None, []):
        raise ZarrError(f"{name}: filters {meta['filters']!r} are not read")
    comp = meta.get("compressor")
    if comp is not None and (not isinstance(comp, dict) or comp.get("id") != "zstd"):
        raise ZarrError(f"{name}: compressor {comp!r} is not read (zstd or none)")
    if meta.get("dimension_separator", ".") != ".":
        raise ZarrError(f"{name}: dimension_separator "
                        f"{meta['dimension_separator']!r} is not read (only \".\")")
    shape, chunks = meta.get("shape"), meta.get("chunks")
    if (not isinstance(shape, list) or not isinstance(chunks, list)
            or len(shape) != len(chunks)
            or not all(isinstance(s, int) and not isinstance(s, bool) and s >= 0 for s in shape)
            or not all(isinstance(c, int) and not isinstance(c, bool) and c > 0
                       for c in chunks)):
        raise ZarrError(f"{name}: shape {shape!r} / chunks {chunks!r} malformed")
    out = _Out(shape, dtype, _fill(meta.get("fill_value"), dtype, name))
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{'.'.join(str(i) for i in index) if index else '0'}"
        data = read(key)
        if data is None:
            continue
        if comp is not None:
            try:
                data = zstd.decompress(data)
            except zstd.ZstdError as e:
                raise ZarrError(f"{key}: {e}") from None
        out.place(out.chunk(data, chunks, key), [i * c for i, c in zip(index, chunks)])
    return out.result()


def _zarr_dtype(array: Array) -> str:
    """The zarr v2 ``dtype`` of ``array`` (a numpy array or a bf16 tensor)."""
    if isinstance(array, torch.Tensor):
        if array.dtype != torch.bfloat16:
            raise ZarrError(f"a {array.dtype} tensor: give its numpy array "
                            "(only bfloat16 stays a tensor)")
        return "bfloat16"
    dt = array.dtype
    if dt.kind not in _KINDS or dt.itemsize not in _KINDS[dt.kind]:
        raise ZarrError(f"dtype {dt.str!r} is not written")
    return ("|" if dt.itemsize == 1 else "<") + dt.kind + str(dt.itemsize)


def write_array(write: Callable[[str, bytes], None], name: str, array: Array) -> None:
    """Store ``array`` (a numpy array, or a ``torch.bfloat16`` tensor) as the
    zarr v2 array ``name`` through ``write(key, value)``: its ``.zarray``
    and one chunk holding all of it, as orbax writes an array of one
    device. A 0-size array is refused, as orbax refuses it."""
    spec = _zarr_dtype(array)
    if isinstance(array, torch.Tensor):
        host = array.detach().cpu().contiguous().view(torch.int16).numpy()
    else:
        host = np.asarray(array, np.dtype(spec.replace("|", "<")))
        if not host.flags.c_contiguous:
            host = host.copy(order="C")     # (ascontiguousarray makes 0-d 1-d)
    shape = list(host.shape)
    if host.size == 0:
        raise ZarrError(f"{name}: an array of zero size {shape} is not written")
    meta = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": spec, "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    write(f"{name}/.zarray", json.dumps(meta, separators=(",", ":")).encode())
    write(f"{name}/{'.'.join('0' * host.ndim) or '0'}", zstd.compress(host))


# ---------------------------------------------------------------- zarr v3

def _codec(entry, what: str) -> Tuple[str, dict]:
    if not isinstance(entry, dict) or not isinstance(entry.get("name"), str):
        raise ZarrError(f"{what}: codec {entry!r} malformed")
    config = entry.get("configuration", {})
    if not isinstance(config, dict):
        raise ZarrError(f"{what}: codec {entry['name']!r} configuration malformed")
    return entry["name"], config


def _chain(codecs, what: str) -> List[str]:
    """The bytes -> bytes codecs after ``bytes`` (little-endian) of a chunk's
    chain: ``zstd`` and ``crc32c``; anything else is refused by name."""
    if not isinstance(codecs, list) or not codecs:
        raise ZarrError(f"{what}: codecs {codecs!r} malformed")
    name, config = _codec(codecs[0], what)
    if name != "bytes":
        raise ZarrError(f"{what}: codec {name!r} is not read (the chain starts with "
                        "\"bytes\")")
    if config.get("endian", "little") != "little":
        raise ZarrError(f"{what}: bytes codec endian {config['endian']!r} is not read "
                        "(only \"little\")")
    out = []
    for entry in codecs[1:]:
        name, config = _codec(entry, what)
        if name not in ("zstd", "crc32c"):
            raise ZarrError(f"{what}: codec {name!r} is not read (bytes, then zstd or "
                            "crc32c)")
        out.append(name)
    return out


def _decode(data: bytes, chain: List[str], key: str) -> bytes:
    for name in reversed(chain):
        if name == "crc32c":
            if len(data) < 4 or zstd.crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
                raise ZarrError(f"{key}: CRC-32C mismatch")
            data = data[:-4]
        else:
            try:
                data = zstd.decompress(data)
            except zstd.ZstdError as e:
                raise ZarrError(f"{key}: {e}") from None
    return data


def read_array_v3(read: Callable[[str], Optional[bytes]], name: str) -> Array:
    """The zarr v3 array ``name`` of a store (``read`` as in
    :func:`read_array`), as orbax's ``use_zarr3`` writes it."""
    meta = _json(read(f"{name}/zarr.json"), f"{name}/zarr.json")
    if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')!r} node_type "
                        f"{meta.get('node_type')!r} is not read (only a v3 array)")
    if meta.get("storage_transformers") not in (None, []):
        raise ZarrError(f"{name}: storage_transformers are not read")
    spec = meta.get("data_type")
    if spec != "bfloat16" and spec not in _V3_TYPES:
        raise ZarrError(f"{name}: data_type {spec!r} is not read")
    dtype = _dtype(_V3_TYPES.get(spec, spec), name)
    shape = _shape(meta.get("shape"), f"{name}: shape", False)
    grid_name, grid = _codec(meta.get("chunk_grid"), f"{name}: chunk_grid")
    chunks = _shape(grid.get("chunk_shape"), f"{name}: chunk_shape", True)
    if grid_name != "regular" or len(chunks) != len(shape):
        raise ZarrError(f"{name}: chunk_grid {meta.get('chunk_grid')!r} is not read "
                        "(only a regular grid of the array's rank)")
    enc_name, enc = _codec(meta.get("chunk_key_encoding"), f"{name}: chunk_key_encoding")
    if enc_name != "default" or enc.get("separator", "/") != "/":
        raise ZarrError(f"{name}: chunk_key_encoding {meta.get('chunk_key_encoding')!r} "
                        "is not read (only \"default\" with \"/\")")
    codecs = meta.get("codecs")
    if not isinstance(codecs, list) or len(codecs) != 1:
        raise ZarrError(f"{name}: codecs {codecs!r} are not read (only sharding_indexed)")
    codec, shard = _codec(codecs[0], name)
    if codec != "sharding_indexed":
        raise ZarrError(f"{name}: codec {codec!r} is not read (only sharding_indexed)")
    inner = _shape(shard.get("chunk_shape"), f"{name}: sharding chunk_shape", True)
    if len(inner) != len(chunks) or any(c % i for c, i in zip(chunks, inner)):
        raise ZarrError(f"{name}: inner chunks {inner} do not divide the shard {chunks}")
    chain = _chain(shard.get("codecs"), f"{name}: sharding codecs")
    index_chain = _chain(shard.get("index_codecs"), f"{name}: index_codecs")
    if "zstd" in index_chain:
        raise ZarrError(f"{name}: a compressed shard index is not read")
    if shard.get("index_location", "end") != "end":
        raise ZarrError(f"{name}: index_location {shard['index_location']!r} is not read "
                        "(only \"end\")")
    sub = [c // i for c, i in zip(chunks, inner)]
    n = int(np.prod(sub, dtype=np.int64))
    size = 16 * n + 4 * index_chain.count("crc32c")
    out = _Out(shape, dtype, _fill(meta.get("fill_value"), dtype, name))
    for index in np.ndindex(*[-(-s // c) for s, c in zip(shape, chunks)]):
        key = "/".join([name, "c"] + [str(i) for i in index])
        data = read(key)
        if data is None:
            continue
        if len(data) < size:
            raise ZarrError(f"{key}: {len(data)} bytes, shorter than its index")
        table = np.frombuffer(_decode(data[-size:], index_chain, key + " index"), "<u8")
        if table.size != 2 * n:
            raise ZarrError(f"{key}: index holds {table.size // 2} entries, not {n}")
        for k, pos in enumerate(np.ndindex(*sub)):
            offset, length = int(table[2 * k]), int(table[2 * k + 1])
            if offset == _ABSENT and length == _ABSENT:
                continue
            if offset + length > len(data) - size:
                raise ZarrError(f"{key}: inner chunk {pos} bytes [{offset}, "
                                f"{offset + length}) past the shard's {len(data) - size}")
            what = f"{key} inner chunk {pos}"
            chunk = out.chunk(_decode(data[offset:offset + length], chain, what), inner, what)
            out.place(chunk, [i * c + p * q for i, c, p, q in zip(index, chunks, pos, inner)])
    return out.result()
