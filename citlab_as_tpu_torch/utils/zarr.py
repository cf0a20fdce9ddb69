"""zarr v2 arrays read from a key-value store, as tensorstore's zarr driver
writes them for orbax inside OCDBT: ``<name>/.zarray`` (JSON metadata) and
one value per chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array).

Read: dtypes ``<f2 <f4 <f8``, ``|i1 <i2 <i4 <i8``, ``|u1 <u2 <u4 <u8``,
``|b1`` and ``bfloat16`` (read as a ``torch.bfloat16`` tensor, the way
``utils/msgpack.py`` holds bf16, since numpy has no bfloat16); ``order``
"C"; any shape, 0-d and 0-size included, cut into ``chunks`` (the edge
chunks stored whole, as zarr pads them); ``dimension_separator`` ".";
the compressor zstd or none; ``fill_value`` (a number, "NaN", "Infinity",
"-Infinity", a bool, or null for zeros) where a chunk was never stored.
Anything else (another zarr format, compressor, filter, separator or
order, a big-endian, structured or string dtype) raises
:class:`ZarrError` by name, as does a chunk whose decoded size is not its
chunk's.
"""
from __future__ import annotations

import json
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from citlab_as_tpu_torch.utils import zstd

_KINDS = {"f": (2, 4, 8), "i": (1, 2, 4, 8), "u": (1, 2, 4, 8), "b": (1,)}


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


def read_array(read: Callable[[str], Optional[bytes]], name: str
               ) -> Union[np.ndarray, torch.Tensor]:
    """The zarr v2 array ``name`` of a store whose ``read(key)`` gives a
    value's bytes, or None for a key it lacks. bfloat16 arrays come back as
    ``torch.bfloat16`` tensors, every other dtype as numpy arrays."""
    raw = read(f"{name}/.zarray")
    if raw is None:
        raise ZarrError(f"{name}: no .zarray")
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise ZarrError(f"{name}/.zarray: not JSON ({e})") from None
    if not isinstance(meta, dict):
        raise ZarrError(f"{name}/.zarray: not a JSON object")
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
    fill = _fill(meta.get("fill_value"), dtype, name)
    host = np.dtype("<u2") if dtype is torch.bfloat16 else dtype
    if dtype is torch.bfloat16:
        bits = torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16).item()
        out = np.full(shape, bits & 0xFFFF, np.uint16)
    else:
        out = np.full(shape, fill, dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * host.itemsize
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
        if len(data) != chunk_bytes:
            raise ZarrError(f"{key}: {len(data)} bytes, the chunk holds {chunk_bytes}")
        chunk = np.frombuffer(data, host).reshape(chunks)
        if host.kind == "b" and chunk.view(np.uint8).max(initial=0) > 1:
            raise ZarrError(f"{key}: bool bytes other than 0 and 1")
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[sel] = chunk[tuple(slice(0, x.stop - x.start) for x in sel)]
    if dtype is torch.bfloat16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
