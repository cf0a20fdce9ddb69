"""A stdlib reader and writer for flax's msgpack state (the ``params.msgpack``
of a ``.frozen`` artifact; ``flax.serialization.to_bytes`` /
``msgpack_restore`` of the JAX package's ``train/export.py``).

It covers what flax writes: maps with str keys (a list or tuple is written
as flax's state dict of it, a map from ``str(index)``), ints, floats,
bools, None, bin and str, and flax's
ext types: 1 an ndarray (the msgpack triple ``(shape, dtype name, C-order
bytes)``), 2 a Python complex (``(real, imag)``), 3 a numpy scalar (a 0-d
ndarray triple). An array leaf larger than :data:`MAX_CHUNK_SIZE` bytes is
written as flax's chunked dict (``{'__msgpack_chunked_array__': True,
'shape': {'0': d0, ...}, 'chunks': {'0': flat0, ...}}``) and read back
whole. Encodings are the smallest msgpack allows, as msgpack-python's
packer chooses them, so :func:`packb` gives flax's bytes for the same dict
(same insertion order).

Arrays read back as numpy arrays; ``bfloat16``, which numpy lacks, reads as
a ``torch.bfloat16`` tensor, and a bf16 tensor writes with that dtype name.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

#: arrays above this many bytes are written in chunks (flax 0.12.3's
#: ``serialization.MAX_CHUNK_SIZE``: msgpack caps one bin at 2**31 - 1)
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------- writing

def _pack_int(n: int, out: bytearray) -> None:
    if n < -(1 << 5):
        if n < -(1 << 15):
            if n < -(1 << 31):
                if n < -(1 << 63):
                    raise OverflowError(f"int {n} is out of msgpack's range")
                out += b"\xd3" + struct.pack(">q", n)
            else:
                out += b"\xd2" + struct.pack(">i", n)
        elif n < -(1 << 7):
            out += b"\xd1" + struct.pack(">h", n)
        else:
            out += b"\xd0" + struct.pack(">b", n)
    elif n < (1 << 7):
        out += struct.pack(">b", n)
    elif n < (1 << 8):
        out += b"\xcc" + struct.pack(">B", n)
    elif n < (1 << 16):
        out += b"\xcd" + struct.pack(">H", n)
    elif n < (1 << 32):
        out += b"\xce" + struct.pack(">I", n)
    elif n < (1 << 64):
        out += b"\xcf" + struct.pack(">Q", n)
    else:
        raise OverflowError(f"int {n} is out of msgpack's range")


def _pack_header(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...],
                 out: bytearray) -> None:
    """Length header: the fix form below ``fix_max``, then 8 / 16 / 32-bit
    lengths (``codes`` lists the available ones from the shortest)."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I")[-len(codes):],
                                (1 << 8, 1 << 16, 1 << 32)[-len(codes):]):
        if n < limit:
            out += code + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_str(s: str, out: bytearray) -> None:
    data = s.encode("utf-8")
    _pack_header(len(data), 0xa0, 32, (b"\xd9", b"\xda", b"\xdb"), out)
    out += data


def _pack_bin(data: bytes, out: bytearray) -> None:
    n = len(data)
    if n < (1 << 8):
        out += b"\xc4" + struct.pack(">B", n)
    elif n < (1 << 16):
        out += b"\xc5" + struct.pack(">H", n)
    else:
        out += b"\xc6" + struct.pack(">I", n)
    out += data


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
    if n in fixed:
        out += fixed[n]
    elif n < (1 << 8):
        out += b"\xc7" + struct.pack(">B", n)
    elif n < (1 << 16):
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code) + data


def _array_triple(arr) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _ndarray_bytes(arr) -> bytes:
    shape, name, data = _array_triple(arr)
    out = bytearray()
    _pack_header(3, 0x90, 16, (b"\xdc", b"\xdd"), out)
    _pack_header(len(shape), 0x90, 16, (b"\xdc", b"\xdd"), out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    _pack_bin(data, out)
    return bytes(out)


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk(arr) -> Dict[str, Any]:
    """flax's ``_chunk``: the flattened array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj, out: bytearray, chunk: bool) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if chunk and _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out, False)
        else:
            _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is complex:
        inner = bytearray(b"\x92")
        for part in (obj.real, obj.imag):
            inner += b"\xcb" + struct.pack(">d", part)
        _pack_ext(EXT_COMPLEX, bytes(inner), out)
    elif type(obj) is str:
        _pack_str(obj, out)
    elif type(obj) in (bytes, bytearray):
        _pack_bin(bytes(obj), out)
    elif type(obj) in (list, tuple):
        # flax's state dict of a sequence: a map from str(index)
        _pack({str(i): item for i, item in enumerate(obj)}, out, chunk)
    elif type(obj) is dict:
        _pack_header(len(obj), 0x80, 16, (b"\xde", b"\xdf"), out)
        for key, value in obj.items():
            _pack(key, out, chunk)
            _pack(value, out, chunk)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def packb(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict of arrays, tensors
    and Python scalars: arrays above :data:`MAX_CHUNK_SIZE` bytes chunked,
    as flax does for dict values and a top-level array."""
    out = bytearray()
    _pack(tree, out, True)
    return bytes(out)


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _dtype_from_name(name: bytes):
    if name == b"bfloat16":
        return torch.bfloat16
    return np.dtype(name.decode("ascii"))


def _ndarray_from_bytes(data: bytes):
    shape, name, buffer = _unpack(_Reader(data), raw=True)
    dtype = _dtype_from_name(name)
    shape = tuple(shape)
    if dtype is torch.bfloat16:
        flat = np.frombuffer(bytes(buffer), dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(bytes(buffer), dtype=dtype).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        real, imag = _unpack(_Reader(data), raw=False)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        arr = _ndarray_from_bytes(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"unknown msgpack ext type {code}")


_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LENGTHS = {0: ">B", 1: ">H", 2: ">I"}


def _unpack(r: _Reader, raw: bool):
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f, raw)
    if 0x90 <= b <= 0x9f:
        return [_unpack(r, raw) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f, raw)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in (0xc4, 0xc5, 0xc6):
        return bytes(r.take(r.unpack(_LENGTHS[b - 0xc4])))
    if b in (0xc7, 0xc8, 0xc9):
        n = r.unpack(_LENGTHS[b - 0xc7])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xd4 <= b <= 0xd8:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xd4))))
    if b in (0xd9, 0xda, 0xdb):
        return _str(r, r.unpack(_LENGTHS[b - 0xd9]), raw)
    if b in (0xdc, 0xdd):
        n = r.unpack(_LENGTHS[b - 0xdc + 1])
        return [_unpack(r, raw) for _ in range(n)]
    if b in (0xde, 0xdf):
        return _map(r, r.unpack(_LENGTHS[b - 0xde + 1]), raw)
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    data = bytes(r.take(n))
    return data if raw else data.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(r, raw)
        out[key] = _unpack(r, raw)
    return out


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts -> arrays."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """``flax.serialization.msgpack_restore``: bytes -> nested dicts of
    numpy arrays (bf16 as tensors) and Python values."""
    r = _Reader(data)
    tree = _unpack(r, raw=False)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)
