"""AVIF as PIL 12.1 reads it: ``AvifImagePlugin`` hands the file to libavif
1.3.0, which parses the HEIF container, decodes the primary item's AV1 with
dav1d 1.5.1 and converts it to RGB with ``avifImageYUVToRGB`` (through
libyuv where libyuv has the matrix). Equal bit for bit to
``Image.open(path).convert(mode)``.

The container is parsed here as libavif parses it under PIL's settings
(libavif's strict flags less ``pixi``-required and ``clap``-valid, which
PIL clears): ``ftyp`` with its brands; ``meta`` with ``hdlr`` ``pict``,
``pitm``, ``iinf`` / ``infe`` v2-v3, ``iloc`` v0-v2 (construction methods
0 and 1, the latter from ``idat``), ``iref`` (``auxl``, ``prem``, ``thmb``,
``cdsc``; a ``grid`` item's ``dimg`` is part 3's) and ``iprp`` / ``ipco`` / ``ipma`` with ``ispe``,
``av1C``, ``pixi``, ``colr`` (``nclx``, ``prof``, ``rICC``), ``auxC``,
``irot``, ``imir``, ``clap``, ``pasp``. The primary item's OBUs go to the
port's AV1 intra-frame decoder (``csrc/av1_decode.cpp``, built with the
host C++ compiler at first use). ``irot`` / ``imir`` and ``clap`` change
PIL's EXIF orientation and info only, never the pixels. An alpha item is
decoded (so that a damaged one fails as it fails in PIL) and dropped, as
PIL's ``convert`` drops alpha.

The decoder gives 8-, 10- or 12-bit planes (uint8 or uint16). The YUV ->
RGB conversion takes the route libavif takes (:func:`conversion`):
libyuv's fixed-point one (6-bit coefficients, ``kYuvJPEGConstants`` and its
siblings) after libyuv's bilinear 2x chroma upsampling, for BT.601 (matrix
5, 6 and unspecified), BT.709, BT.2020-NCL and matrix 12 over their
primaries, in full and limited range (samples above 8 bits shifted to 8
first, or for a file with alpha converted at their depth); else libavif's
own float conversion (FCC, SMPTE 240M, YCgCo, YCgCo-Re, matrix 12 from its
primaries, the identity matrix, monochrome). The matrix, primaries and
range come from the ``colr`` ``nclx`` box, else from the AV1 sequence
header.

A file PIL's open rejects as not AVIF (a ``SyntaxError`` from libavif's
``BMFF_PARSE_FAILED``, ``INVALID_FTYP``, ``TRUNCATED_DATA``, ``NO_CONTENT``)
raises ``SyntaxError`` here, so that :func:`raster_formats.identify` tries
PIL's next plugin; any other failure of PIL's raises
:class:`raster_formats.Refused`. The tools this decoder leaves to part 3
(film grain, ``grid`` items, ``avis`` sequences, premultiplied alpha, a
frame of another size than ``ispe``) are refused by name, naming "part 3".
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from citlab_as_tpu_torch.utils.raster_formats import Refused

_ERRLEN = 512
_INFO_LEN = 22
PART3 = "queued for part 3 of the AVIF decoder"


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("av1_decode")
    lib.citlab_av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
                                      ctypes.c_int32]
    lib.citlab_av1_decode.restype = ctypes.c_int32
    lib.citlab_yuv_to_rgb.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.citlab_yuv_to_rgb.restype = None
    lib.citlab_yuv_to_rgb_float.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.citlab_yuv_to_rgb_float.restype = None
    lib.citlab_avif_derived_kr_kb.argtypes = [ctypes.c_int32, ctypes.c_void_p]
    lib.citlab_avif_derived_kr_kb.restype = None
    return lib


# ------------------------------------------------------------------ reading

class _Stream:
    """libavif's avifROStream: a read past the end fails the parse."""

    def __init__(self, data: bytes, start: int = 0, end: Optional[int] = None):
        self.data, self.pos = data, start
        self.end = len(data) if end is None else end

    def left(self) -> int:
        return self.end - self.pos

    def take(self, n: int) -> bytes:
        if n < 0 or n > self.left():
            raise SyntaxError("AVIF box runs past its parent's end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.take(8))[0]

    def ux(self, size: int) -> int:
        if size == 0:
            return 0
        if size == 4:
            return self.u32()
        if size == 8:
            return self.u64()
        raise SyntaxError(f"AVIF iloc: field size {size}")

    def version_flags(self) -> Tuple[int, int]:
        v = self.u32()
        return v >> 24, v & 0xFFFFFF

    def string(self) -> bytes:
        """A null-terminated string inside the stream."""
        i = self.data.find(b"\0", self.pos, self.end)
        if i < 0:
            raise SyntaxError("AVIF string without its terminating null")
        out = self.data[self.pos:i]
        self.pos = i + 1
        return out

    def box_header(self, top_level: bool = False) -> Tuple[bytes, int, int]:
        """(type, payload start, payload end); a top-level box of size 0
        runs to the end of the data (``size_zero`` says so)."""
        start = self.pos
        size = self.u32()
        kind = self.take(4)
        if size == 1:
            size = self.u64()
        if kind == b"uuid":
            self.take(16)
        head = self.pos - start
        self.size_zero = size == 0
        if size == 0:
            if not top_level:
                raise SyntaxError(f"AVIF box {kind!r} of size 0 inside another box")
            return kind, self.pos, self.end
        if size < head:
            raise SyntaxError(f"AVIF box {kind!r} smaller than its header")
        if size - head > self.left() and not top_level:
            raise SyntaxError(f"AVIF box {kind!r} runs past its parent's end")
        return kind, self.pos, start + size


# ------------------------------------------------------------------ the model

@dataclass
class _Item:
    id: int
    type: bytes = b""
    content_type: bytes = b""
    construction: int = 0
    extents: List[Tuple[int, int]] = field(default_factory=list)
    size: int = 0
    has_extents: bool = False
    props: List[Tuple[bytes, object]] = field(default_factory=list)
    ipma_seen: bool = False
    unsupported_essential: bool = False
    aux_for: int = 0
    prem_by: int = 0
    thumbnail_for: int = 0
    desc_for: int = 0

    def prop(self, kind: bytes):
        for k, v in self.props:
            if k == kind:
                return v
        return None


@dataclass
class _Meta:
    items: Dict[int, _Item] = field(default_factory=dict)
    order: List[int] = field(default_factory=list)
    properties: List[Tuple[bytes, object]] = field(default_factory=list)
    primary: int = 0
    idat: bytes = b""

    def item(self, item_id: int) -> _Item:
        if item_id not in self.items:
            self.items[item_id] = _Item(item_id)
            self.order.append(item_id)
        return self.items[item_id]


_SUPPORTED_PROPS = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir",
                    b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


def _parse_property(kind: bytes, s: _Stream):
    if kind == b"ispe":
        v, _ = s.version_flags()
        if v != 0:
            raise SyntaxError(f"AVIF ispe version {v}")
        return s.u32(), s.u32()
    if kind == b"auxC":
        s.version_flags()  # libavif does not hold auxC to version 0
        return s.string()
    if kind == b"colr":
        ctype = s.take(4)
        if ctype == b"nclx":
            p, t, m = s.u16(), s.u16(), s.u16()
            flags = s.u8()
            if flags & 0x7F:
                raise SyntaxError("AVIF colr nclx: non-zero reserved bits")
            return ("nclx", p, t, m, flags >> 7)
        if ctype in (b"rICC", b"prof"):
            return ("icc", s.take(s.left()))
        return ("other",)
    if kind == b"av1C":
        marker = s.u8()
        if marker != 0x81:
            raise SyntaxError("AVIF av1C: bad marker or version")
        b1, b2 = s.u8(), s.u8()
        s.u8()
        return {"profile": b1 >> 5, "high_bitdepth": (b2 >> 6) & 1, "twelve_bit": (b2 >> 5) & 1,
                "mono": (b2 >> 4) & 1, "ssx": (b2 >> 3) & 1, "ssy": (b2 >> 2) & 1}
    if kind == b"pasp":
        return s.u32(), s.u32()
    if kind == b"clap":
        return tuple(s.u32() for _ in range(8))
    if kind == b"irot":
        angle = s.u8()
        if angle & 0xFC:
            raise SyntaxError("AVIF irot: non-zero reserved bits")
        return angle & 3
    if kind == b"imir":
        mode = s.u8()
        if mode & 0xFE:
            raise SyntaxError("AVIF imir: non-zero reserved bits")
        return mode & 1
    if kind == b"pixi":
        v, _ = s.version_flags()
        if v != 0:
            raise SyntaxError(f"AVIF pixi version {v}")
        n = s.u8()
        if n > 8:
            raise SyntaxError(f"AVIF pixi: {n} planes")
        return [s.u8() for _ in range(n)]
    if kind == b"a1op":
        op = s.u8()
        if op > 31:
            raise SyntaxError(f"AVIF a1op: operating point {op}")
        return op
    if kind == b"lsel":
        layer = s.u16()
        if layer != 0xFFFF and layer >= 4:
            raise SyntaxError(f"AVIF lsel: layer {layer}")
        return layer
    if kind == b"a1lx":
        flags = s.u8()
        size = 4 if flags & 1 else 2
        for _ in range(3):
            s.take(size)
        return None
    if kind == b"clli":
        return s.u16(), s.u16()
    return None


def _parse_ipco(meta: _Meta, s: _Stream) -> None:
    while s.left() > 0:
        kind, start, end = s.box_header()
        sub = _Stream(s.data, start, end)
        value = _parse_property(kind, sub) if kind in _SUPPORTED_PROPS else None
        meta.properties.append((kind, value))
        s.pos = end


def _parse_ipma(meta: _Meta, s: _Stream) -> int:
    version, flags = s.version_flags()
    wide = flags & 1
    count = s.u32()
    prev = 0
    for _ in range(count):
        item_id = s.u16() if version < 1 else s.u32()
        if item_id == 0:
            raise SyntaxError("AVIF ipma: item ID 0")
        if item_id <= prev:
            raise SyntaxError("AVIF ipma: item IDs out of order")
        prev = item_id
        item = meta.item(item_id)
        if item.ipma_seen:
            raise SyntaxError(f"AVIF ipma: item {item_id} associated twice")
        item.ipma_seen = True
        for _ in range(s.u8()):
            if wide:
                v = s.u16()
                essential, index = v >> 15, v & 0x7FFF
            else:
                v = s.u8()
                essential, index = v >> 7, v & 0x7F
            if index == 0:
                if essential:
                    raise SyntaxError("AVIF ipma: essential property index 0")
                continue
            index -= 1
            if index >= len(meta.properties):
                raise SyntaxError(f"AVIF ipma: property index {index + 1} past the "
                                  f"{len(meta.properties)} properties")
            kind, value = meta.properties[index]
            if kind in _SUPPORTED_PROPS:
                if essential and kind == b"a1lx":
                    raise SyntaxError("AVIF ipma: a1lx marked essential")
                if not essential and kind in (b"clap", b"irot", b"imir", b"a1op", b"lsel"):
                    raise SyntaxError(f"AVIF ipma: {kind.decode()} not marked essential")
                item.props.append((kind, value))
            elif essential:
                item.unsupported_essential = True
    return (version << 24) | flags


def _parse_iprp(meta: _Meta, s: _Stream) -> None:
    kind, start, end = s.box_header()
    if kind != b"ipco":
        raise SyntaxError("AVIF iprp: its first box is not ipco")
    _parse_ipco(meta, _Stream(s.data, start, end))
    s.pos = end
    seen = set()
    while s.left() > 0:
        kind, start, end = s.box_header()
        if kind != b"ipma":
            raise SyntaxError(f"AVIF iprp: box {kind!r} where ipma belongs")
        vf = _parse_ipma(meta, _Stream(s.data, start, end))
        if vf in seen:
            raise SyntaxError("AVIF iprp: two ipma boxes of one version and flags")
        seen.add(vf)
        s.pos = end


def _parse_iloc(meta: _Meta, s: _Stream) -> None:
    version, _ = s.version_flags()
    if version > 2:
        raise SyntaxError(f"AVIF iloc version {version}")
    b1, b2 = s.u8(), s.u8()
    offset_size, length_size, base_size = b1 >> 4, b1 & 15, b2 >> 4
    index_size = b2 & 15 if version in (1, 2) else 0
    for size in (offset_size, length_size, base_size, index_size):
        if size not in (0, 4, 8):
            raise SyntaxError(f"AVIF iloc: field size {size}")
    count = s.u16() if version < 2 else s.u32()
    for _ in range(count):
        item_id = s.u16() if version < 2 else s.u32()
        item = meta.item(item_id)
        if item.has_extents:
            raise SyntaxError(f"AVIF iloc: item {item_id} located twice")
        item.has_extents = True
        if version in (1, 2):
            method = s.u16() & 15
            if method not in (0, 1):
                raise SyntaxError(f"AVIF iloc: construction method {method}")
            item.construction = method
        s.u16()  # data_reference_index
        base = s.ux(base_size)
        for _ in range(s.u16()):
            if index_size:
                s.ux(index_size)
            off = s.ux(offset_size)
            length = s.ux(length_size)
            item.extents.append((base + off, length))
            item.size += length


def _parse_iinf(meta: _Meta, s: _Stream) -> None:
    version, _ = s.version_flags()
    if version > 1:
        raise SyntaxError(f"AVIF iinf version {version}")
    count = s.u16() if version == 0 else s.u32()
    for _ in range(count):
        kind, start, end = s.box_header()
        if kind != b"infe":
            raise SyntaxError(f"AVIF iinf: box {kind!r} where infe belongs")
        e = _Stream(s.data, start, end)
        v, _ = e.version_flags()
        if v not in (2, 3):
            raise SyntaxError(f"AVIF infe version {v}")
        item_id = e.u16() if v == 2 else e.u32()
        if item_id == 0:
            raise SyntaxError("AVIF infe: item ID 0")
        e.u16()  # item_protection_index
        item_type = e.take(4)
        e.string()  # item_name
        content_type = e.string() if item_type == b"mime" else b""
        item = meta.item(item_id)
        item.type, item.content_type = item_type, content_type
        s.pos = end


def _parse_iref(meta: _Meta, s: _Stream) -> None:
    version, _ = s.version_flags()
    if version > 1:
        return  # libavif skips an iref of an unknown version
    while s.left() > 0:
        kind, start, end = s.box_header()
        r = _Stream(s.data, start, end)
        from_id = r.u16() if version == 0 else r.u32()
        if from_id == 0:
            raise SyntaxError("AVIF iref: item ID 0")
        n = r.u16()
        for i in range(n):
            to_id = r.u16() if version == 0 else r.u32()
            if to_id == 0:
                raise SyntaxError("AVIF iref: item ID 0")
            item = meta.item(from_id)
            if kind == b"thmb":
                item.thumbnail_for = to_id
            elif kind == b"auxl":
                item.aux_for = to_id
            elif kind == b"cdsc":
                item.desc_for = to_id
            elif kind == b"prem":
                item.prem_by = to_id
        s.pos = end


def _parse_meta(s: _Stream) -> _Meta:
    version, _ = s.version_flags()
    if version != 0:
        raise SyntaxError(f"AVIF meta version {version}")
    meta = _Meta()
    first = True
    seen = set()
    while s.left() > 0:
        kind, start, end = s.box_header()
        sub = _Stream(s.data, start, end)
        if first:
            if kind != b"hdlr":
                raise SyntaxError("AVIF meta: its first box is not hdlr")
            if sub.version_flags()[0] != 0:
                raise SyntaxError("AVIF hdlr version is not 0")
            if sub.u32() != 0:
                raise SyntaxError("AVIF hdlr: non-zero pre_defined")
            handler = sub.take(4)
            if handler != b"pict":
                raise SyntaxError(f"AVIF hdlr: handler {handler!r}, not 'pict'")
            sub.take(12)
            sub.string()
            first = False
        elif kind in (b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            if kind in seen:
                raise SyntaxError(f"AVIF meta: two {kind.decode()} boxes")
            seen.add(kind)
            if kind == b"iloc":
                _parse_iloc(meta, sub)
            elif kind == b"pitm":
                v, _ = sub.version_flags()
                meta.primary = sub.u16() if v == 0 else sub.u32()
            elif kind == b"idat":
                meta.idat = sub.take(sub.left())
            elif kind == b"iprp":
                _parse_iprp(meta, sub)
            elif kind == b"iinf":
                _parse_iinf(meta, sub)
            else:
                _parse_iref(meta, sub)
        s.pos = end
    if first:
        raise SyntaxError("AVIF meta without hdlr")
    return meta


def _brands(payload: bytes) -> Tuple[bytes, List[bytes]]:
    if len(payload) < 8 or (len(payload) - 8) % 4:
        raise SyntaxError("AVIF ftyp of a malformed size")
    return payload[:4], [payload[i:i + 4] for i in range(8, len(payload), 4)]


def _parse_file(data: bytes) -> Tuple[_Meta, bytes]:
    """libavif's avifParse: the top-level boxes up to the ones it needs."""
    s = _Stream(data)
    ftyp_seen = meta_seen = moov_seen = False
    needs_meta = needs_moov = False
    meta = None
    major = b""
    while s.left() > 0:
        if s.left() < 8:
            raise SyntaxError("AVIF: truncated box header")
        kind, start, end = s.box_header(top_level=True)
        if kind in (b"ftyp", b"meta", b"moov"):
            if s.size_zero:
                raise SyntaxError(f"AVIF: {kind.decode()} box of size 0")
            if end > len(data):
                raise SyntaxError(f"AVIF: {kind.decode()} box truncated")
        elif s.size_zero:
            raise SyntaxError(f"AVIF: truncated at the size-0 box {kind!r}")
        if not ftyp_seen and kind != b"ftyp":
            raise SyntaxError("AVIF: the first box is not ftyp")
        if kind == b"ftyp":
            if ftyp_seen:
                raise SyntaxError("AVIF: two ftyp boxes")
            major, compatible = _brands(data[start:end])
            brands = [major] + compatible
            if b"avif" not in brands and b"avis" not in brands:
                raise SyntaxError("AVIF ftyp: neither the avif nor the avis brand")
            ftyp_seen = True
            needs_meta = b"avif" in brands
            needs_moov = b"avis" in brands
        elif kind == b"meta":
            if meta_seen:
                raise SyntaxError("AVIF: two meta boxes")
            meta = _parse_meta(_Stream(data, start, end))
            meta_seen = True
        elif kind == b"moov":
            moov_seen = True
        if ftyp_seen and (not needs_meta or meta_seen) and (not needs_moov or moov_seen):
            break
        if end > len(data):
            raise SyntaxError(f"AVIF: {kind.decode(errors='replace')} box truncated")
        s.pos = end
    if not ftyp_seen:
        raise SyntaxError("AVIF without ftyp")
    if (needs_meta and not meta_seen) or (needs_moov and not moov_seen):
        raise SyntaxError("AVIF: truncated before its meta or moov box")
    return meta, major


# ------------------------------------------------------------------ the image

def _skipped(item: _Item) -> bool:
    return (not item.size or item.unsupported_essential
            or item.type not in (b"av01", b"grid") or item.thumbnail_for != 0)


def _item_data(meta: _Meta, item: _Item, data: bytes) -> bytes:
    src = meta.idat if item.construction == 1 else data
    out = []
    for off, length in item.extents:
        if length == 0:
            length = len(src) - off  # an extent of length 0 runs to the end
        if off > len(src) or off + length > len(src):
            raise SyntaxError(f"AVIF item {item.id}: extent past the end of the "
                              f"{'idat box' if item.construction == 1 else 'file'}")
        out.append(src[off:off + length])
    return b"".join(out)


@dataclass
class AvifInfo:
    width: int
    height: int
    mode: str
    color: _Item
    alpha: Optional[_Item]
    nclx: Optional[tuple]
    meta: _Meta


def open_avif(data: bytes) -> AvifInfo:
    """Parse the container as libavif's avifDecoderParse does under PIL's
    settings; PIL's mode and size."""
    meta, major = _parse_file(data)
    if meta is None or major == b"avis":
        raise Refused(f"AVIF image sequence ('avis' tracks; {PART3})")
    # avifDecoderParse's sanity check: every item it would decode has an
    # ispe (an alpha item's is checked below, with its own message)
    for item_id in meta.order:
        item = meta.items[item_id]
        aux = item.prop(b"auxC")
        if (not _skipped(item) and item.prop(b"ispe") is None
                and not (aux is not None and aux in _ALPHA_URNS)):
            raise SyntaxError(f"AVIF item {item.id} without its mandatory ispe property")
    color = None
    for item_id in meta.order:
        item = meta.items[item_id]
        if _skipped(item):
            continue
        if item.id == meta.primary:
            color = item
            break
    if color is None:
        raise Refused("AVIF: no primary image item (libavif: missing image item)")
    if color.type == b"grid":
        raise Refused(f"AVIF grid item ({PART3})")
    ispe = color.prop(b"ispe")
    if ispe is None:
        raise SyntaxError(f"AVIF item {color.id} without its mandatory ispe property")
    av1c = color.prop(b"av1C")
    if av1c is None:
        raise SyntaxError(f"AVIF item {color.id} without its mandatory av1C property")
    _check_pixi(color, av1c)
    nclx = icc = None
    for kind, value in color.props:
        if kind == b"colr" and value[0] == "nclx":
            if nclx is not None:
                raise SyntaxError("AVIF: two nclx colr properties")
            nclx = value
        elif kind == b"colr" and value[0] == "icc":
            if icc is not None:
                raise SyntaxError("AVIF: two ICC colr properties")
            icc = value
    _read_metadata(meta, color, data)
    alpha = None
    for item_id in meta.order:
        item = meta.items[item_id]
        if _skipped(item) or item.aux_for != color.id:
            continue
        aux = item.prop(b"auxC")
        if aux is not None and aux in _ALPHA_URNS:
            alpha = item
            break
    if alpha is not None:
        if alpha.prop(b"ispe") is None:
            raise SyntaxError(f"AVIF alpha item {alpha.id} without its mandatory ispe property")
        a1c = alpha.prop(b"av1C")
        if a1c is None:
            raise SyntaxError(f"AVIF alpha item {alpha.id} without its mandatory av1C property")
        _check_pixi(alpha, a1c)
        if color.prem_by == alpha.id:
            raise Refused(f"AVIF premultiplied alpha ({PART3})")
    w, h = ispe
    if w == 0 or h == 0:
        raise Refused("AVIF: ispe of zero size")
    # libavif's default image size and dimension limits
    if w * h > 16384 * 16384 or max(w, h) > 32768:
        raise SyntaxError(f"AVIF: {w} x {h} past libavif's image size limit")
    return AvifInfo(w, h, "RGBA" if alpha is not None else "RGB", color, alpha, nclx, meta)


_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                  b"II\x2b\x00")


def _read_metadata(meta: _Meta, color: _Item, data: bytes) -> None:
    """libavif's avifDecoderFindMetadata, which reads the Exif and XMP
    items that describe the colour item while parsing; then PIL's reading
    of the Exif's TIFF header."""
    for item_id in meta.order:
        item = meta.items[item_id]
        if not item.size or item.unsupported_essential or item.desc_for != color.id:
            continue
        if item.type == b"Exif":
            payload = _item_data(meta, item, data)
            if len(payload) < 4:
                raise Refused("AVIF Exif item shorter than its header offset (libavif: invalid "
                              "Exif payload)")
            offset = struct.unpack(">I", payload[:4])[0]
            body = payload[4:]
            found = next((i for i in range(max(0, len(body) - 4))
                          if body[i:i + 4] in (b"MM\0*", b"II*\0")), None)
            if found is None or found != offset:
                raise Refused("AVIF Exif item without a TIFF header at its offset (libavif: "
                              "invalid Exif payload)")
            while body.startswith(b"Exif\x00\x00"):
                body = body[6:]
            if body and body[:4] not in _TIFF_PREFIXES:
                raise SyntaxError("AVIF Exif: not a TIFF header (PIL's Exif.load)")
        elif item.type == b"mime" and item.content_type == b"application/rdf+xml":
            _item_data(meta, item, data)


def _check_pixi(item: _Item, av1c: dict) -> None:
    pixi = item.prop(b"pixi")
    if pixi is None:
        return
    # libavif holds the depths to av1C's, not the number of planes
    depth = 12 if av1c["twelve_bit"] else (10 if av1c["high_bitdepth"] else 8)
    if any(d != depth for d in pixi):
        raise Refused(f"AVIF item {item.id}: pixi depths {pixi} against av1C's {depth} bits "
                      "(libavif: not implemented)")


def _decode_av1(obus: bytes, what: str, w: int, h: int, planes: bool = True):
    """The AV1 stream's info row and planes (uint8 at 8 bits, uint16 above;
    None where the frame is not w x h: the item's ispe, or where ``planes``
    is false)."""
    info = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    # room for two bytes a sample; the decoder writes one at 8 bits
    bufs = [np.empty(2 * w * h, np.uint8) for _ in range(3)] if planes else [None] * 3
    ptr = lambda a: None if a is None else a.ctypes.data  # noqa: E731
    if _lib().citlab_av1_decode(obus, len(obus), info.ctypes.data, *(ptr(b) for b in bufs),
                                w, h, err, _ERRLEN):
        raise Refused(f"{what}: {err.value.decode(errors='replace')}")
    fw, fh, mono, ssx, ssy, depth = (int(x) for x in info[:6])
    if (fw, fh) != (w, h) or not planes:
        return info, None, None, None
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    dtype = np.uint16 if depth > 8 else np.uint8
    y, u, v = (b.view(dtype) for b in bufs)
    y = y[:w * h].reshape(h, w)
    if mono:
        return info, y, None, None
    return info, y, u[:cw * ch].reshape(ch, cw), v[:cw * ch].reshape(ch, cw)


def decode_planes(data: bytes, info: Optional[AvifInfo] = None):
    """The primary item's AV1 planes and the decoder's info row (see
    ``citlab_av1_decode``); the alpha item, if any, is decoded and dropped.
    An item that cannot be read fails as PIL's load fails (after its open)."""
    info = info or open_avif(data)
    try:
        obus = _item_data(info.meta, info.color, data)
        alpha = None if info.alpha is None else _item_data(info.meta, info.alpha, data)
    except SyntaxError as e:
        raise Refused(str(e)) from None
    out = _decode_av1(obus, "AVIF colour item", info.width, info.height)
    if alpha is not None:
        a = info.alpha.prop(b"ispe")
        _decode_av1(alpha, "AVIF alpha item", a[0], a[1], planes=False)
    return out


# ------------------------------------------------------------------ colour

# libyuv's constants: (YG, YB, UB, UG, VG, VR) of kYuv<name>Constants (UB
# capped at 128 in the limited-range ones, as libyuv builds them by default)
_LIBYUV = {
    "JPEG": (16320, 32, 113, 22, 46, 90),      # BT.601 full range
    "I601": (18997, -1160, 128, 25, 52, 102),  # BT.601 limited range
    "F709": (16320, 32, 119, 12, 30, 101),     # BT.709 full range
    "H709": (18997, -1160, 128, 14, 34, 115),  # BT.709 limited range
    "V2020": (16320, 32, 120, 11, 37, 94),     # BT.2020 full range
    "2020": (19003, -1160, 128, 12, 42, 107),  # BT.2020 limited range
}
# (Kr, Kb) of the matrices libavif converts in floating point with its
# matrixCoefficientsTables: FCC, SMPTE 240M, and 15, which is not in the
# table and takes libavif's default, BT.601's
_KR_KB = {4: (0.30, 0.11), 7: (0.212, 0.087), 15: (0.299, 0.114)}


def _libyuv_constants(matrix: int, primaries: int, full: bool) -> Optional[tuple]:
    """getLibYUVConstants: the matrix's libyuv constants; matrix 12 takes
    those of its colour primaries where libyuv has them."""
    if matrix == 12:
        matrix = {1: 1, 2: 1, 5: 5, 6: 6, 9: 9}.get(primaries, -1)
    if matrix in (5, 6, 2):
        return _LIBYUV["JPEG" if full else "I601"]
    if matrix == 1:
        return _LIBYUV["F709" if full else "H709"]
    if matrix == 9:
        return _LIBYUV["V2020" if full else "2020"]
    return None


def conversion(depth: int, mono: bool, ssx: int, ssy: int, matrix: int, primaries: int,
               full: bool, alpha: bool = False) -> tuple:
    """The route avifImageYUVToRGB takes to PIL's 8-bit RGB (RGBA where the
    file has alpha): ("libyuv", mode, constants) (the modes of
    ``citlab_yuv_to_rgb``) or ("float", kind, Kr, Kb) (libavif's own,
    ``citlab_yuv_to_rgb_float``); refused as PIL refuses it. Read off
    libavif 1.3.0 through ctypes (tests/test_torch_formats_avif.py holds
    every route to it on random planes)."""
    # avifPrepareReformatState: what libavif cannot convert at all (YCgCo-Re
    # needs full-range 10-bit samples for 8-bit RGB; YCgCo-Ro 9-bit ones)
    if (matrix in (3, 10, 11, 13, 14) or matrix >= 17 or (matrix == 8 and not full)
            or (matrix == 16 and (depth != 10 or not full))):
        raise Refused(f"AVIF matrix coefficients {matrix} in {'full' if full else 'limited'} "
                      "range (libavif: reformat failed)")
    if matrix == 0 and not mono and (ssx or ssy):
        raise Refused("AVIF identity matrix with subsampled chroma (libavif: reformat failed)")
    # monochrome to RGBA: libyuv's I400 with the matrix's constants (BT.601's
    # for the identity)
    const = _libyuv_constants(6 if mono and matrix == 0 else matrix, primaries, full)
    if const is not None and (not mono or alpha):
        if not alpha or depth == 8 or mono:
            return ("libyuv", 0, const)       # samples shifted to 8 bits, 3-byte RGB
        if depth == 12 and ssy:
            return ("libyuv", 2, const)       # I012ToARGBMatrix: chroma repeated
        return ("libyuv", 1 if depth == 10 else 0, const)
    if mono:
        return ("float", 0, 0.0, 0.0)
    if matrix in (0, 8, 16):
        return ("float", {0: 1, 8: 2, 16: 3}[matrix], 0.0, 0.0)
    if matrix == 12:
        kr_kb = np.zeros(2, np.float32)
        _lib().citlab_avif_derived_kr_kb(primaries, kr_kb.ctypes.data)
        return ("float", 0, float(kr_kb[0]), float(kr_kb[1]))
    return ("float", 0) + _KR_KB[matrix]


def yuv_to_rgb(y: np.ndarray, u: Optional[np.ndarray], v: Optional[np.ndarray], ssx: int,
               ssy: int, matrix: int, full: bool, depth: int = 8, primaries: int = 2,
               alpha: bool = False) -> np.ndarray:
    """avifImageYUVToRGB of the planes (uint8 at depth 8, uint16 above) to
    8-bit RGB, as PIL's decoder calls it (AVIF_CHROMA_UPSAMPLING_AUTOMATIC;
    RGBA where the file has alpha, whose route may differ)."""
    h, w = y.shape
    if u is not None:
        # a chroma plane as tall or as wide as luma (a frame 1 pixel high or
        # wide) is not subsampled in that direction, to libavif's routes too
        ssy, ssx = int(u.shape[0] != h) and ssy, int(u.shape[1] != w) and ssx
    route = conversion(depth, u is None, ssx, ssy, matrix, primaries, full, alpha)
    out = np.empty((h, w, 3), np.uint8)
    planes = [None if p is None else np.ascontiguousarray(p).ctypes.data for p in (y, u, v)]
    if route[0] == "libyuv":
        coef = np.asarray(route[2], np.int32)
        _lib().citlab_yuv_to_rgb(*planes, w, h, ssx, ssy, depth, route[1], coef.ctypes.data,
                                 out.ctypes.data)
    else:
        _lib().citlab_yuv_to_rgb_float(*planes, w, h, ssx, ssy, depth, int(full), route[1],
                                       route[2], route[3], out.ctypes.data)
    return out


def _limited_to_full(p: np.ndarray) -> np.ndarray:
    """libavif's built-in conversion of an 8-bit limited-range sample (float)."""
    f = (p.astype(np.float32) - np.float32(16)) / np.float32(219)
    return (np.float32(0.5) + np.clip(f, 0, 1) * np.float32(255)).astype(np.int32)


def decode(data: bytes, info: Optional[AvifInfo] = None) -> np.ndarray:
    """PIL's "RGB" pixels of the file (its alpha, if any, dropped); ``info``
    is the file's :func:`open_avif`, where the caller has it."""
    info = info or open_avif(data)
    row, y, u, v = decode_planes(data, info)
    w, h, mono, ssx, ssy, depth = (int(x) for x in row[:6])
    if y is None:
        raise Refused(f"AVIF frame of {w} x {h} in an item whose ispe says {info.width} x "
                      f"{info.height} (libavif rescales it; {PART3})")
    matrix, primaries, full = cicp(info, row)
    return yuv_to_rgb(y, u, v, ssx, ssy, matrix, full, depth, primaries,
                      info.alpha is not None)


def cicp(info: AvifInfo, row: np.ndarray) -> Tuple[int, int, bool]:
    """(matrix coefficients, colour primaries, full range) as libavif takes
    them: from the ``colr`` ``nclx`` box, else from the AV1 sequence header
    (the decoder's info row)."""
    if info.nclx is not None:
        return info.nclx[3], info.nclx[1], bool(info.nclx[4])
    return int(row[6]), int(row[8]), bool(row[7])
