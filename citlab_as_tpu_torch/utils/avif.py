"""AVIF as PIL 12.1 reads it: ``AvifImagePlugin`` hands the file to libavif
1.3.0, which parses the HEIF container, decodes the primary item's (or the
first track's) AV1 with dav1d 1.5.1 and converts it to RGB with
``avifImageYUVToRGB`` (through libyuv where libyuv has the matrix). Equal
bit for bit to ``Image.open(path).convert(mode)``.

The container is parsed here as libavif parses it under PIL's settings
(libavif's strict flags less ``pixi``-required and ``clap``-valid, which
PIL clears): ``ftyp`` with its brands; ``meta`` with ``hdlr`` ``pict``,
``pitm``, ``iinf`` / ``infe`` v2-v3, ``iloc`` v0-v2 (construction methods
0 and 1, the latter from ``idat``), ``iref`` (``auxl``, ``prem``, ``thmb``,
``cdsc``, ``dimg``) and ``iprp`` / ``ipco`` / ``ipma`` with ``ispe``,
``av1C``, ``pixi``, ``colr`` (``nclx``, ``prof``, ``rICC``), ``auxC``,
``irot``, ``imir``, ``clap``, ``pasp``; ``moov`` with its tracks (``tkhd``,
``mdia`` / ``mdhd`` / ``hdlr`` / ``minf`` / ``stbl`` with ``stsd``'s av01
sample entry and its properties, ``stsc``, ``stco`` / ``co64``, ``stsz``,
``stss``, ``stts``; ``tref`` ``auxl`` and ``prem``). The source is
libavif's automatic one: the tracks of an 'avis' file, whose first sample
is decoded (the first colour track, with its alpha track), else the
primary item: one AV1 item, or a ``grid`` of them (libavif's checks of the
grid; the tiles' frames stitched on the canvas before one conversion,
since libyuv's chroma upsampling reads across the seams). The AV1 goes to
the port's decoder (``csrc/av1_decode.cpp``, built with the host C++
compiler at first use), film grain included. A frame of another size than
its item's ``ispe`` (or its track's ``tkhd``) is rescaled as libavif's
``avifImageScaleWithLimit`` does with libyuv's box filter. ``irot`` /
``imir`` and ``clap`` change PIL's EXIF orientation and info only, never
the pixels. An alpha image is decoded (limited range brought to full as
libavif does) and dropped, as PIL's ``convert`` drops alpha, after it has
divided a premultiplied colour (``prem``) as libavif does for PIL's RGBA.

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
:class:`raster_formats.Refused`.
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
_INFO_LEN = 28


@functools.cache
def _lib() -> ctypes.CDLL:
    from citlab_as_tpu_torch.ops.kernels import build
    lib = build.load("av1_decode")
    lib.citlab_av1_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
                                      ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
    lib.citlab_av1_decode.restype = ctypes.c_int32
    lib.citlab_yuv_to_rgb.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.citlab_yuv_to_rgb.restype = None
    lib.citlab_yuv_to_rgb_float.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    lib.citlab_yuv_to_rgb_float.restype = None
    lib.citlab_avif_derived_kr_kb.argtypes = [ctypes.c_int32, ctypes.c_void_p]
    lib.citlab_avif_derived_kr_kb.restype = None
    lib.citlab_avif_scale_plane.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                                            ctypes.c_void_p] + [ctypes.c_int32] * 3
    lib.citlab_avif_scale_plane.restype = None
    lib.citlab_av1_apply_grain.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 7 + [
        ctypes.c_void_p]
    lib.citlab_av1_apply_grain.restype = None
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
    dimg_for: int = 0
    dimg_index: int = 0

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
    if kind in (b"auxC", b"auxi"):
        v, _ = s.version_flags()
        if v != 0:
            raise SyntaxError(f"AVIF {kind.decode()} version {v}")
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
        return {"profile": b1 >> 5, "level": b1 & 31, "tier": b2 >> 7,
                "high_bitdepth": (b2 >> 6) & 1, "twelve_bit": (b2 >> 5) & 1,
                "mono": (b2 >> 4) & 1, "ssx": (b2 >> 3) & 1, "ssy": (b2 >> 2) & 1,
                "position": b2 & 3}
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
        if n < 1 or n > 8:
            raise SyntaxError(f"AVIF pixi: {n} planes")
        depths = []
        for _ in range(n):
            depths.append(s.u8())
            if depths[-1] != depths[0]:
                # libavif refuses planes of different depths as it reads them
                raise Refused(f"AVIF pixi depths {depths} differ (libavif: not implemented)")
        return depths
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


def _parse_ipco(meta: _Meta, s: _Stream, kinds=_SUPPORTED_PROPS) -> None:
    while s.left() > 0:
        kind, start, end = s.box_header()
        sub = _Stream(s.data, start, end)
        value = _parse_property(kind, sub) if kind in kinds else None
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
            field = s.u16()
            if field >> 4:
                raise SyntaxError("AVIF iloc: non-zero reserved bits before construction_method")
            method = field & 15
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
    # libavif reads each reference box's fields on from its header, without
    # holding them to the box's size (which must only fit in iref)
    r = s
    while s.left() > 0:
        kind, _, _ = s.box_header()
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
            elif kind == b"dimg":
                # derived images refer the other way: each tile to its grid
                tile = meta.item(to_id)
                tile.dimg_for, tile.dimg_index = from_id, i


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


# ------------------------------------------------------------------ tracks

@dataclass
class _Track:
    """libavif's avifTrack: what its avifParseTrackBox keeps."""
    id: int = 0
    width: int = 0
    height: int = 0
    timescale: int = 0
    aux_for: int = 0
    prem_by: int = 0
    has_stbl: bool = False
    chunks: List[int] = field(default_factory=list)
    stsc: List[Tuple[int, int]] = field(default_factory=list)  # (first chunk, samples)
    all_size: int = 0
    sizes: List[int] = field(default_factory=list)
    # sample entries: (format, properties or None where the format is not av01)
    entries: List[Tuple[bytes, Optional[List[Tuple[bytes, object]]]]] = field(
        default_factory=list)
    meta: Optional[_Meta] = None

    def av1_properties(self) -> Optional[List[Tuple[bytes, object]]]:
        """avifSampleTableGetProperties: the first av01 sample entry's."""
        for fmt, props in self.entries:
            if fmt == b"av01":
                return props
        return None

    def prop(self, kind: bytes):
        for k, v in self.av1_properties() or ():
            if k == kind:
                return v
        return None


_VISUAL_SAMPLE_ENTRY = 78


def _boxes(s: _Stream):
    """(type, payload stream) of each box in s, libavif's child loop."""
    while s.left() > 0:
        kind, start, end = s.box_header()
        yield kind, _Stream(s.data, start, end)
        s.pos = end


def _version0(s: _Stream, what: str) -> None:
    if s.version_flags()[0] != 0:
        raise SyntaxError(f"AVIF {what}: version is not 0")


def _parse_stbl(track: _Track, s: _Stream) -> None:
    if track.has_stbl:
        raise SyntaxError("AVIF trak: two stbl boxes")
    track.has_stbl = True
    for kind, b in _boxes(s):
        if kind in (b"stco", b"co64"):
            _version0(b, kind.decode())
            for _ in range(b.u32()):
                track.chunks.append(b.u64() if kind == b"co64" else b.u32())
        elif kind == b"stsc":
            _version0(b, "stsc")
            prev = 0
            for i in range(b.u32()):
                first, per_chunk = b.u32(), b.u32()
                b.u32()  # sample_description_index
                if (i == 0 and first != 1) or (i and first <= prev):
                    raise SyntaxError("AVIF stsc: chunks not increasing from 1")
                prev = first
                track.stsc.append((first, per_chunk))
        elif kind == b"stsz":
            _version0(b, "stsz")
            size, count = b.u32(), b.u32()
            if size:
                track.all_size = size
            else:
                track.sizes += [b.u32() for _ in range(count)]
        elif kind in (b"stss", b"stts"):
            _version0(b, kind.decode())
            b.take((4 if kind == b"stss" else 8) * b.u32())
        elif kind == b"stsd":
            _version0(b, "stsd")
            for _ in range(b.u32()):
                fmt, start, end = b.box_header()
                props = None
                if fmt == b"av01":
                    if end - start < _VISUAL_SAMPLE_ENTRY:
                        raise SyntaxError("AVIF stsd: av01 sample entry shorter than a "
                                          "VisualSampleEntry")
                    holder = _Meta()
                    _parse_ipco(holder, _Stream(b.data, start + _VISUAL_SAMPLE_ENTRY, end),
                                _SUPPORTED_PROPS + (b"auxi",))
                    props = [(k, v) for k, v in holder.properties
                             if k in _SUPPORTED_PROPS + (b"auxi",)]
                track.entries.append((fmt, props))
                b.pos = end


def _parse_edts(s: _Stream) -> None:
    """avifParseEditBox: one elst, whose repeating form has one entry of a
    non-zero segment duration."""
    elst = False
    for kind, b in _boxes(s):
        if kind != b"elst":
            continue
        if elst:
            raise SyntaxError("AVIF edts: two elst boxes")
        elst = True
        version, flags = b.version_flags()
        if not flags & 1:
            continue
        if b.u32() != 1:
            raise SyntaxError("AVIF elst: entry_count is not 1")
        if version not in (0, 1):
            raise SyntaxError(f"AVIF elst version {version}")
        if (b.u64() if version else b.u32()) == 0:
            raise SyntaxError("AVIF elst: segment_duration 0")
    if not elst:
        raise SyntaxError("AVIF edts without elst")


def _parse_trak(s: _Stream) -> _Track:
    """libavif's avifParseTrackBox with its tkhd, mdia (mdhd, minf / stbl),
    tref (auxl, prem) and edts (elst) boxes; the rest are not read."""
    track = _Track()
    tkhd = edts = False
    for kind, b in _boxes(s):
        if kind == b"tkhd":
            if tkhd:
                raise SyntaxError("AVIF trak: two tkhd boxes")
            tkhd = True
            version, _ = b.version_flags()
            if version not in (0, 1):
                raise SyntaxError(f"AVIF tkhd version {version}")
            b.take(16 if version else 8)
            track_id = b.u32()
            b.take(12 if version else 8)
            b.take(52)
            track.width, track.height = b.u32() >> 16, b.u32() >> 16
            if not track.width or not track.height:
                raise SyntaxError(f"AVIF track {track_id}: size {track.width} x {track.height}")
            _check_size_limits(track.width, track.height, SyntaxError)
            track.id = track_id
        elif kind == b"meta":
            track.meta = _parse_meta(b)
        elif kind == b"mdia":
            for k2, m in _boxes(b):
                if k2 == b"mdhd":
                    version, _ = m.version_flags()
                    if version not in (0, 1):
                        raise SyntaxError(f"AVIF mdhd version {version}")
                    m.take(16 if version else 8)
                    track.timescale = m.u32()
                    m.take(8 if version else 4)
                elif k2 == b"hdlr":
                    # read as the meta box's is, its handler type not held
                    _version0(m, "hdlr")
                    if m.u32() != 0:
                        raise SyntaxError("AVIF hdlr: non-zero pre_defined")
                    m.take(16)
                    m.string()
                elif k2 == b"minf":
                    for k3, n in _boxes(m):
                        if k3 == b"stbl":
                            _parse_stbl(track, n)
        elif kind == b"edts":
            if edts:
                raise SyntaxError("AVIF trak: two edts boxes")
            edts = True
            _parse_edts(b)
        elif kind == b"tref":
            for k2, r in _boxes(b):
                if k2 in (b"auxl", b"prem"):
                    if r.left() < 4:
                        raise SyntaxError(f"AVIF tref: {k2.decode()} without a track ID")
                    if k2 == b"auxl":
                        track.aux_for = r.u32()
                    else:
                        track.prem_by = r.u32()
    if not tkhd:
        raise SyntaxError("AVIF trak without its tkhd box")
    return track


def _parse_moov(s: _Stream) -> List[_Track]:
    tracks = [_parse_trak(b) for kind, b in _boxes(s) if kind == b"trak"]
    if not tracks:
        raise SyntaxError("AVIF moov without a track")
    return tracks


def _check_size_limits(w: int, h: int, error=SyntaxError) -> None:
    """libavif's default image size and dimension limits
    (avifDimensionsTooLarge)."""
    if w * h > 16384 * 16384 or max(w, h) > 32768:
        raise error(f"AVIF: {w} x {h} past libavif's image size limit")


def _brands(payload: bytes) -> Tuple[bytes, List[bytes]]:
    if len(payload) < 8 or (len(payload) - 8) % 4:
        raise SyntaxError("AVIF ftyp of a malformed size")
    return payload[:4], [payload[i:i + 4] for i in range(8, len(payload), 4)]


def _parse_file(data: bytes) -> Tuple[_Meta, bytes, List[_Track]]:
    """libavif's avifParse: the top-level boxes up to the ones it needs."""
    s = _Stream(data)
    ftyp_seen = meta_seen = moov_seen = False
    needs_meta = needs_moov = False
    meta = None
    tracks: List[_Track] = []
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
            if moov_seen:
                raise SyntaxError("AVIF: two moov boxes")
            tracks = _parse_moov(_Stream(data, start, end))
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
    return meta, major, tracks


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
class _Source:
    """One image libavif decodes (the colour or the alpha): a single AV1
    item, the tiles of a ``grid`` item, or a track's first sample. ``width``
    and ``height``: its ispe (a grid item's own) or its track's tkhd size;
    ``tiles``: (OBU bytes or an item to read them from, the size libavif
    scales that frame to)."""
    width: int
    height: int
    tiles: List[Tuple[object, int, int]]
    grid: Optional[Tuple[int, int, int, int]] = None  # rows, columns, output w, h


@dataclass
class AvifInfo:
    width: int
    height: int
    mode: str
    color: Optional[_Item]          # the primary item (None for a track)
    alpha: Optional[_Item]
    nclx: Optional[tuple]
    meta: Optional[_Meta]
    color_src: Optional[_Source] = None
    alpha_src: Optional[_Source] = None
    premultiplied: bool = False
    timescale: int = 1   # a track's mdhd timescale; PIL divides by it


def _parse_grid(payload: bytes) -> Tuple[int, int, int, int]:
    """avifParseImageGridBox: (rows, columns, output width, output height)."""
    s = _Stream(payload)
    try:
        if s.u8() != 0:
            raise Refused("AVIF grid: version is not 0 (libavif: invalid image grid)")
        flags, rows, cols = s.u8(), s.u8() + 1, s.u8() + 1
        w, h = (s.u32(), s.u32()) if flags & 1 else (s.u16(), s.u16())
    except SyntaxError:
        raise Refused("AVIF grid: truncated payload (libavif: invalid image grid)") from None
    if not w or not h or s.left():
        raise Refused(f"AVIF grid: output {w} x {h} with {s.left()} bytes left (libavif: "
                      "invalid image grid)")
    _check_size_limits(w, h, Refused)
    return rows, cols, w, h


def _grid_source(meta: _Meta, grid_item: _Item, data: bytes) -> _Source:
    """avifDecoderItemReadAndParse and avifDecoderGenerateImageGridTiles:
    the grid's tiles in their dimg order, with libavif's checks; the first
    tile's av1C (and pixi) stand for the grid's."""
    try:
        payload = _item_data(meta, grid_item, data)
    except SyntaxError as e:
        raise Refused(str(e)) from None
    rows, cols, w, h = _parse_grid(payload)
    tiles = [meta.items[i] for i in meta.order if meta.items[i].dimg_for == grid_item.id]
    if len(tiles) != rows * cols:
        raise Refused(f"AVIF grid of {rows} x {cols} with {len(tiles)} tiles (libavif: invalid "
                      "image grid)")
    by_index = {}
    for t in tiles:
        if t.dimg_index >= rows * cols or t.dimg_index in by_index:
            raise Refused("AVIF grid: dimg references out of order (libavif: invalid image grid)")
        by_index[t.dimg_index] = t
    ordered = [by_index[i] for i in range(rows * cols)]
    grid_item.props.append((b"av1C", _check_tiles(ordered)))
    return _Source(grid_item.prop(b"ispe")[0], grid_item.prop(b"ispe")[1],
                   [(t, *t.prop(b"ispe")) for t in ordered], (rows, cols, w, h))


def _check_tiles(ordered: List[_Item]) -> dict:
    """avifDecoderGenerateImageGridTiles' and
    avifDecoderItemValidateProperties' checks of a grid's tiles; the first
    tile's av1C, which stands for the grid's."""
    first = None
    for t in ordered:
        if t.type != b"av01":
            raise Refused(f"AVIF grid tile {t.id} of type {t.type!r} (libavif: invalid image grid)")
        if t.unsupported_essential:
            raise Refused("AVIF grid tile with an unsupported essential property (libavif: "
                          "invalid image grid)")
        if first is None:
            first = t
            if t.prop(b"av1C") is None:
                raise Refused("AVIF grid: its first tile without av1C (libavif: invalid image "
                              "grid)")
    config = first.prop(b"av1C")
    keys = ("profile", "level", "tier", "high_bitdepth", "twelve_bit", "mono", "ssx", "ssy",
            "position")
    for t in ordered:
        c = t.prop(b"av1C")
        if c is None:
            raise SyntaxError(f"AVIF grid tile {t.id} without its mandatory av1C property")
        if any(c[k] != config[k] for k in keys):
            raise SyntaxError("AVIF grid: tiles of different av1C fields")
        if t.prop(b"ispe") is None:
            raise SyntaxError(f"AVIF grid tile {t.id} without its mandatory ispe property")
    return config


def _item_source(meta: _Meta, item: _Item, data: bytes, w: int, h: int) -> _Source:
    if item.type == b"grid":
        src = _grid_source(meta, item, data)
        src.width, src.height = w, h
        return src
    return _Source(w, h, [(item, w, h)])


def _samples(track: _Track, data: bytes) -> Tuple[int, int]:
    """avifCodecDecodeInputFillFromSampleTable: (offset, size) of the
    track's first sample, after libavif's checks of the whole table."""
    first = None
    size_index = 0
    count = 0
    for k, offset in enumerate(track.chunks):
        n = 0
        for first_chunk, per_chunk in reversed(track.stsc):
            if first_chunk <= k + 1:
                n = per_chunk
                break
        if n == 0:
            raise SyntaxError("AVIF sample table: a chunk with 0 samples")
        count += n
        if count > 12 * 3600 * 60:
            raise SyntaxError("AVIF sample table past libavif's image count limit")
        for _ in range(n):
            size = track.all_size
            if not size:
                if size_index >= len(track.sizes):
                    raise SyntaxError("AVIF sample table: truncated")
                size = track.sizes[size_index]
            if offset + size > len(data):
                raise SyntaxError("AVIF sample past the end of the file")
            if first is None:
                first = (offset, size)
            offset += size
            size_index += 1
    return first


def _track_source(track: _Track, data: bytes) -> _Source:
    offset, size = _samples(track, data)
    if not size:
        raise SyntaxError("AVIF track sample of 0 bytes")
    return _Source(track.width, track.height, [(data[offset:offset + size], track.width,
                                                track.height)])


def _usable(track: _Track) -> bool:
    return bool(track.has_stbl and track.id and track.chunks
                and track.av1_properties() is not None)


def _open_tracks(tracks: List[_Track], data: bytes) -> AvifInfo:
    """avifDecoderReset from tracks: the first AV1 track that is no
    auxiliary one (libavif 1.3 does not hold its handler to 'pict'), and
    its alpha track: one auxiliary to it whose sample entry's auxi, if any,
    names alpha."""
    color = next((t for t in tracks if _usable(t) and not t.aux_for), None)
    if color is None:
        raise SyntaxError("AVIF: no AV1 colour track (libavif: no content)")
    if color.meta is not None:
        _read_metadata(color.meta, None, data)
    alpha = next((t for t in tracks if _usable(t) and t.aux_for == color.id
                  and t.prop(b"auxi") in (None,) + _ALPHA_URNS), None)
    color_src = _track_source(color, data)
    alpha_src = None if alpha is None else _track_source(alpha, data)
    av1c = color.prop(b"av1C")
    if av1c is None:
        raise SyntaxError("AVIF track without its mandatory av1C property")
    _check_pixi(color.prop(b"pixi"), av1c, color.id)
    nclx = _nclx(color.av1_properties())
    return AvifInfo(color.width, color.height, "RGBA" if alpha is not None else "RGB", None,
                    None, nclx, None, color_src, alpha_src,
                    alpha is not None and color.prem_by == alpha.id, color.timescale)


def _nclx(props) -> Optional[tuple]:
    nclx = icc = None
    for kind, value in props:
        if kind == b"colr" and value[0] == "nclx":
            if nclx is not None:
                raise SyntaxError("AVIF: two nclx colr properties")
            nclx = value
        elif kind == b"colr" and value[0] == "icc":
            if icc is not None:
                raise SyntaxError("AVIF: two ICC colr properties")
            icc = value
    return nclx


def open_avif(data: bytes) -> AvifInfo:
    """Parse the container as libavif's avifDecoderParse does under PIL's
    settings; PIL's mode and size. The source is libavif's automatic one:
    the tracks of a file whose major brand is 'avis', the primary item of
    one whose major brand is 'avif', else the tracks where there are any."""
    meta, major, tracks = _parse_file(data)
    # avifDecoderParse's sanity check, whatever the source: every item it
    # would decode has an ispe (an alpha item's is checked below, with its
    # own message) of a size within libavif's limits
    for item_id in meta.order if meta is not None else ():
        item = meta.items[item_id]
        if _skipped(item):
            continue
        ispe = item.prop(b"ispe")
        aux = item.prop(b"auxC")
        if ispe is None and not (aux is not None and aux in _ALPHA_URNS):
            raise SyntaxError(f"AVIF item {item.id} without its mandatory ispe property")
        if ispe is not None:
            if 0 in ispe:
                raise SyntaxError(f"AVIF item {item.id}: ispe of zero size")
            _check_size_limits(*ispe)
    if major == b"avis" or (major != b"avif" and tracks):
        return _open_tracks(tracks, data)
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
    ispe = color.prop(b"ispe")
    if ispe is None:
        raise SyntaxError(f"AVIF item {color.id} without its mandatory ispe property")
    color_src = _item_source(meta, color, data, *ispe)
    av1c = color.prop(b"av1C")
    if av1c is None:
        raise SyntaxError(f"AVIF item {color.id} without its mandatory av1C property")
    _check_pixi(color.prop(b"pixi"), av1c, color.id)
    nclx = _nclx(color.props)
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
    alpha_src = None
    if alpha is None and color.type == b"grid":
        alpha_src = _tile_alpha_grid(meta, color, color_src)
    if alpha is not None:
        a_ispe = alpha.prop(b"ispe")
        if a_ispe is None:
            raise SyntaxError(f"AVIF alpha item {alpha.id} without its mandatory ispe property")
        alpha_src = _item_source(meta, alpha, data, *a_ispe)
        a1c = alpha.prop(b"av1C")
        if a1c is None:
            raise SyntaxError(f"AVIF alpha item {alpha.id} without its mandatory av1C property")
        _check_pixi(alpha.prop(b"pixi"), a1c, alpha.id)
    w, h = ispe
    return AvifInfo(w, h, "RGBA" if alpha_src is not None else "RGB", color, alpha, nclx, meta,
                    color_src, alpha_src, alpha is not None and color.prem_by == alpha.id)


def _tile_alpha_grid(meta: _Meta, grid: _Item, color_src: _Source) -> Optional[_Source]:
    """libavif's avifMetaFindAlphaItem for a grid without an alpha item:
    where every colour tile (in item order) has exactly one alpha auxiliary
    item, those items make an alpha grid of the colour grid's layout."""
    tiles = []
    for item_id in meta.order:
        tile = meta.items[item_id]
        if tile.dimg_for != grid.id:
            continue
        found = [a for a in (meta.items[i] for i in meta.order)
                 if a.aux_for == tile.id and a.prop(b"auxC") in _ALPHA_URNS]
        if not found:
            return None
        if len(found) > 1 or found[0].dimg_for:
            raise Refused("AVIF grid tile with several alpha items (libavif: invalid image grid)")
        tiles.append(found[0])
    if not tiles:
        return None
    _check_tiles(tiles)
    return _Source(color_src.width, color_src.height, [(a, *a.prop(b"ispe")) for a in tiles],
                   color_src.grid)


_TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                  b"II\x2b\x00")


def _read_metadata(meta: _Meta, color: Optional[_Item], data: bytes) -> None:
    """libavif's avifDecoderFindMetadata, which reads the Exif and XMP
    items that describe the colour item (any, in a track's meta box) while
    parsing; then PIL's reading of the Exif's TIFF header."""
    for item_id in meta.order:
        item = meta.items[item_id]
        if (not item.size or item.unsupported_essential
                or (color is not None and item.desc_for != color.id)):
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


def _check_pixi(pixi: Optional[list], av1c: dict, item_id: int) -> None:
    """avifDecoderItemValidateProperties: an item's own pixi depths are its
    av1C's."""
    if pixi is None:
        return
    bits = 12 if av1c["twelve_bit"] else (10 if av1c["high_bitdepth"] else 8)
    if any(d != bits for d in pixi):
        raise SyntaxError(f"AVIF item {item_id}: pixi depths {pixi} against av1C's {bits} bits")


def _frame(obus: bytes, what: str, w: int, h: int, carry: bytes = b""):
    """The AV1 stream's info row and planes (uint8 at 8 bits, uint16 above)
    at the frame's own size; ``w`` x ``h`` is the size expected (its item's
    ispe), tried first; ``carry``: the sequence header payload the decoder
    instance holds from the item before."""
    info = np.zeros(_INFO_LEN, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    for attempt in range(2):
        # room for two bytes a sample; the decoder writes one at 8 bits
        bufs = [np.empty(2 * w * h, np.uint8) for _ in range(3)]
        if _lib().citlab_av1_decode(obus, len(obus), info.ctypes.data,
                                    *(b.ctypes.data for b in bufs), w, h, err, _ERRLEN,
                                    carry, len(carry)):
            raise Refused(f"{what}: {err.value.decode(errors='replace')}")
        fw, fh, mono, ssx, ssy, depth = (int(x) for x in info[:6])
        if (fw, fh) == (w, h):
            break
        if attempt or fw > 16384 or fh > 16384:
            # avifImageScaleWithLimit's guard against libyuv's overflows
            raise Refused(f"{what}: a frame of {fw} x {fh} to scale to {w} x {h} (libavif: "
                          "invalid scale for libyuv)")
        w, h = fw, fh
    cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
    dtype = np.uint16 if depth > 8 else np.uint8
    y, u, v = (b.view(dtype) for b in bufs)
    y = y[:w * h].reshape(h, w)
    if mono:
        return info, [y]
    return info, [y, u[:cw * ch].reshape(ch, cw), v[:cw * ch].reshape(ch, cw)]


def scale_plane(plane: np.ndarray, w: int, h: int, depth: int) -> np.ndarray:
    """libyuv's ScalePlane (8 bits) or ScalePlane_12 with kFilterBox, as
    libavif's avifImageScaleWithLimit calls it: ``plane`` to w x h."""
    src = np.ascontiguousarray(plane)
    out = np.empty((h, w), src.dtype)
    _lib().citlab_avif_scale_plane(src.ctypes.data, src.shape[1], src.shape[0], out.ctypes.data,
                                   w, h, depth)
    return out


def _scaled(row: np.ndarray, planes: list, w: int, h: int) -> list:
    """avifImageScaleWithLimit: each plane of the frame to w x h (chroma to
    its subsampled size of w x h)."""
    fw, fh, _, ssx, ssy, depth = (int(x) for x in row[:6])
    if (fw, fh) == (w, h):
        return planes
    out = [scale_plane(planes[0], w, h, depth)]
    for p in planes[1:]:
        out.append(scale_plane(p, (w + ssx) >> ssx, (h + ssy) >> ssy, depth))
    return out


def _obus(src_tile, meta: Optional[_Meta], data: bytes) -> bytes:
    obus = src_tile[0]
    if isinstance(obus, _Item):
        try:
            obus = _item_data(meta, obus, data)
        except SyntaxError as e:
            raise Refused(str(e)) from None
    return obus


def _frames(src: _Source, meta: Optional[_Meta], data: bytes, what: str):
    """[(OBUs, info row, planes)] of each AV1 frame of the image (a grid's
    tiles, or one), at the frame's own size, decoded in turn as by one
    dav1d instance: a tile without a sequence header of its own is read
    under the last one before it."""
    out, carry = [], b""
    for tile in src.tiles:
        obus = _obus(tile, meta, data)
        row, planes = _frame(obus, what, tile[1], tile[2], carry)
        if row[26] >= 0:
            carry = obus[row[26]:row[26] + row[27]]
        out.append((obus, row, planes))
    return out


def colour_frames(data: bytes, info: Optional[AvifInfo] = None):
    """:func:`_frames` of the colour image, before libavif scales or
    stitches them."""
    info = info or open_avif(data)
    return _frames(info.color_src, info.meta, data, "AVIF colour image")


def _decode_source(src: _Source, meta: Optional[_Meta], data: bytes, what: str, alpha: bool):
    """The info row (the first tile's) and the planes of one image: each
    frame decoded and scaled to its size, a grid's tiles stitched on its
    canvas as libavif's avifDecoderDataFillImageGrid does."""
    frames = []
    for tile, (_, row, planes) in zip(src.tiles, _frames(src, meta, data, what)):
        if alpha and not row[7]:
            # libavif brings limited-range alpha to full range before it
            # scales the frame
            planes = [_limited_to_full_alpha(planes[0], int(row[5]))]
        frames.append((row, _scaled(row, planes, tile[1], tile[2])))
    row, planes = frames[0]
    if src.grid is None:
        return row, planes
    rows, cols, gw, gh = src.grid
    tw, th = src.tiles[0][1], src.tiles[0][2]
    # the tiles must agree (size, depth, layout; range and CICP for colour)
    fields = (slice(2, 6), slice(6, 10)) if not alpha else (slice(5, 6),)
    for r, _ in frames[1:]:
        if any(not np.array_equal(r[f], row[f]) for f in fields):
            raise Refused(f"{what}: grid tiles that differ (libavif: invalid image grid)")
    if any((w, h) != (tw, th) for _, w, h in src.tiles):
        raise Refused(f"{what}: grid tiles of different sizes (libavif: invalid image grid)")
    if tw * cols < gw or th * rows < gh or tw * (cols - 1) >= gw or th * (rows - 1) >= gh:
        raise Refused(f"{what}: {rows} x {cols} tiles of {tw} x {th} for a grid of {gw} x {gh} "
                      "(libavif: invalid image grid)")
    mono, ssx, ssy = (int(x) for x in row[2:5])
    if alpha:
        mono = 1
    if tw < 64 or th < 64:
        raise Refused(f"{what}: grid tiles under 64 x 64 (libavif: invalid image grid)")
    if not mono and ((ssx and (gw % 2 or tw % 2)) or (ssy and (gh % 2 or th % 2))):
        raise Refused(f"{what}: odd grid or tile size under chroma subsampling (libavif: "
                      "invalid image grid)")
    out = [np.empty((gh, gw), planes[0].dtype)]
    if not mono:
        out += [np.empty(((gh + ssy) >> ssy, (gw + ssx) >> ssx), planes[0].dtype)
                for _ in range(2)]
    for k, (_, tile) in enumerate(frames):
        x0, y0 = (k % cols) * tw, (k // cols) * th
        cw, ch = min(tw, gw - x0), min(th, gh - y0)
        for p, (dst, plane) in enumerate(zip(out, tile)):
            sx, sy = (ssx, ssy) if p else (0, 0)
            ph, pw = (ch + sy) >> sy, (cw + sx) >> sx
            dst[y0 >> sy:(y0 >> sy) + ph, x0 >> sx:(x0 >> sx) + pw] = plane[:ph, :pw]
    return row, out


def _limited_to_full_alpha(a: np.ndarray, depth: int) -> np.ndarray:
    """libavif's avifLimitedToFullY of a limited-range alpha plane (C's
    truncating division, then a clamp)."""
    lo, hi = {8: (16, 235), 10: (64, 940), 12: (256, 3760)}[depth]
    full = (1 << depth) - 1
    num = (a.astype(np.int64) - lo) * full + (hi - lo) // 2
    q = np.abs(num) // (hi - lo) * np.sign(num)
    return np.clip(q, 0, full).astype(a.dtype)


def decode_planes(data: bytes, info: Optional[AvifInfo] = None):
    """The colour image's planes (scaled, and stitched for a grid) and the
    decoder's info row (see ``citlab_av1_decode``): (row, y, u, v); the
    alpha image, if any, is decoded too (so that a damaged one fails as it
    fails in PIL). An image that cannot be read fails as PIL's load fails
    (after its open)."""
    row, planes, _ = _decode_all(data, info or open_avif(data))
    return (row, *planes) if len(planes) == 3 else (row, planes[0], None, None)


def _decode_all(data: bytes, info: AvifInfo):
    row, planes = _decode_source(info.color_src, info.meta, data, "AVIF colour image", False)
    alpha = None
    if info.alpha_src is not None:
        arow, aplanes = _decode_source(info.alpha_src, info.meta, data, "AVIF alpha image",
                                       True)
        alpha = aplanes[0]
        if alpha.shape != planes[0].shape or int(arow[5]) != int(row[5]):
            raise Refused("AVIF alpha image of another size or depth than the colour image "
                          "(libavif: reformat failed)")
    return row, planes, alpha


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
               alpha: bool = False, premultiplied: Optional[np.ndarray] = None) -> np.ndarray:
    """avifImageYUVToRGB of the planes (uint8 at depth 8, uint16 above) to
    8-bit RGB, as PIL's decoder calls it (AVIF_CHROMA_UPSAMPLING_AUTOMATIC;
    RGBA where the file has alpha, whose route may differ). With
    ``premultiplied`` (the alpha plane, at the depth) the colour is divided
    by it as libavif does for PIL's unpremultiplied RGBA: inside its slow
    float path (subsampled chroma, the identity matrix but at 8 bits in full
    range, YCgCo and YCgCo-Re, monochrome under them too), else afterwards
    by avifRGBImageUnpremultiplyAlpha."""
    h, w = y.shape
    if u is not None:
        # a chroma plane as tall or as wide as luma (a frame 1 pixel high or
        # wide) is not subsampled in that direction, to libavif's routes too
        ssy, ssx = int(u.shape[0] != h) and ssy, int(u.shape[1] != w) and ssx
    alpha = alpha or premultiplied is not None
    route = conversion(depth, u is None, ssx, ssy, matrix, primaries, full, alpha)
    out = np.empty((h, w, 3), np.uint8)
    planes = [None if p is None else np.ascontiguousarray(p).ctypes.data for p in (y, u, v)]
    if route[0] == "libyuv":
        coef = np.asarray(route[2], np.int32)
        _lib().citlab_yuv_to_rgb(*planes, w, h, ssx, ssy, depth, route[1], coef.ctypes.data,
                                 out.ctypes.data)
    else:
        slow = (route[1] in (2, 3) or (route[1] == 1 and (depth != 8 or not full))
                or (u is not None and (ssx or ssy)) or (u is None and matrix in (8, 16)))
        inline = premultiplied is not None and slow
        a = np.ascontiguousarray(premultiplied) if inline else None
        _lib().citlab_yuv_to_rgb_float(*planes, w, h, ssx, ssy, depth, int(full), route[1],
                                       route[2], route[3], None if a is None else a.ctypes.data,
                                       out.ctypes.data)
        if inline:
            return out
    if premultiplied is not None:
        out = unpremultiply(out, _alpha8(premultiplied, depth, u is None, ssx, ssy, matrix,
                                         primaries, full))
    return out


def _limited_to_full(p: np.ndarray) -> np.ndarray:
    """libavif's built-in conversion of an 8-bit limited-range sample (float)."""
    f = (p.astype(np.float32) - np.float32(16)) / np.float32(219)
    return (np.float32(0.5) + np.clip(f, 0, 1) * np.float32(255)).astype(np.int32)


def decode(data: bytes, info: Optional[AvifInfo] = None) -> np.ndarray:
    """PIL's "RGB" pixels of the file (its alpha, if any, dropped; a
    premultiplied colour divided by it first, as libavif's
    avifRGBImageUnpremultiplyAlpha does); ``info`` is the file's
    :func:`open_avif`, where the caller has it."""
    info = info or open_avif(data)
    if info.timescale == 0:
        raise Refused("AVIF track of timescale 0 (PIL divides the frame's timestamp by it)")
    row, planes, alpha = _decode_all(data, info)
    h, w = planes[0].shape
    depth, ssx, ssy = int(row[5]), int(row[3]), int(row[4])
    matrix, primaries, full = cicp(info, row)
    u, v = (planes[1], planes[2]) if len(planes) == 3 else (None, None)
    rgb = yuv_to_rgb(planes[0], u, v, ssx, ssy, matrix, full, depth, primaries,
                     alpha is not None, alpha if info.premultiplied else None)
    if (w, h) != (info.width, info.height):
        # a grid whose output is not its ispe: PIL reads the first rows of
        # the RGB(A) buffer at the size it reported
        ch = 4 if alpha is not None else 3
        buf = rgb
        if alpha is not None:
            buf = np.dstack([rgb, _alpha8(alpha, depth, u is None, ssx, ssy, matrix, primaries,
                                          full)])
        flat = buf.reshape(-1)
        need = info.width * info.height * ch
        if flat.size < need:
            raise Refused(f"AVIF grid output {w} x {h} smaller than its ispe {info.width} x "
                          f"{info.height} (PIL: not enough image data)")
        rgb = np.ascontiguousarray(flat[:need].reshape(info.height, info.width, ch)[..., :3])
    return rgb


def _alpha8(alpha: np.ndarray, depth: int, mono: bool, ssx: int, ssy: int, matrix: int,
            primaries: int, full: bool) -> np.ndarray:
    """The 8-bit alpha avifImageYUVToRGB writes to PIL's RGBA: libyuv's
    shift where libyuv converts the colour with its alpha, else libavif's
    float rescale (avifReformatAlpha)."""
    if depth == 8:
        return alpha
    route = conversion(depth, mono, ssx, ssy, matrix, primaries, full, True)
    if route[0] == "libyuv" and route[1] != 2 and not mono:
        return (alpha >> (depth - 8)).astype(np.uint8)
    f = alpha.astype(np.float32) / np.float32((1 << depth) - 1)
    return np.clip((np.float32(0.5) + f * np.float32(255)).astype(np.int32), 0,
                   255).astype(np.uint8)


def _unattenuate_table() -> np.ndarray:
    """libyuv's ARGBUnattenuate as libavif runs it on x86 (value, alpha) ->
    value: the 8.8 reciprocal table fixed_invtbl8, the value widened to 16
    bits (v * 257) and the high half of the product, clamped to 255; the
    SIMD row turns alpha 1 over values of 128 and more into 0."""
    v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    inv = np.where(a == 0, 0, np.where(a == 1, 0xFFFF, np.where(
        a == 255, 0x100, 0x10000 // np.maximum(a, 1))))
    out = np.minimum(255, (v * 257 * inv) >> 16)
    out[128:, 1] = 0
    return out.astype(np.uint8)


_UNATTENUATE = None


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """avifRGBImageUnpremultiplyAlpha of 8-bit RGBA (libyuv's
    ARGBUnattenuate): each colour channel divided by the alpha."""
    global _UNATTENUATE
    if _UNATTENUATE is None:
        _UNATTENUATE = _unattenuate_table()
    return _UNATTENUATE[rgb, alpha[..., None]]


def cicp(info: AvifInfo, row: np.ndarray) -> Tuple[int, int, bool]:
    """(matrix coefficients, colour primaries, full range) as libavif takes
    them: from the ``colr`` ``nclx`` box, else from the AV1 sequence header
    (the decoder's info row)."""
    if info.nclx is not None:
        return info.nclx[3], info.nclx[1], bool(info.nclx[4])
    return int(row[6]), int(row[8]), bool(row[7])
