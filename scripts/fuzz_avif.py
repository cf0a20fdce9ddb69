"""Hold the port's AVIF decoder to PIL beyond the fixtures, on this host.

Fuzz: every small AVIF fixture of ``tests/data/torch_formats_variants/small``
(or those named by ``--only``) cut at 10 points, and damaged at
``--mutations`` seeded random sets of 1-2 bytes in the container (the boxes
before the media data) and as many in the AV1 OBUs (the ``mdat`` payload).
Each file must either decode to PIL's "RGB" bytes or be refused by both,
as dav1d's error returns and its reads past the end of a tile refuse
them. A refusal that names part 2 or part 3 (whose tools all decode) while
PIL decodes the file would be counted apart ("part 2", "part 3"). A file
whose AV1 planes from the port equal those of
dav1d's C code but not of its x86 assembly, which PIL runs, is counted
apart too ("dav1d SIMD"): a damaged stream can drive the assembly's 16-bit
transforms past the ranges a conforming stream keeps to, so PIL's bytes
then depend on the host's SIMD level (dav1d's C code is the
specification's arithmetic). Prints the counts and every disagreement
with its file, seed and case; exits 1 on any disagreement or "part 2" or
"part 3" file.

Encodes (``--encodes N``): N random PIL writes (a drawn page, a photo, noise
or a page over a photo of 1 to 900 pixels a side; speed 0-10, quality 0-100,
every subsampling and range, tile rows and columns, up to five of aom's
intra, CDEF and loop-restoration options, film-grain-test vectors 0-16 or
the denoiser, alpha premultiplied or not; a still image, a two-frame
save_all sequence or a grid of random tiles) decoded by the port and by
PIL: each file decodes to PIL's "RGB" bytes (a refusal that names part 3
would be counted apart); option sets aom refuses to encode are counted as
"not written", and a write PIL cannot read back (aom's denoiser has
written a monochrome stream dav1d refuses), which the port must refuse
too, as "PIL refuses its write".

Timing (``--time``): the full-size pages of ``tests/data/torch_formats_avif``
decoded by PIL (libavif + dav1d, ``Image.open(...).load()``) and by the
port (``utils/avif.decode``), best of 3, in ms on this host's CPU.

Needs PIL; run from the repository root:

    python scripts/fuzz_avif.py [--mutations 20] [--seed 0] [--only NAME ...]
        [--encodes 0] [--time]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import io
import os
import struct
import sys
import time
from typing import List, Optional

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from citlab_as_tpu_torch.utils import avif  # noqa: E402
from citlab_as_tpu_torch.utils.image_native import NativeDecodeError  # noqa: E402

SMALL_DIR = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
PAGES_DIR = os.path.join(REPO, "tests", "data", "torch_formats_avif")
CUTS = 10


def libavif() -> ctypes.CDLL:
    """The libavif PIL ships, with dav1d 1.5.1 linked in (ctypes)."""
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libavif-*.so*"))[0])
    lib.dav1d_data_create.restype = ctypes.c_void_p
    lib.dav1d_data_create.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.dav1d_set_cpu_flags_mask.argtypes = [ctypes.c_uint]
    return lib


def _picture_planes(pic, write=None):
    """The planes of a Dav1dPicture (data[3] at 16, stride[2] at 40, p.w /
    p.h / p.layout / p.bpc at 56): [Y, U, V] (or [Y]); ``write`` (planes of
    the same shapes) is copied into the picture first."""
    ptrs = struct.unpack_from("QQQQQqq", pic, 0)
    w, h, layout, bpc = struct.unpack_from("iiii", pic, 56)
    dtype = np.uint16 if bpc > 8 else np.uint8
    size = np.dtype(dtype).itemsize
    out = []
    for i in range(3 if layout else 1):
        sx = 1 if i and layout in (1, 2) else 0
        sy = 1 if i and layout == 1 else 0
        pw, ph = (w + sx) >> sx, (h + sy) >> sy
        stride = ptrs[5] if i == 0 else ptrs[6]
        buf = (ctypes.c_uint8 * (stride * ph)).from_address(ptrs[2 + i])
        view = np.frombuffer(buf, np.uint8).reshape(ph, stride)
        if write is not None:
            view[:, :pw * size] = np.ascontiguousarray(write[i].astype(dtype)).view(np.uint8)
        out.append(view[:, :pw * size].copy().view(dtype))
    return out


def _dav1d_decode(obus: bytes, simd: bool, grain: bool, use):
    """Decode the stream's first picture with dav1d (one thread) and call
    ``use(lib, ctx, picture)``, or return None where dav1d refuses it.
    Dav1dSettings: n_threads, max_frame_delay, apply_grain at 0, 4, 8."""
    lib = libavif()
    settings = ctypes.create_string_buffer(1024)
    lib.dav1d_default_settings(settings)
    struct.pack_into("iii", settings, 0, 1, 1, int(grain))
    ctx = ctypes.c_void_p()
    # the mask holds while dav1d sets up its functions, at the first frame
    lib.dav1d_set_cpu_flags_mask(0xFFFFFFFF if simd else 0)
    assert lib.dav1d_open(ctypes.byref(ctx), settings) == 0
    try:
        data = ctypes.create_string_buffer(256)
        ctypes.memmove(lib.dav1d_data_create(data, len(obus)), obus, len(obus))
        lib.dav1d_send_data(ctx, data)
        pic = ctypes.create_string_buffer(1024)
        if lib.dav1d_get_picture(ctx, pic) != 0:
            return None
        try:
            return use(lib, ctx, pic)
        finally:
            lib.dav1d_picture_unref(pic)
    finally:
        lib.dav1d_close(ctypes.byref(ctx))
        lib.dav1d_set_cpu_flags_mask(0xFFFFFFFF)


def dav1d_planes(obus: bytes, simd: bool = True, grain: bool = True):
    """dav1d 1.5.1's planes of an AV1 stream: [Y, U, V] (or [Y]), uint8 or
    (above 8 bits) uint16, or None where dav1d refuses it; ``simd`` false
    runs dav1d's C code, ``grain`` false leaves its film grain off."""
    return _dav1d_decode(obus, simd, grain, lambda lib, ctx, pic: _picture_planes(pic))


# Dav1dFilmGrainData, the first member of Dav1dFrameHeader (dav1d 1.5)
GRAIN_FIELDS = (("seed", "I", 0), ("num_y_points", "i", 4), ("y_points", "28B", 8),
                ("chroma_scaling_from_luma", "i", 36), ("num_uv_points", "2i", 40),
                ("uv_points", "40B", 48), ("scaling_shift", "i", 88),
                ("ar_coeff_lag", "i", 92), ("ar_coeffs_y", "24b", 96),
                ("ar_coeffs_uv", "56b", 120), ("ar_coeff_shift", "Q", 176),
                ("grain_scale_shift", "i", 184), ("uv_mult", "2i", 188),
                ("uv_luma_mult", "2i", 196), ("uv_offset", "2i", 204),
                ("overlap_flag", "i", 212), ("clip_to_restricted_range", "i", 216))


def dav1d_grain(obus: bytes) -> Optional[dict]:
    """The film grain parameters dav1d read from the stream's frame header
    (Dav1dFilmGrainData: AR coefficients and multipliers less 128, offsets
    less 256; ar_coeffs_uv rows of 28)."""
    def read(lib, ctx, pic):
        raw = ctypes.string_at(struct.unpack_from("Q", pic, 8)[0], 220)
        out = {}
        for name, fmt, off in GRAIN_FIELDS:
            v = struct.unpack_from("<" + fmt, raw, off)
            out[name] = list(v) if len(v) > 1 else v[0]
        return out
    return _dav1d_decode(obus, True, False, read)


def dav1d_apply_grain(carrier: bytes, planes, params: dict, simd: bool = True,
                      identity: bool = False):
    """dav1d_apply_grain on ``planes``: the carrier stream (no film grain,
    of the planes' size, layout and depth) is decoded without grain, its
    picture's planes replaced by ``planes`` and its frame header's grain
    parameters by ``params`` (dav1d_grain's form; ``identity`` sets the
    sequence header's matrix to the identity, at offset 24), then dav1d
    applies the grain into a new picture, whose planes are returned."""
    def apply(lib, ctx, pic):
        _picture_planes(pic, planes)
        raw = bytearray(ctypes.string_at(struct.unpack_from("Q", pic, 8)[0], 220))
        for name, fmt, off in GRAIN_FIELDS:
            v = params[name]
            struct.pack_into("<" + fmt, raw, off, *(v if isinstance(v, list) else [v]))
        ctypes.memmove(struct.unpack_from("Q", pic, 8)[0], bytes(raw), len(raw))
        if identity:
            ctypes.c_int32.from_address(struct.unpack_from("Q", pic, 0)[0] + 24).value = 0
        out = ctypes.create_string_buffer(1024)
        lib.dav1d_apply_grain.argtypes = [ctypes.c_void_p] * 3
        assert lib.dav1d_apply_grain(ctx, out, pic) == 0
        try:
            return _picture_planes(out)
        finally:
            lib.dav1d_picture_unref(out)
    return _dav1d_decode(carrier, simd, False, apply)


def simd_only(data: bytes) -> bool:
    """Whether the port's planes of the colour frames equal dav1d's C
    code's and not its assembly's (see the module's docstring)."""
    try:
        frames = avif.colour_frames(data)
    except (NativeDecodeError, SyntaxError):
        return False
    same = lambda a, b: b is not None and all(  # noqa: E731
        x.shape == z.shape and (x == z).all() for x, z in zip(a, b))
    return (all(same(planes, dav1d_planes(obus, simd=False)) for obus, _, planes in frames)
            and not all(same(planes, dav1d_planes(obus)) for obus, _, planes in frames))


def pil_rgb(data: bytes) -> Optional[np.ndarray]:
    try:
        with Image.open(io.BytesIO(data)) as im:
            if im.format != "AVIF":
                return None
            return np.asarray(im.convert("RGB"))
    except Exception:  # noqa: BLE001 - any refusal of PIL's
        return None


def port_rgb(data: bytes):
    """The port's pixels, or the refusal's message."""
    try:
        return avif.decode(data)
    except (NativeDecodeError, SyntaxError) as e:
        return str(e) or type(e).__name__


def mdat_span(data: bytes):
    """(start, end) of the first mdat box's payload, or None."""
    pos = 0
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        head = 8
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            head = 16
        if size == 0:
            size = len(data) - pos
        if kind == b"mdat":
            return pos + head, min(len(data), pos + size)
        if size < head:
            return None
        pos += size
    return None


def cases(data: bytes, mutations: int, rng: np.random.RandomState) -> List[bytes]:
    """The file cut at CUTS points, then damaged in its container and in
    its OBUs."""
    out = [data[:n] for n in np.linspace(16, len(data) - 1, CUTS).astype(int)]
    span = mdat_span(data) or (len(data), len(data))
    regions = [(12, span[0]), span]
    for lo, hi in regions:
        if hi - lo < 1:
            continue
        for _ in range(mutations):
            b = bytearray(data)
            for pos in rng.randint(lo, hi, rng.randint(1, 3)):
                b[pos] = rng.randint(0, 256)
            out.append(bytes(b))
    return out


def classify(want, got, data: bytes = b"") -> str:
    if want is None and isinstance(got, str):
        return "both refuse"
    if want is not None and isinstance(got, np.ndarray):
        if got.shape == want.shape and (got == want).all():
            return "equal"
        return "dav1d SIMD" if data and simd_only(data) else "disagree"
    if want is not None and isinstance(got, str) and "part 3" in got:
        return "part 3"
    if want is not None and isinstance(got, str) and "part 2" in got:
        return "part 2"
    return "disagree"


def fuzz(paths: List[str], mutations: int, seed: int, verbose: bool = True) -> dict:
    counts = {"both refuse": 0, "equal": 0, "part 2": 0, "part 3": 0, "dav1d SIMD": 0,
              "disagree": 0}
    disagreements = []
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        rng = np.random.RandomState(seed)
        for i, case in enumerate(cases(data, mutations, rng)):
            kind = classify(pil_rgb(case), port_rgb(case), case)
            counts[kind] += 1
            if kind in ("disagree", "part 2", "part 3"):
                disagreements.append((os.path.basename(path), seed, i))
                if verbose:
                    want, got = pil_rgb(case), port_rgb(case)
                    print(f"DISAGREE {os.path.basename(path)} seed {seed} case {i}: PIL "
                          f"{'refuses' if want is None else want.shape}, port "
                          f"{got[:160] if isinstance(got, str) else got.shape}")
    counts["files"] = sum(v for k, v in counts.items() if k != "files")
    counts["disagreements"] = disagreements
    return counts


AOM_OPTIONS = [
    ("enable-filter-intra", ["0", "1"]), ("enable-smooth-intra", ["0", "1"]),
    ("enable-paeth-intra", ["0", "1"]), ("enable-cfl-intra", ["0", "1"]),
    ("enable-angle-delta", ["0", "1"]), ("enable-intra-edge-filter", ["0", "1"]),
    ("enable-tx64", ["0", "1"]), ("enable-flip-idtx", ["0", "1"]), ("enable-rect-tx", ["0", "1"]),
    ("reduced-tx-type-set", ["0", "1"]), ("enable-qm", ["0", "1"]),
    ("deltaq-mode", ["0", "1", "2", "3"]), ("enable-chroma-deltaq", ["0", "1"]),
    ("sharpness", ["0", "2", "5", "7"]), ("tune-content", ["default", "screen"]),
    ("sb-size", ["dynamic", "64", "128"]), ("cdf-update-mode", ["0", "1", "2"]),
    ("enable-palette", ["0", "1"]), ("enable-intrabc", ["0", "1"]), ("aq-mode", ["0", "1", "2", "3"]),
    ("qm-min", ["0", "4", "8"]), ("qm-max", ["8", "12", "15"]), ("enable-cdef", ["0", "1"]),
    ("enable-restoration", ["0", "1"])]


def encodes(n: int, seed: int, verbose: bool = True) -> dict:
    """n random PIL writes against PIL's own decode (see the module's
    docstring)."""
    import random
    from scripts.avif_variants import (avif_bytes, grid_bytes, mix_rgb, page_rgb, photo_rgb,
                                       sequence_bytes)
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    counts = {"equal": 0, "part 2": 0, "part 3": 0, "dav1d SIMD": 0, "disagree": 0,
              "not written": 0, "PIL refuses its write": 0, "with film grain": 0,
              "premultiplied": 0, "sequences": 0, "grids": 0}
    for k in range(n):
        w = rng.choice([rng.randint(1, 80), rng.randint(60, 400), rng.randint(300, 900)])
        h = rng.choice([rng.randint(1, 80), rng.randint(60, 300), rng.randint(300, 700)])
        kind = rng.choice(["page", "photo", "noise", "mix"])
        if kind == "page":
            arr = np.ascontiguousarray(page_rgb(max(w, 40), max(h, 40), seed=k)[:h, :w])
        elif kind == "photo":
            arr = photo_rgb(w, h, seed=k)
        elif kind == "noise":
            arr = nrng.integers(0, 256, (h, w, 3), np.uint8)
        else:
            arr = mix_rgb(w, h, seed=k)
        save = dict(speed=rng.randint(0, 10), quality=rng.choice([0, 5, 20, 40, 60, 75, 90, 100]),
                    subsampling=rng.choice(["4:0:0", "4:2:0", "4:2:2", "4:4:4"]),
                    range=rng.choice(["full", "limited"]))
        if rng.random() < 0.3:
            save["tile_cols"], save["tile_rows"] = rng.randint(0, 2), rng.randint(0, 2)
        advanced = {key: rng.choice(values)
                    for key, values in rng.sample(AOM_OPTIONS, rng.randint(0, 5))}
        # part 3's tools: film grain (a test vector or the denoiser),
        # premultiplied alpha, a sequence, a grid
        if rng.random() < 0.3:
            advanced["film-grain-test"] = str(rng.randint(0, 16))
        elif rng.random() < 0.15:
            advanced["denoise-noise-level"] = str(rng.choice([5, 15, 25, 50]))
        if advanced:
            save["advanced"] = advanced
        if rng.random() < 0.2:
            arr = np.dstack([arr, nrng.integers(0, 256, arr.shape[:2], np.uint8)])
            save["alpha_premultiplied"] = rng.random() < 0.7
        form = rng.choice(["still"] * 6 + ["sequence", "grid"])
        premultiplied = False
        try:
            if form == "sequence":
                data = sequence_bytes([arr, arr[::-1].copy()], **save)
            elif form == "grid" and w >= 64 and h >= 64:
                tw, th = rng.randint(64, max(64, w)), rng.randint(64, max(64, h))
                if save.get("subsampling", "4:2:0") in ("4:2:0", "4:2:2"):
                    tw, w2 = tw & ~1, w & ~1
                    arr = arr[:, :w2]
                if save.get("subsampling", "4:2:0") == "4:2:0":
                    th = th & ~1
                    arr = arr[:arr.shape[0] & ~1]
                premultiplied = save.pop("alpha_premultiplied", False)
                data = grid_bytes(np.ascontiguousarray(arr), -(-arr.shape[0] // th),
                                  -(-arr.shape[1] // tw), tw, th, premultiplied, **save)
            else:
                data = avif_bytes(arr, **save)
        except ValueError:  # aom refuses some combinations of its options
            counts["not written"] += 1
            continue
        counts["with film grain"] += "film-grain-test" in advanced or "denoise-noise-level" in (
            advanced)
        counts["premultiplied"] += bool(save.get("alpha_premultiplied") or premultiplied)
        counts["sequences"] += form == "sequence"
        counts["grids"] += form == "grid" and w >= 64 and h >= 64
        want, got = pil_rgb(data), port_rgb(data)
        kind_ = classify(want, got, data)
        # PIL (dav1d) refusing PIL's own write is aom's fault: the port must
        # refuse it too
        counts[kind_ if kind_ != "both refuse" else "PIL refuses its write"] += 1
        if kind_ in ("disagree", "both refuse", "part 2", "part 3") and verbose:
            print(f"DISAGREE encode {k} seed {seed}: {w} x {h} {kind} {save}: port "
                  f"{got[:160] if isinstance(got, str) else got.shape}")
    return counts


def timing() -> None:
    for path in sorted(glob.glob(os.path.join(PAGES_DIR, "*.avif"))):
        with open(path, "rb") as f:
            data = f.read()

        def best(fn):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return min(times)
        pil_ms = best(lambda: Image.open(io.BytesIO(data)).load())
        port_ms = best(lambda: avif.decode(data))
        print(f"{os.path.basename(path)}: libavif + dav1d (PIL) {pil_ms:.1f} ms, "
              f"port {port_ms:.1f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mutations", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", nargs="+", default=None,
                        help="fixture names (avif_<name>.avif) to fuzz")
    parser.add_argument("--encodes", type=int, default=0,
                        help="random PIL writes to hold to PIL's decode")
    parser.add_argument("--time", action="store_true")
    args = parser.parse_args()
    paths = sorted(glob.glob(os.path.join(SMALL_DIR, "avif_*.avif")))
    if args.only:
        paths = [p for p in paths if os.path.basename(p)[5:-5] in args.only]
    counts = fuzz(paths, args.mutations, args.seed)
    shown = {k: v for k, v in counts.items() if k != "disagreements"}
    print(f"{len(paths)} fixtures: {shown}")
    rc = 1 if counts["disagree"] or counts["part 2"] or counts["part 3"] else 0
    if args.encodes:
        enc = encodes(args.encodes, args.seed)
        print(f"{args.encodes} random encodes: {enc}")
        rc |= 1 if enc["disagree"] or enc["part 2"] or enc["part 3"] else 0
    if args.time:
        timing()
    return rc


if __name__ == "__main__":
    sys.exit(main())
