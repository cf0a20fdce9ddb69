"""Hold the port's AVIF decoder to PIL beyond the fixtures, on this host.

Fuzz: every small AVIF fixture of ``tests/data/torch_formats_variants/small``
(or those named by ``--only``) cut at 10 points, and damaged at
``--mutations`` seeded random sets of 1-2 bytes in the container (the boxes
before the media data) and as many in the AV1 OBUs (the ``mdat`` payload).
Each file must either decode to PIL's "RGB" bytes or be refused by both,
as dav1d's error returns and its reads past the end of a tile refuse
them. A file the port refuses for a tool of part 3 (film grain, a grid
item, an avis sequence, premultiplied alpha, a frame libavif rescales)
that a damaged header switched on, while PIL decodes it, is counted apart
("part 3"); a refusal that names part 2 (whose tools all decode) would be
counted as "part 2". A file whose AV1 planes from the port equal those of
dav1d's C code but not of its x86 assembly, which PIL runs, is counted
apart too ("dav1d SIMD"): a damaged stream can drive the assembly's 16-bit
transforms past the ranges a conforming stream keeps to, so PIL's bytes
then depend on the host's SIMD level (dav1d's C code is the
specification's arithmetic). Prints the counts and every disagreement
with its file, seed and case; exits 1 on any disagreement or "part 2"
file.

Encodes (``--encodes N``): N random PIL writes (a drawn page, a photo, noise
or a page over a photo of 1 to 900 pixels a side; speed 0-10, quality 0-100,
every subsampling and range, tile rows and columns, up to five of aom's
intra, CDEF and loop-restoration options) decoded by the port and by PIL:
each file decodes to PIL's "RGB" bytes, or is refused for a part-3 tool
(counted apart); option sets aom refuses to encode are counted as "not
written".

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


def dav1d_planes(obus: bytes, simd: bool = True):
    """dav1d 1.5.1's planes of an AV1 stream: [Y, U, V] (or [Y]), uint8 or
    (above 8 bits) uint16, or None where dav1d refuses it; ``simd`` false
    runs dav1d's C code. The structs are read at dav1d 1.5's offsets:
    Dav1dSettings n_threads, max_frame_delay; Dav1dPicture data[3] at 16,
    stride[2] at 40, p.w / p.h / p.layout / p.bpc at 56."""
    lib = libavif()
    settings = ctypes.create_string_buffer(1024)
    lib.dav1d_default_settings(settings)
    struct.pack_into("ii", settings, 0, 1, 1)
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
            out.append(np.frombuffer(buf, np.uint8).reshape(ph, stride)[:, :pw * size].copy()
                       .view(dtype))
        lib.dav1d_picture_unref(pic)
        return out
    finally:
        lib.dav1d_close(ctypes.byref(ctx))
        lib.dav1d_set_cpu_flags_mask(0xFFFFFFFF)


def simd_only(data: bytes) -> bool:
    """Whether the port's planes of the colour item equal dav1d's C code's
    and not its assembly's (see the module's docstring)."""
    try:
        info = avif.open_avif(data)
        _, y, u, v = avif.decode_planes(data, info)
        obus = avif._item_data(info.meta, info.color, data)
    except (NativeDecodeError, SyntaxError):
        return False
    planes = [y] if u is None else [y, u, v]
    same = lambda a, b: b is not None and all(  # noqa: E731
        x.shape == z.shape and (x == z).all() for x, z in zip(a, b))
    return same(planes, dav1d_planes(obus, simd=False)) and not same(planes, dav1d_planes(obus))


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
    if want is not None and isinstance(got, str) and avif.PART3 in got:
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
            if kind in ("disagree", "part 2"):
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
    from scripts.avif_variants import avif_bytes, mix_rgb, page_rgb, photo_rgb
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    counts = {"equal": 0, "part 2": 0, "part 3": 0, "dav1d SIMD": 0, "disagree": 0,
              "not written": 0}
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
        if advanced:
            save["advanced"] = advanced
        try:
            data = avif_bytes(arr, **save)
        except ValueError:  # aom refuses some combinations of its options
            counts["not written"] += 1
            continue
        want, got = pil_rgb(data), port_rgb(data)
        kind_ = classify(want, got, data)
        counts[kind_ if kind_ != "both refuse" else "disagree"] += 1
        if kind_ in ("disagree", "both refuse", "part 2") and verbose:
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
    rc = 1 if counts["disagree"] or counts["part 2"] else 0
    if args.encodes:
        enc = encodes(args.encodes, args.seed)
        print(f"{args.encodes} random encodes: {enc}")
        rc |= 1 if enc["disagree"] or enc["part 2"] else 0
    if args.time:
        timing()
    return rc


if __name__ == "__main__":
    sys.exit(main())
