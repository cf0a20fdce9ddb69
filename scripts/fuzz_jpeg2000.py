"""Hold the port's JPEG 2000 decoder to PIL beyond the fixtures, on this host.

Fuzz: every small JPEG 2000 fixture of
``tests/data/torch_formats_variants/small`` cut at 16 points and damaged at
``--mutations`` seeded random sets of 1-3 bytes, half of them in the
headers (the first ``HEADER_BYTES`` bytes) and half anywhere; each file
must either decode to PIL's "L" image or be refused by both. Prints the
counts and every disagreement; exits 1 on any.

Random encodes (``--encodes N``): N files written by the test encoder of
``scripts/format_variants.py`` with seeded random settings (size, offsets,
components and their precision, sign and subsampling, levels, code-block
size and styles, SOP / EPH, wavelet, layers, progression order, tiles and
tile-parts, precincts, ROI, MCT, PLT / TLM), each held to PIL's "L" and
"RGB" the same way.

Timing (``--time``): the full-size pages of
``tests/data/torch_formats_jpeg2000`` decoded by PIL (OpenJPEG through
``Image.open(...).load()``) and by the port (``utils/jpeg2000.decode``),
best of 5, in ms on this host's CPU.

Needs PIL; run from the repository root:

    python scripts/fuzz_jpeg2000.py [--mutations 40] [--seed 0] [--encodes 0] [--time]
"""
from __future__ import annotations

import argparse
import glob
import io
import os
import sys
import time

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from citlab_as_tpu_torch.utils import jpeg2000  # noqa: E402
from citlab_as_tpu_torch.utils.image_native import NativeDecodeError  # noqa: E402

HEADER_BYTES = 160
CUTS = 16


def pil_image(data, mode="L"):
    """PIL's image of the file in ``mode``, or None where PIL raises."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert(mode))
    except Exception:
        return None


def port_image(data, mode="L"):
    try:
        return jpeg2000.decode(data, mode)
    except NativeDecodeError:
        return None


def damaged(data: bytes, rng: np.random.RandomState, mutations: int):
    """The file cut at ``CUTS`` points, and ``mutations`` copies with 1-3
    bytes overwritten (half of them inside the first ``HEADER_BYTES``)."""
    cases = [data[:n] for n in np.linspace(1, len(data) - 1, CUTS).astype(int)]
    for i in range(mutations):
        b = bytearray(data)
        hi = min(len(b), HEADER_BYTES) if i % 2 == 0 else len(b)
        for pos in rng.randint(2, hi, rng.randint(1, 4)):
            b[pos] = rng.randint(0, 256)
        cases.append(bytes(b))
    return cases


def fuzz(mutations: int, seed: int) -> int:
    rng = np.random.RandomState(seed)
    counts = {"both refuse": 0, "equal": 0, "disagree": 0}
    paths = sorted(glob.glob(os.path.join(REPO, "tests", "data", "torch_formats_variants",
                                          "small", "jpeg2000_*")))
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        for i, case in enumerate(damaged(data, rng, mutations)):
            want, got = pil_image(case), port_image(case)
            if want is None and got is None:
                counts["both refuse"] += 1
            elif want is not None and got is not None and got.shape == want.shape \
                    and (got == want).all():
                counts["equal"] += 1
            else:
                counts["disagree"] += 1
                print(f"DISAGREE {os.path.basename(path)} case {i}: PIL "
                      f"{'refuses' if want is None else want.shape}, port "
                      f"{'refuses' if got is None else got.shape}")
    print(f"{len(paths)} fixtures, {sum(counts.values())} files: {counts}")
    return 1 if counts["disagree"] else 0


def random_settings(rng: np.random.RandomState):
    """(planes, jpeg2000_bytes keywords) of one random test file; the
    irreversible ones keep every tile-component at least 4 samples per
    level (OpenJPEG's encoder asserts on shorter lines)."""
    from scripts.format_variants import CBLK_STYLES, PROGRESSIONS, jpeg2000_planes
    nc = int(rng.choice([1, 1, 2, 3, 3, 4]))
    h, w = int(rng.randint(1, 90)), int(rng.randint(1, 90))
    bits = int(rng.choice([1, 4, 7, 8, 8, 8, 10, 12, 16]))
    dxdy = None
    if nc >= 3 and rng.rand() < 0.3:
        sub = (int(rng.choice([1, 2])), int(rng.choice([1, 2])))
        dxdy = [(1, 1), sub, sub] + [(1, 1)] * (nc - 3)
    kw = dict(levels=int(rng.randint(0, 6)), styles=tuple(s for s in CBLK_STYLES if rng.rand() < 0.25),
              sop=bool(rng.rand() < 0.3), eph=bool(rng.rand() < 0.3),
              irreversible=bool(rng.rand() < 0.5), progression=str(rng.choice(PROGRESSIONS)),
              precision=bits, signed=bool(rng.rand() < 0.2), dxdy=dxdy)
    cw, ch = int(2 ** rng.randint(2, 7)), int(2 ** rng.randint(2, 7))
    kw["cblk"] = (cw, ch) if cw * ch <= 4096 else (64, 64)
    if rng.rand() < 0.5:
        kw["rates"] = sorted({float(rng.choice([2, 5, 10, 30])) for _ in range(rng.randint(1, 4))},
                             reverse=True) + ([0] if rng.rand() < 0.3 else [])
    if rng.rand() < 0.3 and not kw["irreversible"]:
        kw["tile"] = (int(rng.randint(8, 64)), int(rng.randint(8, 64)))
        if rng.rand() < 0.3:
            kw["tile_parts"] = str(rng.choice(["R", "L", "C"]))
    if rng.rand() < 0.3 and not kw["irreversible"]:
        kw["offset"] = (int(rng.randint(0, 9)), int(rng.randint(0, 9)))
        if "tile" in kw and rng.rand() < 0.5:
            kw["tile_offset"] = (int(rng.randint(0, kw["offset"][0] + 1)),
                                 int(rng.randint(0, kw["offset"][1] + 1)))
    if rng.rand() < 0.3:
        kw["precincts"] = [(int(2 ** rng.randint(2, 8)),) * 2] * (kw["levels"] + 1)
    if nc >= 3 and dxdy is None and rng.rand() < 0.5:
        kw["mct"] = True
    if rng.rand() < 0.15:
        kw["roi"] = (int(rng.randint(0, nc)), int(rng.randint(1, 10)))
    kw["plt"], kw["tlm"] = bool(rng.rand() < 0.2), bool(rng.rand() < 0.1)
    if kw["irreversible"]:
        h, w = max(h, 2 ** (kw["levels"] + 2)), max(w, 2 ** (kw["levels"] + 2))
        if dxdy:
            h, w = 2 * h, 2 * w
    return jpeg2000_planes(h, w, nc, int(rng.randint(1 << 30)), bits=bits,
                           signed=kw["signed"], dxdy=dxdy), kw


def encodes(n: int, seed: int) -> int:
    from scripts.format_variants import jpeg2000_bytes
    rng = np.random.RandomState(seed)
    counts = {"both refuse": 0, "equal": 0, "disagree": 0, "encoder refused": 0}
    for i in range(n):
        planes, kw = random_settings(rng)
        try:
            data = jpeg2000_bytes(planes, **kw)
        except ValueError:
            counts["encoder refused"] += 1
            continue
        for mode in ("L", "RGB"):
            want, got = pil_image(data, mode), port_image(data, mode)
            if want is None and got is None:
                counts["both refuse"] += 1
            elif want is not None and got is not None and got.shape == want.shape \
                    and (got == want).all():
                counts["equal"] += 1
            else:
                counts["disagree"] += 1
                print(f"DISAGREE encode {i} {mode}: {kw}")
    print(f"{n} random encodes: {counts}")
    return 1 if counts["disagree"] else 0


def timing() -> None:
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "data", "torch_formats_jpeg2000",
                                              "*.jp2"))):
        with open(path, "rb") as f:
            data = f.read()

        def best(fn):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return min(times)
        pil_ms = best(lambda: Image.open(io.BytesIO(data)).load())
        port_ms = best(lambda: jpeg2000.decode(data, "L"))
        print(f"{os.path.basename(path)}: OpenJPEG (PIL) {pil_ms:.1f} ms, port {port_ms:.1f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mutations", type=int, default=40)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--encodes", type=int, default=0)
    parser.add_argument("--time", action="store_true")
    args = parser.parse_args()
    rc = fuzz(args.mutations, args.seed)
    if args.encodes:
        rc |= encodes(args.encodes, args.seed)
    if args.time:
        timing()
    return rc


if __name__ == "__main__":
    sys.exit(main())
