"""Hold the port's decoders of the main path's formats (JPEG, TIFF, PNG,
PNM, BMP, GIF) to PIL beyond the fixtures, on this host.

Every committed small fixture of these formats
(``tests/data/torch_formats_variants/small/``: ``jpeg_*``, ``tiff_*``,
``png_*``, ``pnm_*``, ``bmp_*``, ``gif_*``) is cut at ``--cuts`` points,
damaged at ``--mutations`` seeded places of one or two bytes (a third in
the first 64 bytes, a third in the first 600, a third anywhere) and, for
JPEG and PNG, at ``--entropy`` seeded places of one or two bytes inside the
entropy-coded data of a scan (JPEG) or the zlib data of the IDAT chunks
(PNG): header damage alone rarely reaches a decoder's recovery code. Each
file goes through the JAX package's ``load_image`` (PIL, from a file path,
as the reference reads pages) and the port's, in "L" and "RGB", and each
file's outcome is counted per format: equal pixels, other pixels, refused
by the port only, refused by PIL only, refused by both, and refused by
the port as a divergence ``ROADMAP.md`` records as decided (its message
says so). Every refusal of the port must be ``UnsupportedImageFormat``.
Prints the counts and every disagreement; exits 1 on any.

Needs PIL and the JAX package; run from the repository root:

    python scripts/fuzz_main_formats.py [--cuts 12] [--mutations 24] [--entropy 24]
        [--seed 0] [--only jpeg_] [--jobs 4]
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import struct
import sys
import tempfile
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SMALL = os.path.join(REPO, "tests", "data", "torch_formats_variants", "small")
FORMATS = {"jpeg_": "JPEG", "tiff_": "TIFF", "png_": "PNG", "pnm_": "PNM", "bmp_": "BMP",
           "gif_": "GIF"}
OUTCOMES = ("equal", "other pixels", "port refuses only", "PIL refuses only", "both refuse",
            "decided divergence")
# the port's refusals of files whose PIL result is recorded in ROADMAP.md as
# a decided divergence name it so
DECIDED = "decided divergence"


def fixtures(only: str = ""):
    """[(name, format)] of the committed small fixtures of the six formats."""
    return [(name, FORMATS[prefix]) for name in sorted(os.listdir(SMALL))
            for prefix in FORMATS if name.startswith(prefix) and name.startswith(only)]


def jpeg_entropy_spans(data: bytes):
    """[(start, end)] of the entropy-coded segments of every scan (between
    an SOS header or a restart marker and the next marker)."""
    spans, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xFF, 0x00, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2 if marker != 0xFF else 1
            continue
        if marker == 0xD9:
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        pos += 2 + length
        if marker != 0xDA:
            continue
        start = pos
        while pos + 1 < len(data):
            if data[pos] == 0xFF and data[pos + 1] != 0 and not 0xD0 <= data[pos + 1] <= 0xD7:
                break
            if data[pos] == 0xFF and 0xD0 <= data[pos + 1] <= 0xD7:
                spans.append((start, pos))
                start = pos + 2
                pos += 2
                continue
            pos += 1
        spans.append((start, pos))
    return [(a, b) for a, b in spans if b > a]


def png_idat_spans(data: bytes):
    """[(start, end)] of the IDAT chunks' data."""
    spans, pos = [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        if kind == b"IDAT":
            spans.append((pos + 8, min(pos + 8 + length, len(data))))
        pos += 12 + length
    return [(a, b) for a, b in spans if b > a]


def entropy_spans(data: bytes, fmt: str):
    if fmt == "JPEG":
        return jpeg_entropy_spans(data)
    if fmt == "PNG":
        return png_idat_spans(data)
    return []


def _change(data: bytes, rng, places):
    """``data`` with one or two of ``places`` (byte offsets) overwritten by
    random values."""
    out = bytearray(data)
    for _ in range(1 + rng.randint(0, 2)):
        out[int(places(rng))] = int(rng.randint(0, 256))
    return bytes(out)


def damaged(data: bytes, fmt: str, cuts: int, mutations: int, entropy: int, seed: int):
    """(label, bytes) of the cuts, the mutations anywhere and the mutations
    inside the entropy-coded data of a file."""
    rng = np.random.RandomState(seed)
    for frac in np.linspace(0.05, 0.999, cuts):
        yield f"cut {frac:.3f}", data[:int(len(data) * frac)]
    for k in range(mutations):
        span = (64, 600, len(data))[k % 3]
        yield f"bytes {k}", _change(data, rng, lambda r: r.randint(0, min(len(data), span)))
    spans = entropy_spans(data, fmt)
    if not spans:
        return
    sizes = np.array([b - a for a, b in spans], np.float64)

    def place(r):
        a, b = spans[int(r.choice(len(spans), p=sizes / sizes.sum()))]
        return r.randint(a, b)
    for k in range(entropy):
        yield f"entropy {k}", _change(data, rng, place)


def _load(module, path):
    out = {}
    for mode in ("L", "RGB"):
        module._IMAGE_CACHE.clear()
        try:
            out[mode] = module.load_image(path, mode)
        except Exception as e:      # noqa: BLE001 - either side's failure is compared
            return e
    return out


def compare(path: str):
    """(outcome, what the port raised or None) of one file."""
    from citlab_as_tpu.utils import io as jio
    from citlab_as_tpu_torch.utils import io as tio
    want, got = _load(jio, path), _load(tio, path)
    bad_kind = got if (isinstance(got, Exception)
                       and not isinstance(got, tio.UnsupportedImageFormat)) else None
    if isinstance(want, Exception):
        return ("both refuse" if isinstance(got, Exception) else "PIL refuses only"), bad_kind
    if isinstance(got, Exception):
        return ("decided divergence" if DECIDED in str(got) else "port refuses only"), bad_kind
    same = all(got[m].shape == want[m].shape and np.array_equal(got[m], want[m]) for m in want)
    return ("equal" if same else "other pixels"), None


def _quiet():
    """Workers drop the C libraries' warnings (libtiff prints them)."""
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, 2)


def run_fixture(args):
    """Every damaged file of one fixture: (format, counts, disagreements)."""
    name, fmt, cuts, mutations, entropy, seed = args
    warnings.simplefilter("ignore")
    with open(os.path.join(SMALL, name), "rb") as f:
        data = f.read()
    counts = dict.fromkeys(OUTCOMES, 0)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "damaged" + os.path.splitext(name)[1])
        for label, body in damaged(data, fmt, cuts, mutations, entropy,
                                   seed + sum(map(ord, name))):
            with open(path, "wb") as f:
                f.write(body)
            outcome, bad_kind = compare(path)
            counts[outcome] += 1
            if outcome in ("other pixels", "port refuses only", "PIL refuses only"):
                bad.append(f"{name} {label}: {outcome}")
            if bad_kind is not None:
                bad.append(f"{name} {label}: the port raises {bad_kind!r}, not "
                           "UnsupportedImageFormat")
    return fmt, counts, bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cuts", type=int, default=12)
    parser.add_argument("--mutations", type=int, default=24)
    parser.add_argument("--entropy", type=int, default=24,
                        help="mutations inside JPEG entropy-coded data and PNG IDAT data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", default="", help="a prefix of the fixtures' names")
    parser.add_argument("--jobs", type=int, default=4)
    args = parser.parse_args()
    work = [(name, fmt, args.cuts, args.mutations, args.entropy, args.seed)
            for name, fmt in fixtures(args.only)]
    totals = {fmt: dict.fromkeys(OUTCOMES, 0) for fmt in FORMATS.values()}
    bad = []
    with multiprocessing.get_context("spawn").Pool(args.jobs, _quiet) as pool:
        for fmt, counts, wrong in pool.imap_unordered(run_fixture, work):
            for k, v in counts.items():
                totals[fmt][k] += v
            bad += wrong
    for line in sorted(bad):
        print(line)
    for fmt, counts in totals.items():
        if sum(counts.values()):
            print(f"{fmt}: {sum(counts.values())} files: " + ", ".join(
                f"{v} {k}" for k, v in counts.items()))
    print(f"{sum(sum(c.values()) for c in totals.values())} files, {len(bad)} disagreeing")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
