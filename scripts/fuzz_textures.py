"""Hold the port's decoders of the rest of PIL's registry (DDS, BLP, FTEX,
ICNS, PCD, FITS, FLI, IPTC: ``utils/textures.py``,
``utils/registry_formats.py``) to PIL beyond the fixtures, on this host.

Every variant of ``scripts/registry_variants.py`` (the small fixtures of
DDS, BLP, FTEX, ICNS, FITS, FLI and IPTC, and three PCD files) cut at
``--cuts`` points and damaged at ``--mutations`` seeded places of one or
two bytes: a third in the first 64 bytes (headers), a third in the first
600, a third anywhere (the BC blocks, the FLI chunks, the RLE and gzip
data). Each file goes through the JAX package's ``load_image`` (PIL, from
a file path, as the reference reads pages) and the port's, in "L" and
"RGB": where PIL decodes, the port must give its pixels; where PIL raises,
the port must raise ``UnsupportedImageFormat``. A damaged header that
asks for more than ``--max-pixels`` pixels (PIL's DDS and BLP decoders are
Python loops over every pixel) is held to PIL's size alone. Prints the
counts per format and every disagreement; exits 1 on any.

Needs PIL and the JAX package; run from the repository root:

    python scripts/fuzz_textures.py [--cuts 16] [--mutations 60] [--seed 0] [--only dds_]
        [--jobs 4] [--max-pixels 1048576]
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys
import tempfile
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def damaged(data: bytes, cuts: int, mutations: int, seed: int):
    """(label, bytes) of the cuts and the mutations of one or two bytes of
    a file."""
    rng = np.random.RandomState(seed)
    for frac in np.linspace(0.02, 0.999, cuts):
        yield f"cut {frac:.3f}", data[:int(len(data) * frac)]
    for k in range(mutations):
        span = (64, 600, len(data))[k % 3]
        out = bytearray(data)
        for _ in range(1 + rng.randint(0, 2)):
            out[int(rng.randint(0, min(len(data), span)))] = int(rng.randint(0, 256))
        yield f"bytes {k}", bytes(out)


def _load(module, path):
    out = {}
    for mode in ("L", "RGB"):
        module._IMAGE_CACHE.clear()
        try:
            out[mode] = module.load_image(path, mode)
        except Exception as e:      # noqa: BLE001 - either side's failure is compared
            return e
    return out


def catalog():
    """[(name, make(name) -> bytes)] of every variant and three PCD files."""
    from scripts import registry_variants as rv
    out = list({**rv.TEXTURE_VARIANTS, **rv.REGISTRY_VARIANTS}.items())
    out += [(f"pcd_orientation{o}.pcd", lambda name, o=o: rv.pcd_bytes(o, o))
            for o in (0, 1, 3)]
    return out


def _too_large(path, max_pixels):
    """PIL's size of the file where it is past ``max_pixels``, else None."""
    from PIL import Image
    try:
        with Image.open(path) as im:
            w, h = im.size
    except Exception:       # noqa: BLE001 - PIL refuses it: decoded below
        return None
    return (w, h) if w * h > max_pixels else None


def run_variant(args):
    """Every damaged file of one variant: (format, files, PIL decoded,
    disagreements)."""
    name, cuts, mutations, seed, max_pixels = args
    warnings.simplefilter("ignore")
    from citlab_as_tpu.utils import io as jio
    from citlab_as_tpu_torch.utils import io as tio
    make = dict(catalog())[name]
    files = decoded = 0
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "damaged" + os.path.splitext(name)[1])
        for label, data in damaged(make(name), cuts, mutations,
                                   seed + sum(map(ord, name))):
            with open(path, "wb") as f:
                f.write(data)
            files += 1
            large = _too_large(path, max_pixels)
            if large is not None:
                try:
                    size = tio.image_size(path)
                except tio.UnsupportedImageFormat as e:
                    size = e
                if size != large:
                    bad.append(f"{name} {label}: PIL opens {large}, the port's image_size "
                               f"gives {size!r}"[:400])
                continue
            want, got = _load(jio, path), _load(tio, path)
            if isinstance(want, Exception):
                if not isinstance(got, tio.UnsupportedImageFormat):
                    bad.append(f"{name} {label}: PIL raises ({want!r}), the port gives "
                               f"{got!r}"[:400])
                continue
            decoded += 1
            if isinstance(got, Exception):
                bad.append(f"{name} {label}: PIL decodes, the port raises {got!r}"[:400])
            elif any(got[m].shape != want[m].shape or not np.array_equal(got[m], want[m])
                     for m in want):
                bad.append(f"{name} {label}: the port's pixels differ from PIL's")
    return name.split("_")[0], files, decoded, bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cuts", type=int, default=16)
    parser.add_argument("--mutations", type=int, default=60)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", default="", help="a prefix of the variants' names")
    parser.add_argument("--jobs", type=int, default=4)
    parser.add_argument("--max-pixels", type=int, default=1 << 20)
    args = parser.parse_args()
    names = [n for n, _ in catalog() if n.startswith(args.only)]
    jobs = [(n, args.cuts, args.mutations, args.seed, args.max_pixels) for n in names]
    with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
        results = pool.map(run_variant, jobs, chunksize=1)
    totals = {}
    bad = []
    for fmt, files, decoded, disagree in results:
        t = totals.setdefault(fmt, [0, 0, 0])
        t[0] += files
        t[1] += decoded
        t[2] += len(disagree)
        bad += disagree
    for line in bad:
        print(line)
    for fmt, (files, decoded, n_bad) in sorted(totals.items()):
        print(f"{fmt.upper()}: {files} files: {decoded} decoded by PIL, "
              f"{files - decoded} refused by PIL, {n_bad} disagreeing")
    files = sum(t[0] for t in totals.values())
    print(f"{files} files, {len(bad)} disagreeing")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
