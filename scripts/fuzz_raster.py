"""Hold the port's raster-format decoders (``utils/raster_formats.py``) to
PIL beyond the fixtures, on this host.

Every raster variant of ``scripts/format_variants.py`` (the small fixtures
of PCX, DCX, PSD, TGA, ICO, CUR, DIB, SGI, SUN, QOI, MSP, IM, XBM, XPM,
PIXAR, SPIDER, GBR, IMT, MCIDAS, XVTHUMB) cut at ``--cuts`` points and
damaged at ``--mutations`` seeded single bytes (a third in the first 64
bytes, a third in the first 600, a third anywhere). Each file goes through
the JAX package's ``load_image`` (PIL, from a file path, as the reference
reads pages) and the port's, in "L" and "RGB": where PIL decodes, the
port must give its pixels; where PIL raises, the port must raise
``UnsupportedImageFormat``. Prints the counts and every disagreement;
exits 1 on any.

Needs PIL and the JAX package; run from the repository root:

    python scripts/fuzz_raster.py [--cuts 25] [--mutations 400] [--only pcx_]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from citlab_as_tpu.utils import io as jio  # noqa: E402
from citlab_as_tpu_torch.utils import io as tio  # noqa: E402
from scripts.format_variants import RASTER_VARIANTS  # noqa: E402


def _load(module, path):
    out = {}
    for mode in ("L", "RGB"):
        module._IMAGE_CACHE.clear()
        try:
            out[mode] = module.load_image(path, mode)
        except Exception as e:      # noqa: BLE001 - either side's failure is compared
            return e
    return out


def damaged(data: bytes, cuts: int, mutations: int, seed: int):
    """(label, bytes) of the cuts and the single-byte mutations of a file."""
    rng = np.random.RandomState(seed)
    for frac in np.linspace(0.02, 0.999, cuts):
        yield f"cut {frac:.3f}", data[:int(len(data) * frac)]
    for k in range(mutations):
        span = (64, 600, len(data))[k % 3]
        at = int(rng.randint(0, min(len(data), span)))
        yield f"byte {at}", data[:at] + bytes([int(rng.randint(0, 256))]) + data[at + 1:]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cuts", type=int, default=25)
    parser.add_argument("--mutations", type=int, default=400)
    parser.add_argument("--only", default="", help="a prefix of the variants' names")
    args = parser.parse_args()
    warnings.simplefilter("ignore")
    files = bad = decoded = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "damaged")
        for name, make in RASTER_VARIANTS.items():
            if not name.startswith(args.only):
                continue
            seed = sum(map(ord, name))
            for label, data in damaged(make(name), args.cuts, args.mutations, seed):
                with open(path, "wb") as f:
                    f.write(data)
                want, got = _load(jio, path), _load(tio, path)
                files += 1
                if isinstance(want, Exception):
                    if not isinstance(got, tio.UnsupportedImageFormat):
                        bad += 1
                        print(f"{name} {label}: PIL raises ({want!r}), the port gives {got!r}")
                    continue
                decoded += 1
                if isinstance(got, Exception):
                    bad += 1
                    print(f"{name} {label}: PIL decodes, the port raises {got!r}")
                elif any(got[m].shape != want[m].shape or not np.array_equal(got[m], want[m])
                         for m in want):
                    bad += 1
                    print(f"{name} {label}: the port's pixels differ from PIL's")
    print(f"{files} files: {decoded} decoded by PIL, {files - decoded} refused by PIL, "
          f"{bad} disagreeing")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
