"""Hold the port's WebP decoder to PIL beyond the fixtures, on this host.

Fuzz: every small WebP fixture of ``tests/data/torch_formats_variants/small``
cut at 32 points and damaged at ``--mutations`` seeded random sets of 1-3
bytes (the RIFF header kept); each file must either decode to PIL's image
(mode and alpha included) or be refused by both. Prints the counts and
every disagreement; exits 1 on any.

Timing (``--time``): the full-size pages of ``tests/data/torch_formats_webp``
decoded by PIL (libwebp's ``Image.open(...).load()``) and by the port
(``utils/webp.decode``), best of 5, in ms on this host's CPU.

Needs PIL; run from the repository root:

    python scripts/fuzz_webp.py [--mutations 50] [--seed 0] [--time]
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
from citlab_as_tpu_torch.utils import webp  # noqa: E402
from citlab_as_tpu_torch.utils.image_native import NativeDecodeError  # noqa: E402


def _pil(data):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im)
    except Exception:
        return None


def _port(data):
    try:
        return webp.decode(data)
    except NativeDecodeError:
        return None


def fuzz(mutations: int, seed: int) -> int:
    rng = np.random.RandomState(seed)
    counts = {"both refuse": 0, "equal": 0, "disagree": 0}
    paths = sorted(glob.glob(os.path.join(REPO, "tests", "data", "torch_formats_variants",
                                          "small", "webp_*.webp")))
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        cases = [data[:n] for n in np.linspace(1, len(data) - 1, 32).astype(int)]
        for _ in range(mutations):
            b = bytearray(data)
            for pos in rng.randint(12, len(b), rng.randint(1, 4)):
                b[pos] = rng.randint(0, 256)
            cases.append(bytes(b))
        for i, case in enumerate(cases):
            want, got = _pil(case), _port(case)
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


def timing() -> None:
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "data", "torch_formats_webp",
                                              "*.webp"))):
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
        port_ms = best(lambda: webp.decode(data))
        print(f"{os.path.basename(path)}: libwebp (PIL) {pil_ms:.1f} ms, port {port_ms:.1f} ms")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mutations", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--time", action="store_true")
    args = parser.parse_args()
    rc = fuzz(args.mutations, args.seed)
    if args.time:
        timing()
    return rc


if __name__ == "__main__":
    sys.exit(main())
