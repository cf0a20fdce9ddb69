"""Hold the port's zstd decoder (``csrc/zstd_decode.cpp`` through
``citlab_as_tpu_torch/utils/zstd.py``) to libzstd (the ``zstandard``
package) on damaged frames, on this host.

Each of ``--frames`` frames per seed is written by libzstd from seeded data
(random bytes, text, float32 noise, skewed bytes, runs; 10 B to 150 KB; a
level from -5 to 22; content size and checksum each on or off), then
damaged one way: 1-3 flipped bits anywhere, one byte overwritten anywhere,
a cut, one byte of the frame header overwritten, or 1-2 flipped bits in
the first twentieth (the first blocks' literals and sequences headers).
Where libzstd decodes the frame (as one whole frame: trailing bytes
refused), the port must give its bytes; where libzstd refuses it, the port
must raise ``ZstdError``. A frame whose header gives a content size of 0
is decoded by libzstd's streaming call, as the binding's one-shot call
returns b"" for it without decoding; one whose header gives more than
64 MiB, which no frame here holds, counts as refused by libzstd (its
content check), as the binding would first allocate that much. Prints per
seed the counts of frames both decoded alike and both refused, and each
disagreement (level, data, size, flags, damage, the frame's first bytes);
exits 1 on any.

Needs ``zstandard``; run from the repository root:

    python scripts/fuzz_zstd.py [--seeds 0 1 2] [--frames 3000] [--header-heavy] [--jobs 4]

``--header-heavy`` draws only the last kind of damage (the first blocks).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LEVELS = (-5, 1, 3, 9, 19, 22)
KINDS = ("random", "text", "floats", "skewed", "runs")
SIZES = (10, 100, 1000, 5000, 40000, 150000)


def data(kind: str, n: int, rng) -> bytes:
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "text":
        words = [b"alpha ", b"beta ", b"gamma ", b"delta\n", b"0123456789", b"zstd ", b"ocdbt/"]
        return b"".join(words[i] for i in rng.integers(0, len(words), n // 3 + 1))[:n]
    if kind == "floats":
        return (rng.standard_normal(n // 4 + 1).astype(np.float32) * 0.01).tobytes()[:n]
    if kind == "skewed":
        return rng.geometric(0.3, n).astype(np.uint8).tobytes()
    return np.repeat(rng.integers(0, 4, n // 50 + 1, dtype=np.uint8), 50).tobytes()[:n]


def libzstd(frame: bytes):
    """libzstd's bytes of one whole frame, or None where it refuses it."""
    import zstandard
    try:
        try:
            size = zstandard.get_frame_parameters(frame).content_size
        except zstandard.ZstdError:
            size = None
        if size == 0:
            obj = zstandard.ZstdDecompressor().decompressobj()
            out = obj.decompress(frame)
            return None if obj.unused_data or not obj.eof else out
        if size is not None and size > 1 << 26 and size != zstandard.CONTENTSIZE_UNKNOWN:
            # no frame here holds that much: libzstd's content check refuses
            # it (the binding would first allocate the size the header gives)
            return None
        out = zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 26,
                                                      allow_extra_data=False)
        obj = zstandard.ZstdDecompressor().decompressobj()
        try:
            obj.decompress(frame)
        except zstandard.ZstdError:
            return out
        return None if obj.unused_data else out
    except zstandard.ZstdError:
        return None


def damage(frame: bytearray, how: int, rng) -> bytes:
    if how == 0:
        for _ in range(int(rng.integers(1, 4))):
            frame[int(rng.integers(len(frame)))] ^= 1 << int(rng.integers(8))
    elif how == 1:
        frame[int(rng.integers(len(frame)))] = int(rng.integers(256))
    elif how == 2:
        frame = frame[:int(rng.integers(len(frame)))]
    elif how == 3:
        frame[int(rng.integers(min(len(frame), 40)))] = int(rng.integers(256))
    else:
        lo = min(9, len(frame) - 1)
        for _ in range(int(rng.integers(1, 3))):
            frame[int(rng.integers(lo, max(lo + 1, len(frame) // 20)))] ^= 1 << int(rng.integers(8))
    return bytes(frame)


def run_seed(args):
    seed, frames, header_heavy = args
    import zstandard
    from citlab_as_tpu_torch.utils import zstd
    rng = np.random.default_rng(seed)
    counts = {"decoded alike": 0, "both refused": 0}
    disagree = []
    for _ in range(frames):
        level = int(rng.choice(LEVELS))
        kind = str(rng.choice(KINDS))
        n = int(rng.choice(SIZES))
        size, check = bool(rng.integers(2)), bool(rng.integers(2))
        frame = bytearray(zstandard.ZstdCompressor(
            level=level, write_content_size=size, write_checksum=check).compress(
                data(kind, n, rng)))
        how = 4 if header_heavy else int(rng.integers(5))
        damaged = damage(frame, how, rng)
        want = libzstd(damaged)
        try:
            got = zstd.decompress(damaged)
        except zstd.ZstdError:
            got = None
        if got == want:
            counts["both refused" if want is None else "decoded alike"] += 1
        else:
            disagree.append((level, kind, n, size, check, how, damaged[:16].hex(),
                             "libzstd refused" if want is None else "port refused"
                             if got is None else "other bytes"))
    return seed, counts, disagree


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--frames", type=int, default=3000)
    parser.add_argument("--header-heavy", action="store_true")
    parser.add_argument("--jobs", type=int, default=max(1, min(4, (os.cpu_count() or 2) - 1)))
    args = parser.parse_args(argv)
    jobs = [(s, args.frames, args.header_heavy) for s in args.seeds]
    with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
        results = pool.map(run_seed, jobs)
    bad = 0
    for seed, counts, disagree in results:
        print(f"seed {seed}: {counts['decoded alike']} decoded alike, "
              f"{counts['both refused']} both refused, {len(disagree)} disagreeing")
        for d in disagree:
            print("  disagree:", d)
        bad += len(disagree)
    total = len(args.seeds) * args.frames
    print(f"{total} damaged frames, {bad} disagreeing")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
