"""Time the heading stage's plain-PyTorch device ops on a CUDA card: Otsu +
jump-flood EDT of one page group, and the per-line feature program
(``ops/swt_device.py::DeviceLineFeatures``) at several chunk sizes (crops
per component fixpoint; the module's constant ``_STATS_CHUNK``, set here
for the measurement only).

Inputs are those of ``chip_smoke.py``'s files-to-files path: one group of 4
synthetic 2000 x 1420 newspaper pages with their 250-400 text-line boxes
per page (three tall headline lines among them), the distance transform
computed from the pages on the card, and a random uint8 probability map at
the heading net's resolution. Each chunk size runs in the order given
and then in reverse (A B .. B A), so that a drift of the card shows; wall
time is a host clock around work that ends in the readback, the sweeps and
host syncs are the fixpoints' own counts.

    python3 scripts/time_torch_line_features.py [--chunks 64,256,1024]

Prints one JSON line. Imports only the port and ``chip_smoke``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chunks", default="64,256,1024",
                        help="comma-separated crops per fixpoint")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from citlab_as_tpu_torch.device import resolve_device
    from citlab_as_tpu_torch.ops import swt_device
    from citlab_as_tpu_torch.ops.binarize import otsu_binarize
    from citlab_as_tpu_torch.ops.distance_transform import distance_transform_edt

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    pages, _, layouts = cs.synthetic_newspaper(cs.BATCH, *cs.PAGE_SHAPE, seed=11)
    sc = cs.HEADING_FIXED_HEIGHT / cs.PAGE_SHAPE[0]
    swt_list = [np.asarray([(x0, y0, x1 - x0, y1 - y0)
                            for _, lines in lay for _, (x0, y0, x1, y1) in lines], np.int32)
                for lay in layouts]
    net_list = [(b * sc).astype(np.int32) for b in swt_list]
    x = torch.from_numpy(np.stack(pages)).to(dev)
    rng = np.random.RandomState(0)
    prob = torch.from_numpy(rng.randint(0, 256, (cs.BATCH, cs.HEADING_FIXED_HEIGHT,
                                                 int(cs.PAGE_SHAPE[1] * sc))).astype(np.uint8)).to(dev)

    def otsu_edt():
        _, binary = otsu_binarize(255.0 - x.to(torch.float32), blur_ksize=5)
        return distance_transform_edt(binary, cap=255.0).to(torch.uint8)

    def wall(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, times

    dt, edt_s = wall(otsu_edt, args.reps)
    chunks = [int(c) for c in args.chunks.split(",")]
    rows, reference = [], None
    for chunk in chunks + chunks[::-1]:
        swt_device._STATS_CHUNK = chunk
        features = swt_device.DeviceLineFeatures()
        swt_device.reset_counts()
        out, times = wall(lambda: features.dispatch_batch(dt, prob, swt_list, net_list)(),
                          args.reps)
        packed = [np.concatenate([n[:, None], s], axis=1) for n, s in out]
        if reference is None:
            reference = packed
        same = all(np.array_equal(a, b) for a, b in zip(packed, reference))
        rows.append({"chunk": chunk, "seconds": times,
                     "sweeps_per_call": swt_device.COUNTS["sweeps"] // (args.reps + 1),
                     "host_syncs_per_call": swt_device.COUNTS["syncs"] // (args.reps + 1),
                     "equal_to_first": same})
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
        "pages": cs.BATCH, "lines": [len(b) for b in swt_list],
        "otsu_edt_seconds": edt_s, "line_features": rows}))
    return 0 if all(r["equal_to_first"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
