"""Time the port's two CUDA kernels of one source tree on a CUDA card.

K1 (conv3x3) over the eight (Cin -> Cout) pairs of the ARU-Net at
4 x 1536 x 1088 in bf16, and K2 (separator morphology) at 4 x 1500 x 1065
uint8 with kernels (15, 30, 10): the shapes, inputs and timer of
``chip_smoke.py``, through the wrappers of the tree named by ``--repo``
(default: this one). To compare two versions of a kernel, unpack the other
commit into a directory that ``.gitignore`` lists and time both in one
run on one card, in turns:

    git archive <commit> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 scripts/time_torch_kernels.py --repo $t; done

With ``--instances`` K1 is also timed at each of the 24 (pair, shape)
instances one ARU forward launches (``chip_smoke.k1_main_path_instances``),
with the launch-weighted sum per forward, eagerly (CUDA events around
launches the host issues one by one) and as device time alone (the same
launches replayed from a CUDA graph); and the host's time to issue one
launch (the wrapper's Python and the CUDA runtime, no device sync) is
measured at the smallest instance. K2 is timed both ways too.

Prints the card's name and power limit and one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=HERE,
                        help="tree whose citlab_as_tpu_torch is timed")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--instances", action="store_true",
                        help="also time K1's 24 main-path instances")
    args = parser.parse_args(argv)
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, repo)
    import torch
    from citlab_as_tpu_torch.ops.kernels import conv3x3 as k1
    from citlab_as_tpu_torch.ops.kernels import separator_morphology as k2
    if not os.path.abspath(k1.__file__).startswith(repo + os.sep):
        print(f"the port was imported from {k1.__file__}, not {repo}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    b, h, w = cs.K1_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)

    def k1_inputs(cin, cout, hh, ww):
        x = torch.randn((b, hh, ww, cin), device=dev, generator=gen).bfloat16()
        wt = (torch.randn((cout, cin, 3, 3), device=dev, generator=gen)
              * (2.0 / (9 * cin + cout)) ** 0.5).bfloat16()
        return x, wt, torch.full((cout,), 0.1, device=dev).bfloat16()

    k1_ms = {}
    for cin, cout in cs.K1_PAIRS:
        x, wt, bias = k1_inputs(cin, cout, h, w)
        k1_ms[f"{cin}->{cout}"] = cs.cuda_ms(lambda: k1.conv3x3(x, wt, bias),
                                             iters=args.iters)
        del x
    extra = {}
    if args.instances:
        rows, per_forward, per_forward_device = [], 0.0, 0.0
        for cin, cout, hh, ww, n in cs.k1_main_path_instances():
            x, wt, bias = k1_inputs(cin, cout, hh, ww)
            ms = cs.cuda_ms(lambda: k1.conv3x3(x, wt, bias), iters=args.iters)
            device_ms = cs.cuda_graph_ms(lambda: k1.conv3x3(x, wt, bias), iters=args.iters)
            rows.append([cin, cout, hh, ww, n, ms, device_ms])
            per_forward += n * ms
            per_forward_device += n * device_ms
        # x, wt, bias are now the smallest instance's: issue without syncing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            k1.conv3x3(x, wt, bias)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        extra = {"k1_instances": rows, "k1_per_forward_ms": per_forward,
                 "k1_per_forward_device_ms": per_forward_device,
                 "k1_host_us_per_launch": host_us}
    page = cs.k2_input(*cs.K2_SHAPE, 1, dev)
    k2_ms = cs.cuda_ms(lambda: k2.separator_morphology(page, *cs.K2_KERNELS),
                       iters=5 * args.iters)
    k2_device_ms = cs.cuda_graph_ms(
        lambda: k2.separator_morphology(page, *cs.K2_KERNELS), iters=5 * args.iters)
    print(smi.stdout.strip())
    print(json.dumps({"repo": os.path.relpath(repo, HERE), "k1_shape": list(cs.K1_SHAPE),
                      "k1_ms": k1_ms, "k1_sum_ms": sum(k1_ms.values()),
                      "k2_shape": list(cs.K2_SHAPE), "k2_ms": k2_ms,
                      "k2_device_ms": k2_device_ms,
                      "launches": [k1.launches, k2.launches], **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
