"""Run some of ``chip_smoke.py``'s phases on the card, in the order given.

    python3 scripts/run_smoke_phases.py pipelined parallel spatial dp_train dp_procs

The device and build phases run first. The parallel and spatial phases read
the pipelined phase's corpus, so it must come before them; dp_procs prints
dp_train's in-process numbers beside its own when dp_train ran before it;
the files phase's CPU-device check is waited for and gated after the last
phase. Each phase keeps its gates: the script exits 1 when one fails. It
prints the phases' seconds last. On a machine of four cards the parallel,
spatial, dp_train and dp_procs phases put one mesh entry, or one process,
on each card.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

NEEDS_PIPELINED = ("parallel", "spatial")


def main(names) -> int:
    from citlab_as_tpu_torch.device import resolve_device
    unknown = [n for n in names if not hasattr(smoke, f"phase_{n}")]
    if unknown or not names:
        print(f"run_smoke_phases: no phase {unknown} in chip_smoke.py" if unknown else
              __doc__, file=sys.stderr)
        return 2
    rows, seconds = {}, {}
    try:
        dev = resolve_device("cuda")
        smoke.phase_device()
        smoke.phase_build()
        for name in names:
            t0 = time.perf_counter()
            fn = getattr(smoke, f"phase_{name}")
            if name in NEEDS_PIPELINED:
                if "pipelined" not in rows:
                    raise smoke.Fail(f"{name} reads the pipelined phase's corpus: run "
                                     "pipelined before it")
                rows[name] = fn(dev, rows["pipelined"])
            elif name == "dp_procs":
                rows[name] = fn(dev, rows.get("dp_train"))
            else:
                rows[name] = fn(dev)
            seconds[name] = round(time.perf_counter() - t0, 1)
        if "files" in rows:
            smoke.cpu_check_finish(rows["files"]["cpu_check"])
    except smoke.Fail as e:
        print(f"run_smoke_phases: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if "pipelined" in rows:
            shutil.rmtree(rows["pipelined"]["corpus"][0], ignore_errors=True)
        if "files" in rows:
            smoke.cpu_check_stop(rows["files"]["cpu_check"])
    print(f"phase seconds {json.dumps(seconds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
