"""The f32 segmentation step of ``chip_smoke.py``'s dp_train phase, sharded
and unsharded, with the CUDA kernels each runs recorded: does cuDNN's
choice of algorithm set how far the two steps part?

    python3 scripts/dp_train_algorithms.py [--reps 4] [--out runs/algorithms.json]

For each setting, ``reps`` times: the dp_train phase's first f32 step from
``separator.npz`` on its first batch (8 x 512 x 512 crops of drawn GT pages,
the recipe's class weights and optimizer), once over a mesh of 2 shards of
the card (``make_sharded_train_step``) and once unsharded
(``make_train_step``), each from a fresh copy of the init and under
``torch.profiler``. The settings: cuDNN's defaults;
``torch.backends.cudnn.deterministic = True``; the defaults with all but
``PRESSURE_MARGIN`` times the step's own peak of the card's memory held by
one tensor (as in a long process whose memory earlier work has taken, where
an algorithm whose workspace does not fit gives way to another). Prints,
per run, the applied gradient's and the parameters' gap between the two
steps over the whole net (and the worst leaf), and the convolution kernels
of each step that the first run of its setting did not run; ``--out``
keeps every run's kernel names and counts.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

PRESSURE_MARGIN = 1.25
CONV_WORDS = ("conv", "dgrad", "wgrad", "fft", "winograd", "implicit", "xmma", "cudnn",
              "gemm", "cutlass")


def kernels(prof):
    """The CUDA kernels a profiled region ran: ``{name: count}``."""
    from torch.autograd import DeviceType
    return dict(collections.Counter(e.name for e in prof.events()
                                    if e.device_type == DeviceType.CUDA))


def conv_kernels(names):
    return {k: v for k, v in names.items() if any(w in k.lower() for w in CONV_WORDS)}


def one_run(dev, batches):
    """The sharded and the unsharded first step from fresh copies of the
    init: their gaps and the kernels each ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from citlab_as_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from citlab_as_tpu_torch.train.optimizer import adam, cosine_decay_schedule
    from citlab_as_tpu_torch.train.segmentation import (
        create_model, make_sharded_train_step, make_train_step,
    )
    from citlab_as_tpu_torch.weights import arunet_state_dict_from_flax, load_npz
    init = arunet_state_dict_from_flax(
        load_npz(os.path.join(REPO, "models_ckpt_torch", "separator.npz")))
    optimizer = adam(cosine_decay_schedule(1e-3, smoke.DP_SEG_WARM + smoke.DP_SEG_TIMED,
                                           alpha=0.1))
    mesh = make_mesh([dev] * smoke.DP_SHARDS)

    def model():
        m = create_model(dtype=torch.float32)
        m.load_state_dict(init)
        return m.to(dev)

    replicas = replicate(mesh, model())
    params = [dict(r.named_parameters()) for r in replicas]
    states = [optimizer.init(p) for p in params]
    sharded = make_sharded_train_step(replicas, optimizer, mesh, smoke.DP_CLASS_WEIGHTS)
    single_model = model()
    single_params = dict(single_model.named_parameters())
    single_state = optimizer.init(single_params)
    single = make_train_step(single_model, optimizer, smoke.DP_CLASS_WEIGHTS)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    shards = shard_batch(mesh, batches[0])
    for label, fn in (("sharded", lambda: sharded(params, states, shards)),
                      ("unsharded", lambda: single(single_params, single_state, batches[0]))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss = float(fn())
            torch.cuda.synchronize()
        out[label] = {"loss": loss, "kernels": kernels(prof)}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    gap, leaf_gap, leaf = smoke.dp_gaps(params[0], single_params)
    grad, grad_leaf_gap, grad_leaf = smoke.dp_gaps(smoke.dp_grads(params),
                                                   smoke.dp_grads([single_params]))
    out.update(param_gap=gap, param_leaf=[leaf_gap, leaf], grad_gap=grad,
               grad_leaf=[grad_leaf_gap, grad_leaf],
               loss_rel=abs(out["sharded"]["loss"] - out["unsharded"]["loss"])
               / abs(out["unsharded"]["loss"]))
    return out


def main(argv=None) -> int:
    import torch
    from citlab_as_tpu_torch.device import resolve_device
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")
    smoke.phase_device()
    smoke.phase_build()
    root = tempfile.mkdtemp(prefix="dp_train_algorithms_")
    report = {}
    try:
        batches = smoke.dp_seg_batches(root, dev)[:1]
        peak = 0
        for setting in ("default", "deterministic", "pressure"):
            torch.backends.cudnn.deterministic = setting == "deterministic"
            hold = None
            if setting == "pressure":
                torch.cuda.empty_cache()
                free, _ = torch.cuda.mem_get_info()
                hold = torch.empty(max(free - int(PRESSURE_MARGIN * peak), 0),
                                   dtype=torch.uint8, device=dev)
            runs = []
            for rep in range(args.reps):
                try:
                    run = one_run(dev, batches)
                except torch.cuda.OutOfMemoryError as e:
                    print(f"{setting} run {rep}: out of memory ({e})")
                    torch.cuda.empty_cache()
                    continue
                peak = max(peak, run["peak_bytes"])
                first = runs[0] if runs else run
                new = {label: sorted(set(conv_kernels(run[label]["kernels"]))
                                     - set(conv_kernels(first[label]["kernels"])))
                       for label in ("sharded", "unsharded")}
                print(f"{setting} run {rep}: loss relative {run['loss_rel']:.3g}, applied "
                      f"gradient {run['grad_gap']:.3g} (worst leaf {run['grad_leaf'][0]:.3g} "
                      f"{run['grad_leaf'][1]}), parameters {run['param_gap']:.3g} (worst leaf "
                      f"{run['param_leaf'][0]:.3g} {run['param_leaf'][1]}) of their norms; "
                      f"conv kernels sharded {len(conv_kernels(run['sharded']['kernels']))}, "
                      f"unsharded {len(conv_kernels(run['unsharded']['kernels']))} distinct; "
                      f"not in run 0: {json.dumps(new)}")
                runs.append(run)
                torch.cuda.empty_cache()
            if runs:
                print(f"{setting}: conv kernels of run 0, sharded "
                      f"{json.dumps(conv_kernels(runs[0]['sharded']['kernels']))}; unsharded "
                      f"{json.dumps(conv_kernels(runs[0]['unsharded']['kernels']))}")
            report[setting] = runs
            del hold
            torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
