"""Device-time breakdown of the port's stages on a CUDA card.

Runs the main path of ``chip_smoke.py`` (8 synthetic 2000 x 1420 pages,
fixed_height 1500, groups of 4, bf16, the converted separator weights)
once to warm up, then once under ``torch.profiler`` with the stage's phase
timing on (a device sync around each device phase). With ``--path files``
it runs ``chip_smoke.py``'s files-to-files path instead: the separator
stage from PNG and PAGE-XML files, then the heading stage (fixed_height
900, the converted heading weights) chained onto its output pages; the
heading stage's phases are listed as ``heading <phase>``. With ``--path
workflow`` it runs ``chip_smoke.py``'s workflow phase: the port's
``run_full_workflow`` over the same files with the converted ``gnn``
relation net and ``clustering_method="dbscan"``; the device phases are then
its stages (``timings`` keys), each call of a stage bracketed by device
syncs. With ``--path pipelined`` it runs ``chip_smoke.py``'s pipelined
phase's 16 pages through the sequential ``run_full_workflow`` and through
``run_full_workflow_pipelined`` (no workers, then ``--host_workers``
spawned workers), each once to warm up and once under ``torch.profiler``
(device activity only, no stage syncs), and prints per driver the wall
time, the device busy seconds and their share of the wall, the device
events and the driver's ``timings``. With ``--path spatial`` it profiles
the separator net's forward on ``chip_smoke.py``'s main-path batch (4 x
1536 x 1088, bf16) unsharded and height-sharded over k = 2 and 4 shards
of the card (``parallel/spatial.py``), and on its broadsheet page (1 x
9984 x 7040) unsharded and at k = 4, each once to warm up and once under
``torch.profiler``, and prints per input and k the device time split into
K1, the concatenations of the halo rows, other copies, the library's
convolutions and the rest, with the launches of each. Otherwise it
prints:

- the wall time of the profiled run and the device's busy share (the union
  of the CUDA kernel and memcpy intervals over that wall time);
- per device phase: wall time, device busy time inside it, and the number
  of device events;
- the fixpoints' host syncs over the run (``Tensor.any``, one per
  iteration): ``cc_host_syncs`` of the CC filter's labeling and size
  propagation, ``line_feature_host_syncs`` of the line features' sweeps;
- device time of the port's own kernels (K1 ``conv3x3``, K2
  ``separator_morphology``), summed over their instantiations;
- device time per kernel name, largest first.

    python3 scripts/profile_torch_separator.py
        [--path memory|files|workflow|pipelined|spatial] [--host_workers N]
        [--out build/profile_separator.json]

Imports only the port (``citlab_as_tpu_torch``) and ``chip_smoke`` for its
page generator.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("resize+forward", "cc", "morphology")
HEADING_PHASES = ("resize+forward", "otsu+edt", "line features")
WORKFLOW_STAGES = ("separator", "heading", "baseline_clustering", "textregion",
                   "features", "gnn_clustering")


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def profile_drivers(args) -> int:
    """``--path pipelined``: the device's busy share under each driver on
    the same 16 pages."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from citlab_as_tpu_torch.cli.run_full_workflow import (
        run_full_workflow, run_full_workflow_pipelined)
    from citlab_as_tpu_torch.inference import RelationPredictor

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    root = tempfile.mkdtemp(prefix="profile_torch_")
    drivers = [("sequential", run_full_workflow, {}),
               ("pipelined", run_full_workflow_pipelined, {"host_workers": 0}),
               (f"pipelined, {args.host_workers} workers", run_full_workflow_pipelined,
                {"host_workers": args.host_workers})]
    runs = {}
    try:
        pages, _, layouts = cs.synthetic_newspaper(cs.N_PIPE_PAGES, *cs.PAGE_SHAPE, seed=13)
        paths = cs.write_corpus(root, pages, layouts)
        run = cs._workflow_runner(dev, paths, RelationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "gnn.npz"), device=dev))
        for label, driver, kw in drivers:
            run(driver, **kw)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                secs, result, launches, timings = run(driver, **kw)
            intervals = [(e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_s = _union_us(intervals) / 1e6
            runs[label] = {"wall_s": secs, "pages_per_s": cs.N_PIPE_PAGES / secs,
                           "device_busy_s": busy_s, "device_busy_share": busy_s / secs,
                           "device_events": len(intervals), "launches": launches,
                           "skipped": len(result["skipped"]), "timings": timings}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
           "torch": torch.__version__, "path": "pipelined", "pages": cs.N_PIPE_PAGES,
           "batch": cs.BATCH, "runs": runs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


#: (part, substrings of a kernel's name) in the order they are tried
SPATIAL_PARTS = (("K1", ("conv3x3",)), ("concatenation", ("CatArray",)),
                 ("other copies", ("copy", "Memcpy", "memcpy")),
                 ("library convolutions", ("conv", "xmma", "cudnn", "cutlass", "wgrad",
                                           "dgrad")))


def profile_spatial(args) -> int:
    """``--path spatial``: the separator forward's device time by part,
    unsharded and over k row shards of the card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops.resize import scale_image

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    pred = SegmentationPredictor(os.path.join(REPO, "models_ckpt_torch", "separator.npz"),
                                 dtype=torch.bfloat16, device=dev)
    pages, _ = cs.synthetic_pages(cs.BATCH, *cs.PAGE_SHAPE, seed=47)
    batch = torch.from_numpy(pred._pack_host([
        scale_image(torch.from_numpy(p.astype(np.float32)), cs.FIXED_HEIGHT, 1.0)[0].numpy()
        / 255.0 for p in pages])).to(dev)
    tile, _ = cs.synthetic_pages(1, *cs.PAGE_SHAPE, seed=53)
    h, w = cs.BROADSHEET_SHAPE
    page = np.tile(tile[0], (-(-h // cs.PAGE_SHAPE[0]), -(-w // cs.PAGE_SHAPE[1])))[:h, :w]
    broadsheet = torch.from_numpy(page.astype(np.float32) / 255.0)[None, :, :, None].to(dev)
    runs = {}
    for label, x, k in (("batch", batch, 1), ("batch", batch, 2), ("batch", batch, 4),
                        ("broadsheet", broadsheet, 1), ("broadsheet", broadsheet, 4)):
        net = pred.model if k == 1 else cs.spatial_net(pred.model, dev, k)
        with torch.no_grad():
            net(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                net(x)
                torch.cuda.synchronize()
        parts = {name: [0.0, 0] for name, _ in SPATIAL_PARTS + (("rest", ()),)}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            part = next((name for name, keys in SPATIAL_PARTS
                         if any(key in e.name for key in keys)), "rest")
            parts[part][0] += (e.time_range.end - e.time_range.start) / 1e3
            parts[part][1] += 1
        runs[f"{label} k={k}"] = {"shape": list(x.shape),
                                  "device_ms": sum(v[0] for v in parts.values()),
                                  "parts_ms": {n: v[0] for n, v in parts.items()},
                                  "launches": {n: v[1] for n, v in parts.items()}}
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
           "torch": torch.__version__, "path": "spatial", "runs": runs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build",
                                                      "profile_separator.json"))
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--path", choices=("memory", "files", "workflow", "pipelined",
                                           "spatial"),
                        default="memory")
    parser.add_argument("--host_workers", type=int,
                        default=min(4, (os.cpu_count() or 2) - 1),
                        help="workers of the pipelined driver's second run "
                             "(--path pipelined)")
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if args.path == "pipelined":
        return profile_drivers(args)
    if args.path == "spatial":
        return profile_spatial(args)

    import chip_smoke as cs
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.ops import swt_device
    from citlab_as_tpu_torch.stages import separator as sep

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    pred = SegmentationPredictor(os.path.join(REPO, "models_ckpt_torch", "separator.npz"),
                                 dtype=torch.bfloat16, device=dev)
    root = None
    if args.path == "memory":
        pages, _ = cs.synthetic_pages(cs.N_PAGES, *cs.PAGE_SHAPE, seed=7)
        phase_names = list(PHASES)

        def run():
            phase = {}
            sep.SeparatorNetPostProcessor(pages, pred, fixed_height=cs.FIXED_HEIGHT,
                                          threshold=cs.THRESHOLD).run_batched(cs.BATCH, phase)
            torch.cuda.synchronize()
            return phase
    elif args.path == "workflow":
        import tempfile

        from citlab_as_tpu_torch.cli.run_full_workflow import run_full_workflow
        from citlab_as_tpu_torch.inference import RelationPredictor
        from citlab_as_tpu_torch.utils import io as port_io
        root = tempfile.mkdtemp(prefix="profile_torch_")
        pages, _, layouts = cs.synthetic_newspaper(cs.N_PAGES, *cs.PAGE_SHAPE, seed=11)
        paths = cs.write_corpus(root, pages, layouts)
        head_pred = SegmentationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "heading.npz"),
            dtype=torch.bfloat16, device=dev)
        gnn = RelationPredictor(os.path.join(REPO, "models_ckpt_torch", "gnn.npz"),
                                device=dev)
        phase_names = list(WORKFLOW_STAGES)

        def run():
            port_io._IMAGE_CACHE.clear()
            timings = {}
            run_full_workflow(paths, separator_predictor=pred, heading_predictor=head_pred,
                              gnn_predictor=gnn, clustering_method="dbscan",
                              batch_size=cs.BATCH, separator_fixed_height=cs.FIXED_HEIGHT,
                              heading_fixed_height=cs.HEADING_FIXED_HEIGHT,
                              timings=timings, device=dev)
            torch.cuda.synchronize()
            return timings
    else:
        import tempfile

        from citlab_as_tpu_torch.pagexml.page import page_cache
        from citlab_as_tpu_torch.stages import heading
        from citlab_as_tpu_torch.utils import io as port_io
        root = tempfile.mkdtemp(prefix="profile_torch_")
        pages, _, layouts = cs.synthetic_newspaper(cs.N_PAGES, *cs.PAGE_SHAPE, seed=11)
        paths = cs.write_corpus(root, pages, layouts)
        head_pred = SegmentationPredictor(
            os.path.join(REPO, "models_ckpt_torch", "heading.npz"),
            dtype=torch.bfloat16, device=dev)
        phase_names = list(PHASES) + ["heading " + p for p in HEADING_PHASES]

        def run():
            port_io._IMAGE_CACHE.clear()
            phase, head_phase = {}, {}
            stage = sep.SeparatorNetPostProcessor(paths, pred, fixed_height=cs.FIXED_HEIGHT,
                                                  threshold=cs.THRESHOLD)
            stage.run_batched_fused(cs.BATCH, phase)
            outs = [stage._page_path_for(p) + ".xml" for p in paths]
            with page_cache():
                heading.HeadingNetPostProcessor(
                    paths, head_pred, fixed_height=cs.HEADING_FIXED_HEIGHT,
                    page_paths=outs, save_suffix="").run_batched_fused(cs.BATCH, head_phase)
            torch.cuda.synchronize()
            phase.update({"heading " + k: v for k, v in head_phase.items()})
            return phase

    run()
    # label each device phase for the trace (inside the stage's own syncs),
    # and count the fixpoints' per-iteration host syncs (Tensor.any)
    orig_phase, orig_any = sep._phase, torch.Tensor.any
    syncs = []

    def labelled(prefix):
        @contextlib.contextmanager
        def labelled_phase(phase, name, device):
            with orig_phase(phase, name, device), record_function("phase:" + prefix + name):
                yield
        return labelled_phase

    def counting_any(self, *a, **k):
        syncs.append(1)
        return orig_any(self, *a, **k)

    def synced_stage(name, fn):
        """``fn`` as one device phase of the workflow: labelled and
        bracketed by device syncs, so that its device work falls inside."""
        def call(*a, **k):
            with record_function("phase:" + name):
                torch.cuda.synchronize()
                out = fn(*a, **k)
                torch.cuda.synchronize()
            return out
        return call

    # (owner, attribute, stage) of every call the workflow driver makes per
    # stage; the driver imports the stage functions when it runs, so the
    # module attributes are what it calls
    stage_calls = []
    if args.path == "workflow":
        from citlab_as_tpu_torch.stages import (
            baseline_clustering, features, gnn_io, heading, textregion)
        stage_calls = [
            (sep.SeparatorNetPostProcessor, "run_batched", "separator"),
            (heading.HeadingNetPostProcessor, "run_batched", "heading"),
            (baseline_clustering, "cluster_page", "baseline_clustering"),
            (textregion, "generate_text_regions_for_page", "textregion"),
            (features, "generate_feature_jsons", "features"),
            (gnn_io, "gnn_confidences_dispatch", "gnn_clustering"),
            (gnn_io, "gnn_clustering_for_page", "gnn_clustering")]
    originals = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in stage_calls]
    for owner, attr, stage in stage_calls:
        setattr(owner, attr, synced_stage(stage, getattr(owner, attr)))
    if args.path != "workflow":
        sep._phase = labelled("")
    torch.Tensor.any = counting_any
    swt_device.reset_counts()
    if args.path == "files":
        heading._phase = labelled("heading ")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            phase = run()
            wall_s = time.perf_counter() - t0
    finally:
        sep._phase, torch.Tensor.any = orig_phase, orig_any
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
        if args.path == "files":
            heading._phase = orig_phase
        if root is not None:
            import shutil
            shutil.rmtree(root, ignore_errors=True)

    intervals, by_name, windows = [], {}, {p: [] for p in phase_names}
    for e in prof.events():
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith("phase:"):
            # record_function also leaves a device-side annotation range of
            # the same name: a label, not device work
            if not on_device:
                windows.setdefault(e.name[len("phase:"):], []).append(
                    (e.time_range.start, e.time_range.end))
        elif on_device:
            s, t = e.time_range.start, e.time_range.end
            intervals.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    per_phase = {}
    for name, wins in windows.items():
        inside = [iv for lo, hi in wins for iv in _clip(intervals, lo, hi)]
        per_phase[name] = {
            "wall_s": phase.get(name), "windows": len(wins),
            "device_busy_s": _union_us(inside) / 1e6,
            "device_events": sum(1 for lo, hi in wins for s, e in intervals
                                 if lo <= s < hi)}
    busy_us = _union_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
        "torch": torch.__version__, "path": args.path, "pages": cs.N_PAGES,
        "batch": cs.BATCH,
        "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_events": len(intervals), 
        "cc_host_syncs": len(syncs) - swt_device.COUNTS["syncs"],
        "line_feature_host_syncs": swt_device.COUNTS["syncs"],
        "phase_wall_s": phase, "per_phase": per_phase,
        "port_kernels_ms": {family: sum(us for name, us in by_name.items()
                                        if family in name) / 1e3
                            for family in ("conv3x3", "separator_morphology")},
        "top_kernels_ms": [[name, us / 1e3] for name, us in top],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "top_kernels_ms"}))
    for name, ms in result["top_kernels_ms"]:
        print(f"  {ms:10.3f} ms  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
