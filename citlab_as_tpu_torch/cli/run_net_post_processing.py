"""Separator / heading detection CLI (port of
``citlab_as_tpu/cli/run_net_post_processing.py``). Defaults: fixed_height
1500 (separator) / 900 (heading), threshold 0.05.

    python -m citlab_as_tpu_torch.cli.run_net_post_processing \\
        --path_to_image_list images.lst --mode separator \\
        --model models_ckpt_torch/separator.npz [--batch_size 4] [--device cpu]

Each image needs ``page/<name>.xml`` beside it; the stage writes
``page/<name>.xml.xml``. ``--batch_size N`` runs groups of N pages through
the fused device path of the stage (both modes); 0 runs page by page.
``--model_dir`` takes the JAX CLI's orbax model directory
(``models_ckpt/separator``; its newest step) or a ``.frozen`` artifact,
``--model`` a converted ``.npz`` or a ``.frozen``. ``--sharded`` runs the net over a mesh of every
CUDA device (``--device cpu``: the CPU): page by page each page is one
sharded batch; with ``--batch_size N`` each group of ``N * n_data`` pages
splits into per-device groups of N, each on its own device thread, so the
written files are those of the unsharded run.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from citlab_as_tpu_torch.cli.common import model_path
from citlab_as_tpu_torch.utils.io import load_list_file


def _mesh_for(device: str):
    """Every CUDA device, or one CPU shard for ``--device cpu``."""
    import torch
    from citlab_as_tpu_torch.parallel.mesh import make_mesh
    if torch.device(device).type == "cuda":
        return make_mesh()
    return make_mesh([device])


def _sharded_mesh(device: str):
    """The ``--sharded`` run's mesh, refused by name where it spans
    processes (a ``torch.distributed`` group is up): the stage drives every
    shard from this process."""
    from citlab_as_tpu_torch.parallel.mesh import one_process
    return one_process(_mesh_for(device), "run_net_post_processing --sharded")


def _run_sharded(procs, image_paths, batch_size, device_work, host_work):
    """The fused stage over a sharded predictor: each group of
    ``batch_size * len(procs)`` same-shape pages splits into consecutive
    per-shard groups of ``batch_size``; shard i's ``device_work(proc, images,
    chunk)`` runs on its own device thread, then ``host_work(proc, out,
    results)`` on this one, in page order."""
    from citlab_as_tpu_torch.cli.run_full_workflow import _DeviceThread
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    threads = [_DeviceThread([proc.predictor.device]) for proc in procs]
    results: dict = {}
    try:
        for images, chunk in SeparatorNetPostProcessor.group_by_shape(
                image_paths, image_paths, batch_size * len(procs)):
            futures = [(procs[i], threads[i].submit(
                device_work, procs[i], images[start:start + batch_size],
                chunk[start:start + batch_size]))
                for i, start in enumerate(range(0, len(images), batch_size))]
            for proc, future in futures:
                host_work(proc, future.result(), results)
    finally:
        for thread in threads:
            thread.close()
    return [results.get(p) for p in image_paths]


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_image_list", type=str, required=True,
                        help="List file holding the image paths.")
    parser.add_argument("--model", type=str, default=None,
                        help="converted ARU-Net (.npz) or a .frozen artifact; "
                             "none = random weights")
    parser.add_argument("--model_dir", type=str, default=None,
                        help="the JAX CLI's orbax model directory, or a .frozen artifact")
    parser.add_argument("--mode", type=str, required=True,
                        choices=["heading", "separator"])
    parser.add_argument("--fixed_height", type=int, default=None)
    parser.add_argument("--scaling_factor", type=float, default=1.0)
    parser.add_argument("--threshold", type=float, default=0.05,
                        help="Binarization threshold for the net output.")
    parser.add_argument("--text_line_percentage", type=float, default=0.8)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="batch pages through the net (0 = per page)")
    parser.add_argument("--sharded", action="store_true", default=False,
                        help="shard page batches over all devices "
                             "(data-parallel mesh inference)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    weights = model_path(args.model, args.model_dir)

    import torch
    from citlab_as_tpu_torch.inference import (
        SegmentationPredictor, ShardedSegmentationPredictor)

    image_paths = load_list_file(args.path_to_image_list)
    fixed_height = args.fixed_height
    if fixed_height is None:
        fixed_height = 900 if args.mode == "heading" else 1500
    if args.sharded:
        predictor = ShardedSegmentationPredictor(weights, mesh=_sharded_mesh(args.device),
                                                 dtype=torch.bfloat16)
    else:
        predictor = SegmentationPredictor(weights, dtype=torch.bfloat16,
                                          device=args.device)
    fused_sharded = args.sharded and args.batch_size > 0

    if args.mode == "separator":
        from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor

        def separator(pred, device=None):
            return SeparatorNetPostProcessor(
                image_paths, pred, fixed_height=fixed_height,
                scaling_factor=args.scaling_factor, threshold=args.threshold,
                device=device)
        if fused_sharded:
            return _run_sharded(
                [separator(p) for p in predictor.shards()], image_paths, args.batch_size,
                lambda proc, images, chunk: proc.fused_materialize(
                    proc.fused_dispatch(images, chunk)),
                lambda proc, entry, results: proc.fused_drain(entry, results))
        proc = separator(predictor, args.device)
        if args.batch_size > 0:
            return proc.run_batched_fused(args.batch_size)
        return proc.run()
    from citlab_as_tpu_torch.stages.heading import HeadingNetPostProcessor

    def heading(pred):
        return HeadingNetPostProcessor(
            image_paths, pred, fixed_height=fixed_height,
            scaling_factor=args.scaling_factor,
            threshold=0.4, text_line_percentage=args.text_line_percentage)
    if fused_sharded:
        return _run_sharded(
            [heading(p) for p in predictor.shards()], image_paths, args.batch_size,
            lambda proc, images, chunk: proc.fused_materialize(
                proc.fused_drain_dispatch(proc.fused_dispatch(images, chunk))),
            lambda proc, mat, results: proc.fused_finish(mat, results))
    proc = heading(predictor)
    if args.batch_size > 0:
        return proc.run_batched(args.batch_size)
    return proc.run()


if __name__ == "__main__":
    main()
