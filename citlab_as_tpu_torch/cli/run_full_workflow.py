"""Full article-separation workflow driver (port of
``citlab_as_tpu/cli/run_full_workflow.py``: the sequential driver
``run_full_workflow`` and its CLI).

Runs the stages in sequence over an image list, preserving each stage's
file contract: separator detection -> heading detection -> baseline
clustering -> text region generation -> GNN features -> GNN clustering.
The nets run on ``device`` ("cuda" unless told "cpu"); models may be absent
(random-init predictors), which exercises the full path without trained
weights.

    python -m citlab_as_tpu_torch.cli.run_full_workflow \\
        --path_to_image_list images.lst \\
        --separator_model models_ckpt_torch/separator.npz \\
        --heading_model models_ckpt_torch/heading.npz \\
        --gnn_model models_ckpt_torch/gnn.npz --out_dir out [--device cpu]

Not ported yet (ROADMAP Queue 1): the pipelined driver (``--pipelined``,
item 10), the visual GNN (item 11), ``--data_parallel`` (item 13) and
``--host_workers`` (item 14).
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import torch

from citlab_as_tpu_torch.device import DeviceLike
from citlab_as_tpu_torch.utils.io import get_page_path, load_list_file

logger = logging.getLogger(__name__)


def _align_feature_jsons(json_paths, page_paths, image_paths):
    """generate_feature_jsons SKIPS pages without enough text regions, so
    its return list is not 1:1 with ``page_paths``. JSONs are named after
    the page file — match them back by basename and return aligned
    (json, page, image) triples for the pages that survived."""
    by_name = {os.path.splitext(os.path.basename(j))[0]: j
               for j in json_paths}
    out = []
    for pp, ip in zip(page_paths, image_paths):
        key = os.path.splitext(os.path.basename(pp))[0]
        if key in by_name:
            out.append((by_name[key], pp, ip))
    return out


def run_full_workflow(image_paths: Sequence[str],
                      separator_model_path: Optional[str] = None,
                      heading_model_path: Optional[str] = None,
                      gnn_model_path: Optional[str] = None,
                      clustering_method: str = "dbscan",
                      out_dir: str = "",
                      skip_heading: bool = False,
                      skip_gnn: bool = False,
                      timings: Optional[dict] = None,
                      separator_predictor=None,
                      heading_predictor=None,
                      gnn_predictor=None,
                      batch_size: int = 7,
                      separator_fixed_height: int = 1500,
                      heading_fixed_height: int = 900,
                      heading_device_swt: Optional[bool] = None,
                      fault_tolerant: bool = True,
                      clustering_params: Optional[dict] = None,
                      device: DeviceLike = "cuda") -> dict:
    """Returns {'pages', 'clustered', 'timings': {stage: seconds},
    'skipped'}. Predictors may be injected directly (tests / custom models;
    plain ``image_grey -> probabilities`` and ``graph -> [N, N]`` callables
    too); otherwise they are loaded from the given ``.npz`` files
    (random-init when None) onto ``device``, the ARU-Nets in bf16.
    ``heading_device_swt`` overrides the heading stage's device-SWT choice
    (None = on unless the device is the CPU). ``fault_tolerant=True``
    applies the reference's per-page log-and-skip contract; skips are
    returned under ``'skipped'``. ``clustering_params`` overrides the
    TextblockClustering method defaults (e.g. ``confidence_threshold``;
    run_gnn_clustering.py:69-72 double-parse equivalent)."""
    from citlab_as_tpu_torch.inference import SegmentationPredictor
    from citlab_as_tpu_torch.pagexml.page import page_cache
    from citlab_as_tpu_torch.stages.separator import SeparatorNetPostProcessor
    from citlab_as_tpu_torch.utils.faults import SkippedPages

    timings = timings if timings is not None else {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        timings[name] = timings.get(name, 0.0) + time.time() - t0
        logger.info("stage %s: %.2fs", name, timings[name])
        return out

    skipped = SkippedPages() if fault_tolerant else None

    # 1. separator detection (batched fused chain when multi-page)
    sep_predictor = separator_predictor or SegmentationPredictor(
        separator_model_path, dtype=torch.bfloat16, device=device)
    sep_proc = SeparatorNetPostProcessor(
        list(image_paths), sep_predictor, fixed_height=separator_fixed_height,
        device=None if hasattr(sep_predictor, "device") else device)
    if skipped is not None:
        sep_proc.on_page_error = skipped.record
    if len(image_paths) > 1 and hasattr(sep_predictor, "predict_batch"):
        timed("separator", lambda: sep_proc.run_batched(batch_size=batch_size))
    else:
        timed("separator", sep_proc.run)

    # The separator stage writes <page>.xml.xml; subsequent stages read those
    page_paths = [get_page_path(p) + ".xml" for p in image_paths]

    with page_cache():
        return _run_post_separator_stages(
            image_paths, page_paths, heading_model_path, gnn_model_path,
            clustering_method, out_dir, skip_heading, skip_gnn, timings,
            timed, heading_predictor, gnn_predictor, batch_size,
            heading_fixed_height, heading_device_swt, skipped,
            clustering_params, device)


def _run_post_separator_stages(image_paths, page_paths, heading_model_path,
                               gnn_model_path, clustering_method, out_dir,
                               skip_heading, skip_gnn, timings, timed,
                               heading_predictor, gnn_predictor, batch_size,
                               heading_fixed_height, heading_device_swt=None,
                               skipped=None, clustering_params=None,
                               device: DeviceLike = "cuda"):
    """Stages 2-5 of :func:`run_full_workflow`, run inside a page_cache()
    scope: each stage re-reads the page file the previous stage just wrote,
    so the scoped parse memo removes one DOM parse per stage per page
    (files are still written — the on-disk contract is unchanged).
    ``skipped`` (utils.faults.SkippedPages) applies the per-page
    log-and-skip contract; a page recorded by any stage drops out of every
    later stage."""
    from citlab_as_tpu_torch.inference import RelationPredictor, SegmentationPredictor
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
    from citlab_as_tpu_torch.stages.features import generate_feature_jsons
    from citlab_as_tpu_torch.stages.gnn_io import (
        gnn_clustering_for_page, gnn_confidences_dispatch)
    from citlab_as_tpu_torch.stages.heading import HeadingNetPostProcessor
    from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page

    all_page_paths = list(page_paths)

    def live_pairs():
        return [(pp, ip) for pp, ip in zip(all_page_paths, image_paths)
                if skipped is None or ip not in skipped]

    # 2. heading detection, chained onto the separator-stage output pages
    # (updated in place via page_paths + empty save_suffix); batched fused
    # device path with a SegmentationPredictor
    heading_line_features = None
    if not skip_heading:
        heading_predictor = heading_predictor or SegmentationPredictor(
            heading_model_path, dtype=torch.bfloat16, device=device)
        proc = HeadingNetPostProcessor(
            list(image_paths), heading_predictor,
            fixed_height=heading_fixed_height,
            page_paths=page_paths, save_suffix="")
        proc.use_device_swt = heading_device_swt
        if skipped is not None:
            proc.on_page_error = skipped.record
        timed("heading", lambda: proc.run_batched(batch_size=batch_size)
              if len(image_paths) > 1 else proc.run())
        heading_line_features = proc.line_features_by_page

    # 3. baseline clustering + 4. text regions
    def run_clustering():
        for pp, ip in live_pairs():
            if skipped is None:
                cluster_page(pp)
            else:
                skipped.guard(ip, "baseline_clustering",
                              lambda pp=pp: cluster_page(pp))
    timed("baseline_clustering", run_clustering)

    def run_regions():
        for pp, ip in live_pairs():
            if skipped is None:
                generate_text_regions_for_page(pp)
            else:
                skipped.guard(ip, "textregion",
                              lambda pp=pp: generate_text_regions_for_page(pp))
    timed("textregion", run_regions)

    clustered = []
    if not skip_gnn:
        # 5. GNN features + relation clustering
        gnn_predictor = gnn_predictor or RelationPredictor(gnn_model_path, device=device)
        pairs = live_pairs()
        json_paths = timed("features", lambda: generate_feature_jsons(
            [pp for pp, _ in pairs], visual_regions=False, separators="bb",
            image_paths=[ip for _, ip in pairs],
            line_features=heading_line_features))

        triples = _align_feature_jsons(json_paths, [pp for pp, _ in pairs],
                                       [ip for _, ip in pairs])

        def run_gnn():
            # ONE relation-net forward per page group (union-graph batching)
            # instead of a forward and readback per page; the clustering/write
            # guard is PER PAGE (one failing page must not mark its
            # chunk-mates skipped after their XML is written)
            for start in range(0, len(triples), batch_size):
                chunk = triples[start:start + batch_size]

                def dispatch(chunk=chunk):
                    _, materialize = gnn_confidences_dispatch(
                        [t[0] for t in chunk], gnn_predictor)
                    return materialize()
                if skipped is None:
                    confs = dispatch()
                else:
                    try:
                        confs = dispatch()
                    except Exception as e:  # noqa: BLE001 - skip contract
                        for _json, _pp, ip in chunk:
                            skipped.record(ip, "gnn_dispatch", e)
                        continue
                for i, (json_path, pp, ip) in enumerate(chunk):
                    def cluster_one(i=i, json_path=json_path, pp=pp, ip=ip):
                        clustered.append(gnn_clustering_for_page(
                            json_path, gnn_predictor,
                            clustering_method=clustering_method,
                            clustering_params=clustering_params,
                            out_dir=out_dir, page_path=pp,
                            confidences=confs[i]))
                    if skipped is None:
                        cluster_one()
                    else:
                        skipped.guard(ip, "gnn_clustering", cluster_one)
        timed("gnn_clustering", run_gnn)

    return {"pages": all_page_paths, "clustered": clustered,
            "timings": timings,
            "skipped": skipped.as_list() if skipped is not None else []}


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path_to_image_list", type=str, required=True)
    parser.add_argument("--separator_model", type=str, default=None,
                        help="converted separator ARU-Net (.npz)")
    parser.add_argument("--heading_model", type=str, default=None,
                        help="converted heading ARU-Net (.npz)")
    parser.add_argument("--gnn_model", type=str, default=None,
                        help="converted relation GNN (.npz)")
    parser.add_argument("--clustering_method", type=str, default="dbscan")
    parser.add_argument("--out_dir", type=str, default="")
    parser.add_argument("--skip_heading", action="store_true", default=False)
    parser.add_argument("--skip_gnn", action="store_true", default=False)
    parser.add_argument("--batch_size", type=int, default=7)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--clustering_params", type=str, default=None,
                        help="key=value[,key=value...] overrides for the "
                             "TextblockClustering method params, e.g. "
                             "confidence_threshold=0.6 (the reference's "
                             "clustering_params dict flag, "
                             "run_gnn_clustering.py:69-72)")
    args = parser.parse_args(argv)
    clustering_params = None
    if args.clustering_params:
        from citlab_as_tpu_torch.config.flags import parse_dict_flag
        clustering_params = parse_dict_flag(args.clustering_params)

    image_paths = load_list_file(args.path_to_image_list)
    result = run_full_workflow(
        image_paths, args.separator_model, args.heading_model, args.gnn_model,
        args.clustering_method, args.out_dir, args.skip_heading, args.skip_gnn,
        batch_size=args.batch_size, clustering_params=clustering_params,
        device=args.device)
    total = sum(result["timings"].values())
    logger.info("Workflow done: %d pages in %.2fs (%.2f pages/s)",
                len(image_paths), total, len(image_paths) / max(total, 1e-9))
    return result


if __name__ == "__main__":
    main()
