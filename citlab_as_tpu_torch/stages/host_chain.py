"""Composite per-page host tail for worker fan-out (port copy of
``citlab_as_tpu/stages/host_chain.py``).

The pipelined workflow driver's host tail between the heading finish and
the GNN dispatch (baseline clustering, text regions, the GNN feature JSON)
is Python geometry and PAGE-XML on one page file at a time, and holds the
interpreter lock in the parent. With ``host_workers > 1`` it runs in
``utils/workers.py::PersistentPool``; this module is the picklable worker
side: one callable running the whole chain for one page, so each page is
parsed once per worker instead of once per stage.
"""
from __future__ import annotations

from typing import Callable, Optional


def host_chain_builder() -> Callable[[dict], Optional[str]]:
    """``fn_builder`` for :class:`citlab_as_tpu_torch.utils.workers.PersistentPool`.

    The returned callable takes one item dict::

        {"page_path": str, "image_path": str, "visual": bool,
         "line_features": {line_id: (bbox, sw, th)} | None}

    and returns the page's feature-JSON path (None when the feature stage
    skipped the page, e.g. too few text regions). An exception skips the
    page under the pool's log-and-skip contract."""
    from citlab_as_tpu_torch.pagexml.page import page_cache
    from citlab_as_tpu_torch.stages.baseline_clustering import cluster_page
    from citlab_as_tpu_torch.stages.features import generate_feature_jsons
    from citlab_as_tpu_torch.stages.textregion import generate_text_regions_for_page

    def run_chain(item: dict) -> Optional[str]:
        page_path = item["page_path"]
        lf = item.get("line_features")
        with page_cache():   # the three stages re-read the file each other wrote
            cluster_page(page_path)
            generate_text_regions_for_page(page_path)
            json_paths = generate_feature_jsons(
                [page_path], visual_regions=item.get("visual", False),
                separators="bb", image_paths=[item["image_path"]],
                line_features={page_path: lf} if lf is not None else None)
        return json_paths[0] if json_paths else None

    return run_chain
