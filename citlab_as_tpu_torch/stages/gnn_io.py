"""GNN IO + inference/clustering driver (pipeline stage 4b; port of
``citlab_as_tpu/stages/gnn_io.py``).

Reference: gnn/io.py:69-163 (confidence JSON + clustering PAGE-XML writers)
and gnn/run_gnn_clustering.py:151-307 (per-page driver: confidences from the
relation net, optional separator/heading masking, clustering, write-out).
The file contracts (``confidences/<page>_confidences.json``,
``clustering/<info>/<page>_clustering.xml``) match the reference.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
from scipy.stats import gmean

from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.stages.clustering import TextblockClustering
from citlab_as_tpu_torch.stages.features import (
    is_aligned_heading_separated, is_aligned_horizontally_separated,
)
from citlab_as_tpu_torch.utils.io import (
    get_img_from_page_path, get_page_from_conf_path, get_page_from_json_path, load_image,
)

logger = logging.getLogger(__name__)


def save_conf_to_json(confidences: np.ndarray, page_path: str, save_dir: str,
                      symmetry_fn=gmean) -> str:
    """Symmetrized N x N confidences keyed by region ids (io.py:69-117)."""
    page = Page(page_path)
    text_regions = page.get_regions()["TextRegion"]
    assert len(confidences) == len(text_regions), (
        f"Confidences ({len(confidences)}) don't match text regions "
        f"({len(text_regions)}) in {page_path}.")

    if symmetry_fn:
        stacked = np.stack([confidences, confidences.T], axis=-1)
        confidences = symmetry_fn(stacked, axis=-1)

    conf_dict: Dict[str, Dict[str, str]] = {}
    for i, tr_i in enumerate(text_regions):
        conf_dict[tr_i.id] = {
            tr_j.id: str(confidences[i, j]) for j, tr_j in enumerate(text_regions)}

    save_name = os.path.splitext(os.path.basename(page_path))[0] + "_confidences.json"
    page_dir = re.sub(r"page$", "confidences", os.path.dirname(os.path.relpath(page_path)))
    out_dir = os.path.join(save_dir, page_dir)
    os.makedirs(out_dir, exist_ok=True)
    save_path = os.path.join(out_dir, save_name)
    with open(save_path, "w") as f:
        # dumps() uses the C encoder; dump() streams via Python iterencode
        f.write(json.dumps({"confidences": conf_dict}))
    logger.info("Saved confidences json '%s'", save_path)
    return save_path


def load_conf_from_json(conf_path: str) -> np.ndarray:
    """Inverse of :func:`save_conf_to_json`: N x N array in region order."""
    with open(conf_path) as f:
        conf_dict = json.load(f)["confidences"]
    ids = list(conf_dict.keys())
    n = len(ids)
    out = np.zeros((n, n), np.float64)
    for i, id_i in enumerate(ids):
        for j, id_j in enumerate(ids):
            out[i, j] = float(conf_dict[id_i][id_j])
    return out


def save_clustering_to_page(clustering: Sequence[int], page_path: str,
                            save_dir: str, info: str = "") -> str:
    """Write per-region article ids to ``clustering/<info>/<page>_clustering.xml``
    (io.py:120-163)."""
    page = Page(page_path)
    text_regions = page.get_regions()["TextRegion"]
    assert len(clustering) == len(text_regions), (
        f"Clustering ({len(clustering)}) doesn't match text regions "
        f"({len(text_regions)}) in {page_path}.")

    lines = []
    for index, text_region in enumerate(text_regions):
        for text_line in text_region.text_lines:
            text_line.set_article_id(f"a{clustering[index]}")
            lines.append(text_line)
    # the article id lives in each line's custom attr: write those directly
    # instead of rebuilding every region subtree (was ~half the GNN stage's
    # per-page host tail)
    page.set_textline_attr(lines)

    save_name = re.sub(r"\.xml$", "_clustering.xml", os.path.basename(page_path))
    page_dir = re.sub(r"page$", "clustering", os.path.dirname(os.path.relpath(page_path)))
    if page_dir.startswith(".."):
        # page tree lives outside the CWD: a CWD-relative path would climb
        # out of save_dir ("save/../../..."), so anchor at the page tree
        # itself (sibling clustering/ dir, the reference's usual layout)
        page_dir = re.sub(r"page$", "clustering",
                          os.path.dirname(os.path.abspath(page_path)))
        save_dir = ""
    out_dir = os.path.join(save_dir, page_dir, info) if info else os.path.join(save_dir, page_dir)
    os.makedirs(out_dir, exist_ok=True)
    save_path = os.path.join(out_dir, save_name)
    page.write_page_xml(save_path)
    logger.info("Saved clustering pageXML '%s'", save_path)
    return save_path


def mask_separated_confs(confs: np.ndarray, page_path: str,
                         mask_horizontally: bool = True,
                         mask_headings: bool = True) -> np.ndarray:
    """Zero out confidences between same-column regions split by a horizontal
    separator or a heading (run_gnn_clustering.py:151-186)."""
    page = Page(page_path)
    regions = page.get_regions()
    text_regions = regions.get("TextRegion", [])
    separator_regions = regions.get("SeparatorRegion")
    if mask_horizontally and not separator_regions:
        logger.warning("No separators found for confidence masking.")
        mask_horizontally = False

    masked = np.ones_like(confs)
    n = len(text_regions)
    for i in range(n):
        for j in range(i + 1, n):
            tr_i, tr_j = text_regions[i], text_regions[j]
            if mask_headings and is_aligned_heading_separated(tr_i, tr_j):
                masked[i, j] = masked[j, i] = 0
                continue
            if mask_horizontally and is_aligned_horizontally_separated(
                    tr_i, tr_j, separator_regions):
                masked[i, j] = masked[j, i] = 0
    return masked * confs


def gnn_clustering_for_page(json_path: str,
                            confidence_fn: Callable[[dict], np.ndarray],
                            clustering_method: str = "dbscan",
                            clustering_params: Optional[dict] = None,
                            save_conf: bool = False,
                            out_dir: str = "",
                            mask_horizontally_separated: bool = False,
                            mask_heading_separated: bool = False,
                            page_path: Optional[str] = None,
                            image_path: Optional[str] = None,
                            confidences: Optional[np.ndarray] = None
                            ) -> Optional[str]:
    """One page: graph JSON -> confidences -> (masking) -> clustering ->
    clustering PAGE-XML. ``confidence_fn(graph_json_dict) -> [N, N] array``
    wraps the relation net (or loaded confidences). When the predictor takes
    ``image_input`` (the visual 'v' nets) the page image (``image_path``,
    else the one beside the page) is loaded and passed along
    (run_gnn_clustering.py:223-279). ``confidences`` short-circuits the net
    forward with a precomputed matrix (the batched group path,
    :func:`gnn_clustering_for_pages`)."""
    with open(json_path) as f:
        graph = json.load(f)
    if page_path is None:
        page_path = get_page_from_json_path(json_path)

    if confidences is not None:
        confs = np.asarray(confidences, np.float64)
    elif getattr(confidence_fn, "image_input", False):
        img = load_image(image_path or get_img_from_page_path(page_path), mode="L")
        confs = np.asarray(confidence_fn(graph, image=np.asarray(img)), np.float64)
    else:
        confs = np.asarray(confidence_fn(graph), np.float64)
    n = int(graph["num_nodes"])
    confs = confs.reshape(n, n)

    if mask_horizontally_separated or mask_heading_separated:
        confs = mask_separated_confs(
            confs, page_path,
            mask_horizontally=mask_horizontally_separated,
            mask_headings=mask_heading_separated)

    if save_conf:
        save_conf_to_json(confs, page_path, out_dir)

    tb_clustering = TextblockClustering(clustering_params)
    tb_clustering.set_confs(confs)
    tb_clustering.calc(clustering_method)
    info = tb_clustering.get_info(clustering_method) or clustering_method
    return save_clustering_to_page(
        tb_clustering.tb_labels, page_path, out_dir, info=info)


def gnn_confidences_dispatch(json_paths: Sequence[str], predictor,
                             image_paths: Optional[Sequence[str]] = None):
    """Load a page group's graph JSONs (and, for a visual predictor, the
    page images: ``image_paths``, else the ones beside the pages) and queue
    ONE batched relation-net forward
    (inference.RelationPredictor.confidences_batch_device). Returns
    (graphs, materialize_fn) — ``materialize_fn()`` yields the per-page
    [n, n] confidence matrices. A predictor without that method (a plain
    per-page callable) is called page by page at materialize."""
    if not json_paths:        # whole group skipped by feature generation
        return [], (lambda: [])
    graphs = []
    for json_path in json_paths:
        with open(json_path) as f:
            graphs.append(json.load(f))
    images = None
    if getattr(predictor, "image_input", False):
        images = []
        for i, json_path in enumerate(json_paths):
            image_path = image_paths[i] if image_paths is not None else \
                get_img_from_page_path(get_page_from_json_path(json_path))
            images.append(np.asarray(load_image(image_path, mode="L")))
    if hasattr(predictor, "confidences_batch_device"):
        return graphs, predictor.confidences_batch_device(graphs, images)

    def materialize():      # plain per-page callables (test predictors)
        if images is not None:
            return [predictor(g, image=im) for g, im in zip(graphs, images)]
        return [predictor(g) for g in graphs]
    return graphs, materialize


def gnn_clustering_for_pages(json_paths: Sequence[str], predictor,
                             clustering_method: str = "dbscan",
                             clustering_params: Optional[dict] = None,
                             out_dir: str = "",
                             page_paths: Optional[Sequence[str]] = None,
                             image_paths: Optional[Sequence[str]] = None
                             ) -> List[Optional[str]]:
    """Batched group variant of :func:`gnn_clustering_for_page`: one device
    forward for the whole group, then per-page clustering + write-out."""
    _, materialize = gnn_confidences_dispatch(json_paths, predictor, image_paths)
    confs = materialize()
    out = []
    for i, json_path in enumerate(json_paths):
        out.append(gnn_clustering_for_page(
            json_path, predictor, clustering_method=clustering_method,
            clustering_params=clustering_params, out_dir=out_dir,
            page_path=page_paths[i] if page_paths is not None else None,
            image_path=image_paths[i] if image_paths is not None else None,
            confidences=confs[i]))
    return out


def conf_to_cluster(conf_paths: Sequence[str],
                    clustering_method: str = "greedy",
                    clustering_params: Optional[dict] = None,
                    out_dir: str = "") -> List[str]:
    """Re-cluster from saved confidence JSONs without the net
    (run_conf_to_cluster.py:26-62)."""
    out = []
    for conf_path in conf_paths:
        confs = load_conf_from_json(conf_path)
        page_path = get_page_from_conf_path(conf_path)
        tb_clustering = TextblockClustering(clustering_params)
        tb_clustering.set_confs(confs)
        tb_clustering.calc(clustering_method)
        info = tb_clustering.get_info(clustering_method) or clustering_method
        out.append(save_clustering_to_page(
            tb_clustering.tb_labels, page_path, out_dir, info=info))
    return out
