"""Baseline clustering stage (pipeline stage 2a): DBSCAN over baselines
(port of ``citlab_as_tpu/stages/baseline_clustering.py``).

Reference semantics: article_separation/baseline_clustering/
dbscan_baselines.py:14-333 and baseline_clustering.py:12-147. The O(N^2)
neighborhood rule is fully vectorized into one numpy pairwise computation at
construction (the reference's per-query Python loops / fresh-JVM-per-page
design become one in-process call); the DBSCAN grow loop itself is a cheap
host FIFO over the precomputed adjacency. The interline distances and the
normed bounding boxes come from the port's host C++ library
(``geometry/native.py``) in one call per page.

Neighborhood rule: each baseline's bbox is expanded vertically by
fac * interline_distance (distance clamped to [0.5, 1.5] * page average);
polygons are mutual neighbors when either expanded bbox covers >= 95% of the
other's plain bbox area.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

from citlab_as_tpu_torch.geometry import native
from citlab_as_tpu_torch.geometry.pairwise import calc_interline_distances
from citlab_as_tpu_torch.geometry.polygon import Polygon
from citlab_as_tpu_torch.pagexml import Page
from citlab_as_tpu_torch.utils.logging import setup_custom_logger

logger = setup_custom_logger(__name__)


_ILD_MEMO: "OrderedDict[tuple, List[float]]" = OrderedDict()


def get_list_of_interline_distances(lst_of_polygons: Sequence[Polygon],
                                    des_dist: int = 5, max_d: int = 500) -> List[float]:
    """Interline distance per baseline (normalizes internally,
    dbscan_baselines.py:35-110).

    Content-keyed memo: the textregion stage recomputes exactly the
    distances the baseline-clustering stage computed for the same page
    (same baselines, same parameters) one stage earlier."""
    key = (des_dist, max_d,
           tuple((tuple(p.x_points), tuple(p.y_points))
                 for p in lst_of_polygons))
    hit = _ILD_MEMO.get(key)
    if hit is not None:
        _ILD_MEMO.move_to_end(key)
        return list(hit)
    normed = native.norm_poly_dists(lst_of_polygons, des_dist)
    out = calc_interline_distances(normed, des_dist=des_dist, max_d=max_d)
    _ILD_MEMO[key] = list(out)
    while len(_ILD_MEMO) > 32:
        _ILD_MEMO.popitem(last=False)
    return out


def get_list_of_scaled_polygons(lst_of_polygons: Sequence[Polygon],
                                scaling_factor: float = 1.0) -> List[Polygon]:
    """Scale polygons with float -> int truncation (dbscan_baselines.py:14-32;
    truncation, not the half-up rounding used elsewhere)."""
    out = []
    for polygon in lst_of_polygons:
        xs = (scaling_factor * np.asarray(polygon.x_points)).astype(int)
        ys = (scaling_factor * np.asarray(polygon.y_points)).astype(int)
        out.append(Polygon.from_arrays(xs, ys))
    return out


def cluster_features_plain(polys: Sequence[Polygon], des_dist: int, max_d: float,
                           target_avg: float) -> Tuple[np.ndarray, np.ndarray]:
    """numpy version of ``geometry/native.py::cluster_features`` (the
    reference's list path, dbscan_baselines.py:113-177): normalize and
    measure, rescale the raw baselines (float -> int truncation) so the
    average positive interline distance hits ``target_avg``, then normalize
    and measure again. Returns (distances [N], normed bboxes [N, 4] as
    x, y, w, h)."""
    from citlab_as_tpu_torch.geometry.pairwise import min_perpendicular_distances
    from citlab_as_tpu_torch.geometry.polygon import norm_poly_dists

    normed = norm_poly_dists(list(polys), des_dist)
    distances = min_perpendicular_distances(normed, des_dist, max_d)
    positive = [d for d in distances if d > 0]
    if target_avg > 0 and positive:
        fac = target_avg / (sum(positive) / len(positive))
        scaled = [Polygon.from_arrays((fac * np.asarray(p.x_points)).astype(int),
                                      (fac * np.asarray(p.y_points)).astype(int))
                  for p in polys]
        normed = norm_poly_dists(scaled, des_dist)
        distances = min_perpendicular_distances(normed, des_dist, max_d)
    bboxes = np.empty((len(normed), 4), np.float64)
    for i, p in enumerate(normed):
        b = p.get_bounding_box()
        bboxes[i] = (b.x, b.y, b.width, b.height)
    return np.asarray(distances, np.float64), bboxes


class DBSCANBaselines:
    """DBSCAN over baselines (dbscan_baselines.py:113-333).

    Labels: 0 = unvisited, -1 = noise, clusters numbered from 1. With
    ``min_polygons_for_article == 1``, noise becomes singleton articles.
    """

    def __init__(self, list_of_polygons: Sequence[Polygon],
                 min_polygons_for_cluster: int = 2,
                 min_polygons_for_article: int = 1,
                 rectangle_interline_factor: float = 1.25,
                 des_dist: int = 5, max_d: int = 500,
                 target_average_interline_distance: int = 50):
        # fused pass: the whole normalize -> measure -> rescale -> re-normalize
        # -> re-measure chain in one C++ call; only the final distances and
        # normed bboxes (all the adjacency rule needs) come back
        distances, self._bboxes = native.cluster_features(
            list(list_of_polygons), des_dist, max_d,
            target_average_interline_distance)
        positive = [d for d in distances if d > 0]
        self.avg = sum(positive) / (len(positive) + 1e-8)
        n = len(distances)
        self.list_of_interline_distances = list(distances)

        self.fac = rectangle_interline_factor
        self.min_polygons_for_cluster = min_polygons_for_cluster
        self.min_polygons_for_article = min_polygons_for_article
        self._n = n
        self.list_of_labels = [0] * n
        self.list_if_center = [False] * n
        self._adjacency = self._build_adjacency()
        logger.info("Number of (detected) baselines contained by the image: %d", n)

    # ------------------------------------------------------------------
    def _build_adjacency(self) -> List[np.ndarray]:
        """Vectorized pairwise neighborhood matrix (region_query semantics,
        dbscan_baselines.py:255-307)."""
        n = self._n
        if n == 0:
            return []
        bx, by, bw, bh = (np.ascontiguousarray(self._bboxes[:, k])
                          for k in range(4))

        d = np.asarray(self.list_of_interline_distances, dtype=np.float64)
        clamped = np.where((d < 0.5 * self.avg) | (d > 1.5 * self.avg), self.avg, d)

        # expanded rects (int truncation as in the reference)
        ey = np.trunc(by - self.fac * clamped)
        eh = np.trunc(bh + 2 * self.fac * clamped)

        # intersection of expanded rect i with plain bbox j
        ix1 = np.maximum(bx[:, None], bx[None, :])
        ix2 = np.minimum((bx + bw)[:, None], (bx + bw)[None, :])
        iw = ix2 - ix1  # x extents are the same for expanded and plain rects

        iy1 = np.maximum(ey[:, None], by[None, :])
        iy2 = np.minimum((ey + eh)[:, None], (by + bh)[None, :])
        ih = iy2 - iy1

        inter_surface = np.where(
            (iw >= 0) & (ih >= 0), (iw + 1) * (ih + 1), 0.0)
        surface = (bh + 1) * (bw + 1)

        # covers[i, j]: expanded-i covers >= 95% of plain bbox j;
        # neighbors are symmetric: either direction suffices
        covers = inter_surface >= 0.95 * surface[None, :]
        neighbor = covers | covers.T
        np.fill_diagonal(neighbor, False)
        return [np.flatnonzero(neighbor[i]) for i in range(n)]

    def region_query(self, polygon_index: int) -> List[int]:
        return list(self._adjacency[polygon_index])

    # ------------------------------------------------------------------
    def clustering_polygons(self) -> None:
        """Classic DBSCAN outer loop (dbscan_baselines.py:179-203)."""
        label = 0
        for idx in range(self._n):
            if self.list_of_labels[idx] != 0:
                continue
            neighbors = self.region_query(idx)
            if len(neighbors) < self.min_polygons_for_cluster:
                self.list_of_labels[idx] = -1
            else:
                label += 1
                self.list_if_center[idx] = True
                self._grow_cluster(idx, neighbors, label)

    def _grow_cluster(self, polygon_index: int, neighbors: List[int], this_label: int) -> None:
        """FIFO growth (dbscan_baselines.py:205-253)."""
        self.list_of_labels[polygon_index] = this_label
        i = 0
        while i < len(neighbors):
            ni = neighbors[i]
            if self.list_of_labels[ni] == -1:
                self.list_of_labels[ni] = this_label
            elif self.list_of_labels[ni] == 0:
                self.list_of_labels[ni] = this_label
                next_neighbors = self.region_query(ni)
                if len(next_neighbors) >= self.min_polygons_for_cluster:
                    self.list_if_center[ni] = True
                    neighbors += next_neighbors
            i += 1

    def get_cluster_of_polygons(self) -> List[int]:
        """Final labels; noise -> singleton articles or merged into -1
        depending on min_polygons_for_article (dbscan_baselines.py:309-333)."""
        if self.min_polygons_for_article == 1:
            noise_id = max(self.list_of_labels, default=0) + 1
            for index, label in enumerate(self.list_of_labels):
                if label == -1:
                    self.list_of_labels[index] = noise_id
                    noise_id += 1
        else:
            counter = Counter(self.list_of_labels)
            for label, cnt in counter.items():
                if cnt < self.min_polygons_for_article and label != -1:
                    self.list_of_labels = [
                        -1 if x == label else x for x in self.list_of_labels]
        logger.info("Number of detected articles (incl. noise class): %d",
                    len(set(self.list_of_labels)))
        return self.list_of_labels


# ---------------------------------------------------------------- page level

def get_data_from_pagexml(path_to_pagexml: str) -> Tuple[List[Polygon], list]:
    """Baselines (>= 2 points) + their text lines (baseline_clustering.py:12-37)."""
    page_file = Page(path_to_pagexml)
    lst_of_polygons = []
    lst_of_txtlines = []
    for txtline in page_file.textlines:   # snapshot: shared across stages
        if txtline.baseline is None:
            continue
        baseline = txtline.baseline.to_polygon()
        if baseline.n_points > 1:
            lst_of_polygons.append(baseline)
            lst_of_txtlines.append(txtline)
    return lst_of_polygons, lst_of_txtlines


def save_results_in_pagexml(path_to_pagexml: str, list_of_txtlines, labels) -> None:
    """Write ``a<label>`` article ids in place (baseline_clustering.py:40-56)."""
    page_file = Page(path_to_pagexml)
    for txtline, label in zip(list_of_txtlines, labels):
        if label == -1:
            txtline.set_article_id(None)
        else:
            txtline.set_article_id(f"a{label}")
    page_file.set_textline_attr(list_of_txtlines)
    page_file.write_page_xml(path_to_pagexml)


def cluster_baselines_dbscan(list_of_polygons, min_polygons_for_cluster=2,
                             min_polygons_for_article=1,
                             rectangle_interline_factor=1.25, des_dist=5,
                             max_d=500, target_average_interline_distance=50) -> List[int]:
    cluster_object = DBSCANBaselines(
        list_of_polygons,
        min_polygons_for_cluster=min_polygons_for_cluster,
        min_polygons_for_article=min_polygons_for_article,
        rectangle_interline_factor=rectangle_interline_factor,
        des_dist=des_dist, max_d=max_d,
        target_average_interline_distance=target_average_interline_distance)
    cluster_object.clustering_polygons()
    return cluster_object.get_cluster_of_polygons()


def cluster_page(path_to_pagexml: str, **kwargs) -> List[int]:
    """Full per-page flow: read baselines, cluster, write article ids back."""
    polygons, txtlines = get_data_from_pagexml(path_to_pagexml)
    if not polygons:
        logger.warning("No baselines found in %s", path_to_pagexml)
        return []
    labels = cluster_baselines_dbscan(polygons, **kwargs)
    save_results_in_pagexml(path_to_pagexml, txtlines, labels)
    return labels
