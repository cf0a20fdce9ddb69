"""Text block clustering (pipeline stage 5): articles from the GNN
confidence matrix (port of ``citlab_as_tpu/stages/clustering.py``).

Reference: gnn/clustering/textblock_clustering.py:11-328 and dbscan.py:5-156.
Confidences are gmean-symmetrized; distances = -log(conf); greedy deltas =
log(p / (1 - p)). Methods:

- greedy: repeatedly merge the most positive delta edge, summing deltas;
- dbscan: relation DBSCAN (neighbor = conf > threshold) with the
  cluster-agreement gate (mean confidence to the current cluster);
- dbscan_std: DBSCAN on the precomputed distance matrix
  (:func:`dbscan_precomputed`, sklearn's algorithm in numpy);
- linkage: scipy hierarchical linkage with auto-threshold
  t = (mean + median)/2 of merge distances, or silhouette/elbow
  cluster-count selection (elbow via a compact Kneedle implementation —
  the reference depends on the kneed package).

The card's machine has no sklearn: ``sklearn.cluster.dbscan`` and
``sklearn.metrics.silhouette_score(metric="precomputed")`` are numpy
functions of the port's own here (:func:`dbscan_precomputed`,
:func:`silhouette_score_precomputed`), held equal to sklearn's by the tests.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional

import numpy as np
from scipy.cluster.hierarchy import cut_tree, fcluster, linkage
from scipy.stats import gmean

logger = logging.getLogger(__name__)

DEFAULT_CLUSTERING_PARAMS: Dict[str, object] = {
    # [dbscan]
    "min_neighbors_for_cluster": 1,
    "confidence_threshold": 0.5,
    "cluster_agreement_threshold": 0.5,
    "assign_noise_clusters": True,
    # [linkage]
    "method": "centroid",
    "criterion": "distance",
    "t": -1.0,
    "max_clusters": 100,
    # [greedy]
    "max_iteration": 1000,
    # [dbscan_std]
    "epsilon": 0.5,
    "min_samples": 1,
}


def dbscan_precomputed(dist: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """sklearn's ``dbscan(dist, metric="precomputed", eps, min_samples)``
    labels: neighbors of i are the j with dist[i, j] <= eps (i included),
    core points have at least ``min_samples`` neighbors, clusters grow from
    the core points in index order by a depth-first stack, border points
    take the first cluster that reaches them, the rest is noise (-1)."""
    dist = np.asarray(dist)
    n = dist.shape[0]
    neighborhoods = [np.flatnonzero(dist[i] <= eps) for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neighborhoods], bool)
    labels = np.full(n, -1, dtype=np.intp)
    label_num = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        stack = []
        while True:
            if labels[i] == -1:
                labels[i] = label_num
                if core[i]:
                    stack.extend(int(v) for v in neighborhoods[i] if labels[v] == -1)
            if not stack:
                break
            i = stack.pop()
        label_num += 1
    return labels


def silhouette_score_precomputed(dist: np.ndarray, labels) -> float:
    """sklearn's ``silhouette_score(dist, labels, metric="precomputed")``:
    mean over samples of (b - a) / max(a, b), a the mean distance to the
    own cluster's other members, b the least mean distance to another
    cluster, 0 for a sample alone in its cluster; per-cluster sums by
    ``np.bincount`` as sklearn sums them. Raises ``ValueError`` unless
    2 <= number of labels <= n_samples - 1."""
    dist = np.asarray(dist)
    _, labels = np.unique(np.asarray(labels), return_inverse=True)
    n = labels.shape[0]
    label_freqs = np.bincount(labels)
    n_labels = len(label_freqs)
    if not 1 < n_labels < n:
        raise ValueError("Number of labels is %d. Valid values are 2 to "
                         "n_samples - 1 (inclusive)" % n_labels)
    if np.any(np.abs(np.diagonal(dist)) > (np.finfo(dist.dtype).eps * 100
                                            if dist.dtype.kind == "f" else 0)):
        raise ValueError("The precomputed distance matrix contains non-zero "
                         "elements on the diagonal.")
    clust_dists = np.zeros((n, n_labels), dtype=dist.dtype)
    for i in range(n):
        clust_dists[i] += np.bincount(labels, weights=dist[i], minlength=n_labels)
    intra_index = (np.arange(n), labels)
    intra = clust_dists[intra_index]
    clust_dists[intra_index] = np.inf
    clust_dists /= label_freqs
    inter = clust_dists.min(axis=1)
    denom = (label_freqs - 1).take(labels, mode="clip")
    with np.errstate(divide="ignore", invalid="ignore"):
        intra = intra / denom
    sil = inter - intra
    with np.errstate(divide="ignore", invalid="ignore"):
        sil /= np.maximum(intra, inter)
    sil = np.nan_to_num(sil)
    return float(np.mean(sil))


def kneedle_elbow(x, y, curve: str = "convex", direction: str = "decreasing"):
    """Compact Kneedle (Satopaa et al.): normalize, transform to concave
    increasing, return x at the maximum of the difference curve."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 3 or y.max() == y.min():
        return None
    xn = (x - x.min()) / (x.max() - x.min())
    yn = (y - y.min()) / (y.max() - y.min())
    if curve == "convex":
        yn = 1.0 - yn
    if direction == "decreasing":
        # after the convex flip a decreasing curve is increasing; nothing to do
        pass
    diff = yn - xn
    idx = int(np.argmax(diff))
    if diff[idx] <= 0:
        return None
    return x[idx]


class DBScanRelation:
    """DBSCAN over the confidence graph with the cluster-agreement gate
    (dbscan.py:5-156). Labels: -1 noise, clusters from 1."""

    def __init__(self, min_neighbors_for_cluster=1, confidence_threshold=0.5,
                 cluster_agreement_threshold=0.5, weight_handling="avg",
                 assign_noise_clusters=True):
        assert weight_handling in ("avg", "min", "max")
        self.min_neighbors_for_cluster = min_neighbors_for_cluster
        self.confidence_threshold = confidence_threshold
        self.cluster_agreement_threshold = cluster_agreement_threshold
        self.weight_handling = weight_handling
        self.assign_noise_clusters = assign_noise_clusters
        self.num_nodes = None
        self.confidences = None
        self.labels = None

    def initialize_clustering(self, num_nodes, confidences):
        self.num_nodes = num_nodes
        conf = np.reshape(np.copy(confidences), [num_nodes, num_nodes])
        if not np.array_equal(conf, conf.T):
            if self.weight_handling == "avg":
                conf = (conf + conf.T) / 2
            elif self.weight_handling == "max":
                conf = np.maximum(conf, conf.T)
            else:
                conf = np.minimum(conf, conf.T)
        self.confidences = conf
        self.labels = [0] * num_nodes

    def cluster_relations(self, num_nodes, confidences) -> List[int]:
        self.initialize_clustering(num_nodes, confidences)
        label = 0
        for node_index in range(self.num_nodes):
            if self.labels[node_index] != 0:
                continue
            neighbors = self.region_query(node_index)
            if len(neighbors) < self.min_neighbors_for_cluster:
                self.labels[node_index] = -1
            else:
                label += 1
                self.grow_cluster(node_index, neighbors, label)
        if self.assign_noise_clusters:
            self.create_clusters_for_noise_nodes(label)
        return self.labels

    def grow_cluster(self, node_index, neighbor_nodes, label):
        self.labels[node_index] = label
        i = 0
        while i < len(neighbor_nodes):
            neighbor = neighbor_nodes[i]
            if self.labels[neighbor] == -1:
                if self.validate_cluster_agreement(neighbor, label):
                    self.labels[neighbor] = label
            elif self.labels[neighbor] == 0:
                if self.validate_cluster_agreement(neighbor, label):
                    self.labels[neighbor] = label
                    next_neighbors = self.region_query(neighbor)
                    if len(next_neighbors) >= self.min_neighbors_for_cluster:
                        neighbor_nodes += next_neighbors
            i += 1

    def region_query(self, node_index) -> List[int]:
        mask = self.confidences[node_index, :] > self.confidence_threshold
        neighbors = np.flatnonzero(mask).tolist()
        if node_index in neighbors:
            neighbors.remove(node_index)
        return neighbors

    def validate_cluster_agreement(self, node, label) -> bool:
        cluster_indices = [l == label for l in self.labels]
        agreement = float(np.mean(self.confidences[node, cluster_indices]))
        return agreement > self.cluster_agreement_threshold

    def create_clusters_for_noise_nodes(self, label):
        for index in range(len(self.labels)):
            if self.labels[index] == -1:
                label += 1
                self.labels[index] = label


class TextblockClustering:
    """Clustering driver over a page's confidence matrix."""

    def __init__(self, clustering_params: Optional[Dict] = None):
        self.clustering_params = dict(DEFAULT_CLUSTERING_PARAMS)
        if clustering_params:
            for key in clustering_params:
                if key not in self.clustering_params:
                    logging.critical(
                        "Given clustering_params-key '%s' is not used by "
                        "TextblockClustering!", key)
            self.clustering_params.update(clustering_params)

        self.tb_labels = None
        self.tb_classes = None
        self.num_classes = 0
        self.num_noise = 0
        self.rel_LLH = 0.0

        self._conf_mat = None
        self._mat_dim = None
        self._dist_mat = None
        self._cond_dists = None
        self._delta_mat = None
        self._dbscanner = None

    def get_info(self, method: str) -> Optional[str]:
        p = self.clustering_params
        if not hasattr(self, f"_{method}"):
            return None
        if method == "dbscan":
            return (f"dbscan_conf{p['confidence_threshold']}_"
                    f"cluster{p['cluster_agreement_threshold']}")
        if method == "dbscan_std":
            return f"dbscan_std_eps{p['epsilon']}_samples{p['min_samples']}"
        if method == "linkage":
            return f"linkage_{p['method']}_{p['criterion']}_t{p['t']}"
        if method == "greedy":
            return f"greedy_iter{p['max_iteration']}"
        return None

    # ------------------------------------------------------------------
    def set_confs(self, confs, symmetry_fn=gmean) -> None:
        self._conf_mat = np.array(confs, dtype=np.float64)
        self._mat_dim = self._conf_mat.shape[0]
        # avoid exact 0/1 (log / division blowups)
        min_val = np.nextafter(0, 1)
        max_val = np.nextafter(1, 0)
        self._conf_mat[self._conf_mat == 0.0] = min_val
        self._conf_mat[self._conf_mat == 1.0] = max_val
        if symmetry_fn:
            stacked = np.stack([self._conf_mat, self._conf_mat.T], axis=-1)
            self._conf_mat = symmetry_fn(stacked, axis=-1)
        self._dist_mat = -np.log(self._conf_mat)
        np.fill_diagonal(self._dist_mat, 0.0)
        self._cond_dists = self._dist_mat[np.triu_indices_from(self._dist_mat, k=1)]
        self._delta_mat = np.log(self._conf_mat / (1.0 - self._conf_mat))
        np.fill_diagonal(self._delta_mat, -math.inf)

    def calc(self, method: str) -> None:
        self.tb_labels = None
        self.tb_classes = None
        if self._mat_dim == 2:
            thr = self.clustering_params["confidence_threshold"]
            self.tb_labels = [1, 1] if self._conf_mat[0, 1] >= thr else [1, 2]
            self._labels2classes()
        else:
            fctn = getattr(self, f"_{method}", None)
            if fctn is None:
                raise NotImplementedError(f'Cannot find clustering method "_{method}"!')
            fctn()
        self._calc_relative_LLH()

    # ------------------------------------------------------------------
    def _labels2classes(self):
        class_dict: Dict[int, list] = {}
        for tb, cls in enumerate(self.tb_labels):
            class_dict.setdefault(cls, []).append(tb)
        self.tb_classes = list(map(sorted, class_dict.values()))

    def _classes2labels(self):
        self.tb_labels = np.full(self._mat_dim, -1, dtype=int)
        for idx, cls in enumerate(self.tb_classes):
            for tb in cls:
                self.tb_labels[tb] = idx

    def _calc_relative_LLH(self):
        self.rel_LLH = 0.0
        labels = self.tb_labels
        for idx0 in range(self._mat_dim):
            if labels[idx0] >= 0:
                for idx1 in range(idx0):
                    if labels[idx0] == labels[idx1]:
                        self.rel_LLH += (self._delta_mat[idx0, idx1]
                                         + self._delta_mat[idx1, idx0]) / 2

    # ------------------------------------------------------------------
    def _greedy(self):
        self.tb_labels = np.arange(self._mat_dim, dtype=int)
        self._labels2classes()
        calc = self._delta_mat.copy()
        iter_count = self.clustering_params["max_iteration"]
        while iter_count > 0:
            iter_count -= 1
            i, j = np.unravel_index(np.argmax(calc), calc.shape)
            if calc[i, j] <= 0:
                break
            # merge class j into class i, summing deltas
            self.tb_classes[i].extend(self.tb_classes[j])
            self.tb_classes[i] = sorted(self.tb_classes[i])
            self.tb_classes[j] = []
            for idx in range(self._mat_dim):
                if idx != i and idx != j:
                    calc[idx, i] += calc[idx, j]
                    calc[i, idx] = calc[idx, i]
            calc[:, j] = -math.inf
            calc[j, :] = -math.inf
            self._classes2labels()
        self.tb_classes = [cls for cls in self.tb_classes if cls]
        self.num_classes = len(self.tb_classes)
        self._classes2labels()
        self.num_noise = int(np.sum(self.tb_labels == -1))

    def _dbscan(self):
        if not self._dbscanner:
            p = self.clustering_params
            self._dbscanner = DBScanRelation(
                min_neighbors_for_cluster=p["min_neighbors_for_cluster"],
                confidence_threshold=p["confidence_threshold"],
                cluster_agreement_threshold=p["cluster_agreement_threshold"],
                assign_noise_clusters=p["assign_noise_clusters"])
        self.tb_labels = self._dbscanner.cluster_relations(self._mat_dim, self._conf_mat)
        self._labels2classes()
        self.num_classes = len(self.tb_classes)
        self.num_noise = len([l for l in self.tb_labels if l == -1])

    def _dbscan_std(self):
        self.tb_labels = dbscan_precomputed(
            self._dist_mat, eps=self.clustering_params["epsilon"],
            min_samples=self.clustering_params["min_samples"])
        self._labels2classes()
        self.num_classes = len(self.tb_classes)
        self.num_noise = len([l for l in self.tb_labels if l == -1])

    def _linkage(self):
        linkage_res = linkage(self._cond_dists, method=self.clustering_params["method"])
        if self.clustering_params["t"] == -1:
            dists = linkage_res[:, 2]
            t = (float(np.mean(dists)) + float(np.median(dists))) / 2
            self.tb_labels = fcluster(
                linkage_res, t=t, criterion=self.clustering_params["criterion"])
        else:
            _, labels = self._validate_clusters(linkage_res)
            self.tb_labels = labels
        self._labels2classes()
        self.num_classes = len(self.tb_classes)
        self.num_noise = len([l for l in self.tb_labels if l == -1])

    def _validate_clusters(self, linkage_res):
        """Cluster-count selection by silhouette score or elbow over merge
        distances (textblock_clustering.py:251-296)."""
        s_scores = []
        max_clusters = min(self._mat_dim, self.clustering_params["max_clusters"])
        tree = cut_tree(linkage_res)
        tree = np.transpose(tree[:, ::-1])[:max_clusters, :]
        labels_list = tree.tolist()
        for cluster_num, labels in enumerate(labels_list, start=1):
            if cluster_num == 1:
                cond = self._conf_mat[np.triu_indices_from(self._conf_mat, k=1)]
                if np.all(cond >= self.clustering_params["confidence_threshold"]):
                    return 1, labels_list[0]
                continue
            try:
                s = silhouette_score_precomputed(self._dist_mat, labels)
            except ValueError:
                s = 0.0
            s_scores.append(s)

        last_merges = linkage_res[-int(max_clusters):, 2]
        last_merges = np.concatenate(([0.0], last_merges), axis=-1)
        idxs = np.arange(1, len(last_merges) + 1, dtype=np.int32)
        elbow = kneedle_elbow(idxs, last_merges[::-1], "convex", "decreasing")
        cluster_by_elbow = {"merge": int(elbow) if elbow is not None else None}

        if self.clustering_params["t"] == "silhouette":
            num_clusters = int(np.argmax(s_scores)) + 2 if s_scores else 1
        else:
            num_clusters = cluster_by_elbow.get(self.clustering_params["t"])
            if num_clusters is None:
                logging.error(
                    "Clustering param t = %s has no validity index; defaulting "
                    "to 1 cluster", self.clustering_params["t"])
                num_clusters = 1
        return num_clusters, labels_list[num_clusters - 1]
