"""KMeans-based clustering with automatic cluster-count selection.

Reference semantics: clusterRoutines.py (ClusterEngine :16 —
score-based n_clusters selection :30-56, min-size/fraction outlier removal
:58, 2D-complex :237 and angular :304 variants). sklearn-backed like the
reference; import is gated so the core library works without it.

A copy of the JAX package's ``pydsproutines_tpu/estimation/cluster.py``,
which is numpy only: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import numpy as np


class ClusterEngine:
    """Scan n_clusters guesses, score each KMeans fit, keep removing
    undersized clusters until constraints pass (reference ClusterEngine)."""

    def __init__(self, guesses, min_cluster_size: int | None = None,
                 min_cluster_fraction: float | None = None,
                 scoretypes=("sil",)):
        self.guesses = list(guesses)
        self.min_cluster_size = min_cluster_size
        self.min_cluster_fraction = min_cluster_fraction
        self.scoretypes = list(scoretypes)
        self.scores = None

    def _cluster(self, x: np.ndarray) -> int:
        from sklearn.cluster import KMeans
        from sklearn import metrics

        self.scores = {key: np.zeros(len(self.guesses))
                       for key in self.scoretypes}
        for i, g in enumerate(self.guesses):
            model = KMeans(n_clusters=g, n_init=10).fit(x)
            if "sil" in self.scoretypes:
                self.scores["sil"][i] = metrics.silhouette_score(
                    x, model.labels_, metric="euclidean")
            if "ch" in self.scoretypes:
                self.scores["ch"][i] = metrics.calinski_harabasz_score(
                    x, model.labels_)
            if "db" in self.scoretypes:
                self.scores["db"][i] = metrics.davies_bouldin_score(
                    x, model.labels_)
        first = self.scoretypes[0]
        if first == "sil":
            sel = int(np.argmax(self.scores[first]))
        elif first == "db":
            sel = int(np.argmin(self.scores[first]))
        else:
            raise NotImplementedError(
                "Calinski-Harabasz maximisation not available (as reference).")
        return self.guesses[sel]

    def cluster(self, x: np.ndarray, verbose: bool = False):
        """Returns (best_guess, best_model, idx_removed, idx_used)
        (reference ClusterEngine.cluster, clusterRoutines.py:58)."""
        from sklearn.cluster import KMeans

        x = np.asarray(x)
        if x.ndim == 1:
            x = x.reshape(-1, 1)
        idx_used = np.arange(len(x))
        idx_removed: list[int] = []
        while True:
            best_guess = self._cluster(x[idx_used])
            best_model = KMeans(n_clusters=best_guess, n_init=10).fit(x[idx_used])
            labels = best_model.labels_
            unique = np.unique(labels)
            counts = np.array([(labels == u).sum() for u in unique])
            too_small = None
            if self.min_cluster_size is not None and np.any(
                    counts < self.min_cluster_size):
                too_small = int(np.argmin(counts))
            elif self.min_cluster_fraction is not None and np.any(
                    counts / len(labels) < self.min_cluster_fraction):
                too_small = int(np.argmin(counts))
            if too_small is None:
                return best_guess, best_model, np.asarray(idx_removed), idx_used
            remove = np.argwhere(labels == unique[too_small]).flatten()
            idx_removed.extend(idx_used[remove].tolist())
            idx_used = np.delete(idx_used, remove)

    def cluster_complex(self, x: np.ndarray, **kwargs):
        """Cluster complex points as (re, im) pairs (reference 2D-complex
        variant, clusterRoutines.py:237)."""
        x = np.asarray(x)
        xy = np.stack([x.real, x.imag], axis=1)
        return self.cluster(xy, **kwargs)

    def cluster_angular(self, x: np.ndarray, **kwargs):
        """Cluster unit-circle angles by embedding on the circle (reference
        angular variant, clusterRoutines.py:304)."""
        ang = np.asarray(x, dtype=np.float64)
        xy = np.stack([np.cos(ang), np.sin(ang)], axis=1)
        return self.cluster(xy, **kwargs)
