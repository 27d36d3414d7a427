"""Merging t-digest: a mergeable quantile sketch (a copy of the
reference's ``quokka_tpu/ops/tdigest.py``, numpy only).

Per-channel digests merge exactly at the combine stage instead of
averaging per-channel quantiles, so multi-channel results do not depend on
how rows were partitioned.

Standard merging-digest construction (Dunning & Ertl): centroids kept sorted
by mean; a pass merges neighbors while the k1 scale function allows, giving
O(compression) centroids with fine resolution at the tails.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def _k1(q: float, compression: float) -> float:
    q = min(1.0, max(0.0, q))
    return compression / (2.0 * math.pi) * math.asin(2.0 * q - 1.0)


class TDigest:
    def __init__(self, compression: float = 200.0,
                 means: np.ndarray = None, weights: np.ndarray = None):
        self.compression = float(compression)
        self.means = np.zeros(0) if means is None else np.asarray(means, dtype=np.float64)
        self.weights = np.zeros(0) if weights is None else np.asarray(weights, dtype=np.float64)

    # -- building -------------------------------------------------------------
    def add(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.float64)
        v = v[~np.isnan(v)]
        if len(v) == 0:
            return
        cap = int(4 * self.compression)
        if len(v) > 2 * cap:
            # big chunks pre-bucket VECTORIZED (sort + reduceat over
            # equal-count slices) so the sequential merge loop in _compress
            # only ever sees O(compression) centroids, not O(rows)
            v = np.sort(v)
            edges = np.linspace(0, len(v), cap + 1).astype(np.int64)
            starts = edges[:-1]
            counts = np.diff(edges).astype(np.float64)
            sums = np.add.reduceat(v, starts)
            means = sums / counts
            self.means = np.concatenate([self.means, means])
            self.weights = np.concatenate([self.weights, counts])
        else:
            self.means = np.concatenate([self.means, v])
            self.weights = np.concatenate([self.weights, np.ones(len(v))])
        if len(self.means) > 8 * self.compression:
            self._compress()

    def merge(self, other: "TDigest") -> None:
        self.means = np.concatenate([self.means, other.means])
        self.weights = np.concatenate([self.weights, other.weights])
        self._compress()

    def _compress(self) -> None:
        if len(self.means) == 0:
            return
        order = np.argsort(self.means, kind="stable")
        m, w = self.means[order], self.weights[order]
        total = w.sum()
        out_m, out_w = [m[0]], [w[0]]
        w_before = 0.0
        k_lo = _k1(0.0, self.compression)
        for i in range(1, len(m)):
            q_up = (w_before + out_w[-1] + w[i]) / total
            if _k1(q_up, self.compression) - k_lo <= 1.0:
                # merge into the current centroid (weighted mean)
                nw = out_w[-1] + w[i]
                out_m[-1] += (m[i] - out_m[-1]) * (w[i] / nw)
                out_w[-1] = nw
            else:
                w_before += out_w[-1]
                k_lo = _k1(w_before / total, self.compression)
                out_m.append(m[i])
                out_w.append(w[i])
        self.means = np.asarray(out_m)
        self.weights = np.asarray(out_w)

    # -- querying -------------------------------------------------------------
    def quantile(self, q: float) -> float:
        self._compress()
        if len(self.means) == 0:
            return float("nan")
        if len(self.means) == 1:
            return float(self.means[0])
        w = self.weights
        total = w.sum()
        # centroid midpoints in cumulative-weight space
        cum = np.cumsum(w) - w / 2.0
        target = q * total
        if target <= cum[0]:
            return float(self.means[0])
        if target >= cum[-1]:
            return float(self.means[-1])
        i = np.searchsorted(cum, target) - 1
        frac = (target - cum[i]) / max(cum[i + 1] - cum[i], 1e-12)
        return float(self.means[i] + frac * (self.means[i + 1] - self.means[i]))

    # -- serialization (travels through the shuffle as two float columns) -----
    def to_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        self._compress()
        return self.means, self.weights

    @classmethod
    def from_arrays(cls, means, weights, compression: float = 200.0) -> "TDigest":
        return cls(compression, means, weights)
