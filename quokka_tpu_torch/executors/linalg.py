"""Numeric executors (port of ``quokka_tpu/executors/linalg.py``): gramian,
covariance and approximate quantiles.

``GramianExecutor`` runs K22 (``ops/linalg.gramian``) on every batch and
keeps the running float64 ``m^T m``, column sums and live count on the
device; each channel emits its RAW partials, and ``CombineGramianExecutor``
adds them and normalises once (per-channel covariances would add up to the
channel count times the true value).  The quantile executors are the
reference's host t-digest (``ops/tdigest.py``): each channel emits its
serialised digest and the combine stage merges them exactly, so the result
does not depend on how rows were partitioned.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from quokka_tpu_torch.executors.base import Executor
from quokka_tpu_torch.ops import bridge
from quokka_tpu_torch.ops import linalg as lops
from quokka_tpu_torch.ops.batch import DeviceBatch
from quokka_tpu_torch.ops.tdigest import TDigest


def _emit(columns: Dict[str, np.ndarray], device) -> DeviceBatch:
    return bridge.host_to_device(bridge.HostTable(columns), device)


class GramianExecutor(Executor):
    """Running ``m^T m`` (and column sums + count for covariance) over the
    given columns."""

    def __init__(self, columns: Sequence[str], covariance: bool = False):
        self.columns = list(columns)
        self.covariance = covariance
        self.gram: Optional[torch.Tensor] = None
        self.sums: Optional[torch.Tensor] = None
        self.count = 0
        self.device = None

    def execute(self, batches, stream_id, channel):
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            g, s = lops.gramian([b.columns[c].data for c in self.columns], b.valid)
            self.gram = g if self.gram is None else self.gram + g
            self.sums = s if self.sums is None else self.sums + s
            self.count += b.count_valid()
            self.device = b.device

    def done(self, channel):
        if self.gram is None:
            return None
        # RAW partials: the gram rows, a sums row and a count row
        mat = np.vstack([self.gram.cpu().numpy(), self.sums.cpu().numpy()[None, :],
                         np.zeros((1, len(self.columns)))])
        mat[-1, 0] = self.count
        cols = {"__row": np.array(self.columns + ["__sums__", "__count__"], dtype=object)}
        for j, c in enumerate(self.columns):
            cols[c] = mat[:, j]
        self.gram = self.sums = None
        return _emit(cols, self.device)


class CombineGramianExecutor(Executor):
    """Sum the channels' RAW gramian partials, then normalise once."""

    def __init__(self, columns: Sequence[str], covariance: bool = False):
        self.columns = list(columns)
        self.covariance = covariance
        self.parts: List[DeviceBatch] = []

    def execute(self, batches, stream_id, channel):
        self.parts.extend(b for b in batches if b is not None)

    def done(self, channel):
        if not self.parts:
            return None
        device = self.parts[0].device
        acc = None
        labels = self.columns + ["__sums__", "__count__"]
        for part in map(bridge.device_to_host, self.parts):
            where = {lab: i for i, lab in enumerate(part["__row"])}
            mat = np.stack([part[c][[where[lab] for lab in labels]] for c in self.columns], 1)
            acc = mat if acc is None else acc + mat
        self.parts = []
        d = len(self.columns)
        g = acc[:d]
        if self.covariance:
            count = float(acc[d + 1, 0])
            if count > 1:
                mu = acc[d] / count
                g = g / count - np.outer(mu, mu)
        cols = {"column": np.array(self.columns, dtype=object)}
        for j, c in enumerate(self.columns):
            cols[c] = np.ascontiguousarray(g[:, j])
        return _emit(cols, device)


class ReservoirQuantileExecutor(Executor):
    """Per-channel mergeable quantile sketch (merging t-digest): emits the
    serialised digest.  The name is the reference's."""

    def __init__(self, column: str, quantiles: Sequence[float], compression: float = 200.0):
        self.column = column
        self.quantiles = list(quantiles)
        self.digest = TDigest(compression)
        self.device = None

    def execute(self, batches, stream_id, channel):
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            x = b.columns[self.column].data[b.valid]
            self.digest.add(x.cpu().numpy().astype(np.float64))
            self.device = b.device

    def done(self, channel):
        means, weights = self.digest.to_arrays()
        if len(means) == 0:
            return None
        return _emit({"__td_mean": means, "__td_weight": weights}, self.device)


class CombineQuantileExecutor(Executor):
    """Merge the channels' t-digests exactly, then evaluate the quantiles on
    the combined sketch."""

    def __init__(self, column: str, quantiles: Sequence[float], compression: float = 200.0):
        self.column = column
        self.quantiles = list(quantiles)
        self.digest = TDigest(compression)
        self.device = None

    def execute(self, batches, stream_id, channel):
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            part = bridge.device_to_host(b)
            self.digest.merge(TDigest.from_arrays(part["__td_mean"], part["__td_weight"]))
            self.device = b.device

    def done(self, channel):
        if self.device is None:
            return None
        qs = [self.digest.quantile(q) for q in self.quantiles]
        return _emit({"quantile": np.array(self.quantiles, dtype=np.float64),
                      self.column: np.array(qs, dtype=np.float64)}, self.device)
