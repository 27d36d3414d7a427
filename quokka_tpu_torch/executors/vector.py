"""Vector search executors (port of ``quokka_tpu/executors/vector.py``):
streaming exact top-k cosine similarity, then a global reduce.

``NearestNeighborExecutor`` runs K21 (``ops/vector.sims_topk``) on every
batch: the batch's top k per query merge into a running ``[Q, k]`` state
that stays on the device, the same result as the reference's host merge.
After each batch it gathers, on the device, the payload of the state's
slots that came from that batch (at most ``Q * k`` rows), so only the
matched rows ever leave the card: the reference copies every batch's whole
payload to the host.  ``GlobalTopKReduceExecutor`` merges the channels'
top-k into the global top-k per query.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.executors.base import Executor
from quokka_tpu_torch.ops import bridge
from quokka_tpu_torch.ops import vector as vops
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, VecCol, gather_columns


def _take_rows(batch: DeviceBatch, idx: np.ndarray) -> DeviceBatch:
    """The rows ``idx`` of ``batch`` (live, in that order), padded to a
    bucket."""
    n = len(idx)
    padded = config.bucket_size(n)
    full = np.zeros(padded, dtype=np.int64)
    full[:n] = idx
    dev = batch.device
    return batch.take(torch.from_numpy(full).to(dev), torch.arange(padded, device=dev) < n, n)


class NearestNeighborExecutor(Executor):
    """Probe every batch's vectors against a fixed query matrix; keep the
    running top-k (by cosine similarity) per query.  Emits at done:
    (query_idx, score, <payload columns of the matched rows>)."""

    def __init__(self, queries, vec_col: str, k: int, payload: Optional[List[str]] = None):
        self.queries = vops.normalize_queries(queries)  # [Q, D] normalised, host
        self.vec_col = vec_col
        self.k = k
        self.payload = payload
        self.q: Optional[torch.Tensor] = None
        self.scores: Optional[torch.Tensor] = None  # [Q, k] float32
        self.handles: Optional[torch.Tensor] = None  # [Q, k] int64, -1 = empty
        # per probed batch: the payload at each [Q * k] slot that batch took
        self.parts: List[DeviceBatch] = []

    def execute(self, batches, stream_id, channel):
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            self._probe(b)

    def _probe(self, b: DeviceBatch) -> None:
        vec = b.columns[self.vec_col]
        if not isinstance(vec, VecCol):
            raise TypeError(f"{self.vec_col} is not a vector column")
        dev = b.device
        if self.q is None:
            self.q = torch.from_numpy(self.queries).to(dev)
            self.scores, self.handles = vops.empty_state(self.q.shape[0], self.k, dev)
        ordinal = len(self.parts)
        self.scores, h = vops.sims_topk(self.q, vec.data, b.valid, self.k, self.scores,
                                        self.handles, ordinal)
        # slots this batch took: gather their payload rows, then point the
        # handles at those slots
        mine = (h >> 32) == ordinal
        rows = torch.where(mine, h & 0xFFFFFFFF, torch.zeros_like(h)).reshape(-1)
        payload = self.payload or [c for c in b.names if c != self.vec_col]
        slots = h.numel()
        self.parts.append(DeviceBatch(gather_columns(b.select(payload).columns, rows),
                                      torch.ones(slots, dtype=torch.bool, device=dev), slots))
        at = torch.arange(slots, dtype=torch.int64, device=dev).reshape(h.shape)
        self.handles = torch.where(mine, (ordinal << 32) | at, h)

    def done(self, channel):
        if self.scores is None:
            return None
        scores = self.scores.cpu().numpy()
        handles = self.handles.cpu().numpy()
        alive = (handles >= 0) & (scores != -np.inf)
        qi, _ = np.nonzero(alive)
        if len(qi) == 0:
            return None
        h = handles[alive]
        part_of, slot = h >> 32, h & 0xFFFFFFFF
        # one gather per part that holds a match, then one permutation back
        # to (query, slot) order
        used = np.unique(part_of)
        pieces = [_take_rows(self.parts[int(p)], slot[part_of == p]) for p in used]
        order = np.argsort(part_of, kind="stable")
        inverse = np.empty(len(order), dtype=np.int64)
        inverse[order] = np.arange(len(order))
        gathered = bridge.concat_batches(pieces) if len(pieces) > 1 else pieces[0]
        out = _take_rows(gathered, inverse)
        dev = out.device
        n = len(qi)
        cols: Dict[str, object] = {
            "query_idx": NumCol(bridge.pad_tail(torch.from_numpy(qi.astype(np.int64)).to(dev),
                                                out.padded_len), "i"),
            "score": NumCol(bridge.pad_tail(torch.from_numpy(
                scores[alive].astype(np.float64)).to(dev), out.padded_len), "f"),
        }
        cols.update(out.columns)
        self.scores = self.handles = self.q = None
        self.parts = []
        return DeviceBatch(cols, out.valid, n)


class GlobalTopKReduceExecutor(Executor):
    """Second stage: merge per-partition (query_idx, score, payload) top-ks
    into the global top-k per query, ordered by query, then score
    (descending, NaN last), ties in arrival order: the reference's pandas
    sort and ``groupby(...).head(k)``."""

    def __init__(self, k: int):
        self.k = k
        self.parts: List[DeviceBatch] = []

    def execute(self, batches, stream_id, channel):
        self.parts.extend(b for b in batches if b is not None and b.count_valid() > 0)

    def done(self, channel):
        if not self.parts:
            return None
        merged = bridge.concat_batches(self.parts)
        self.parts = []
        live = merged.valid.cpu().numpy()
        qi = merged.columns["query_idx"].data.cpu().numpy()[live]
        score = merged.columns["score"].data.cpu().numpy()[live]
        nan = np.isnan(score)
        order = np.lexsort((-np.where(nan, 0.0, score), nan, qi))
        q_sorted = qi[order]
        starts = np.r_[0, np.flatnonzero(np.diff(q_sorted)) + 1]
        rank = np.arange(len(order)) - np.repeat(starts, np.diff(np.r_[starts, len(order)]))
        keep = order[rank < self.k]
        rows = np.flatnonzero(live)[keep]
        return _take_rows(merged, rows)
