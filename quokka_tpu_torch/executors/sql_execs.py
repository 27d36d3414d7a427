"""Core relational executors (port of ``quokka_tpu/executors/sql_execs.py``).

The UDF, Storage, SelectingStorage, PartialAgg, FinalAgg, BuildProbeJoin,
BroadcastJoin and TopK executors.  Aggregation is decomposed partial -> hash
shuffle -> final, as in the reference.  Inner, semi and anti joins take the
PK path (``ops/join.hash_join_pk``) on unique builds and the general path
(``hash_join_general``) otherwise; every left join takes the general path,
as in the reference.  The join spill tier, join checkpoints, distinct and
sort come with later slices (ROADMAP Queue 1, "The rest of the DataStream/SQL
surface").
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.executors.base import Executor
from quokka_tpu_torch.obs import opstats
from quokka_tpu_torch.ops import bridge, fuse, kernels
from quokka_tpu_torch.ops import join as join_ops
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol
from quokka_tpu_torch.ops.expr_compile import (
    AggPlan,
    CompileError,
    evaluate_predicate,
    evaluate_to_column,
)


def _coalesce(live: List[DeviceBatch], cap_rows: int = 1 << 22) -> List[DeviceBatch]:
    """Concat a dispatch's ready batches into few batches, bounded by
    accumulated padded rows, so per-batch kernels run once over the whole."""
    if len(live) <= 1:
        return live
    groups: List[List[DeviceBatch]] = []
    cur: List[DeviceBatch] = []
    acc = 0
    for b in live:
        if cur and acc + b.padded_len > cap_rows:
            groups.append(cur)
            cur, acc = [], 0
        cur.append(b)
        acc += b.padded_len
    groups.append(cur)
    return [bridge.concat_batches(g) if len(g) > 1 else g[0] for g in groups]


class UDFExecutor(Executor):
    """Stateless per-batch transform."""

    def __init__(self, fn: Callable[[DeviceBatch], DeviceBatch]):
        self.fn = fn

    def execute(self, batches, stream_id, channel):
        out = [self.fn(b) for b in batches if b is not None]
        out = [b for b in out if b is not None]
        if not out:
            return None
        return bridge.concat_batches(out) if len(out) > 1 else out[0]


class StorageExecutor(Executor):
    """Pass live batches through (terminal collect node)."""

    def execute(self, batches, stream_id, channel):
        live = [b for b in batches if b is not None and b.count_valid() > 0]
        if not live:
            return None
        return bridge.concat_batches(live) if len(live) > 1 else live[0]


class SelectingStorageExecutor(StorageExecutor):
    """Terminal collect that also projects to the plan schema."""

    def __init__(self, schema: Sequence[str]):
        self.schema = list(schema)

    def execute(self, batches, stream_id, channel):
        out = StorageExecutor.execute(self, batches, stream_id, channel)
        if out is None:
            return None
        return out.select([c for c in self.schema if c in out.columns])


class PartialAggExecutor(Executor):
    """Per-channel partial group-by: folds per-batch partials (K2, or the
    general path) into one running partial batch every MERGE_EVERY batches
    through the hash group-by (K3); emits it at done.  Near-unique keys
    switch to PASSTHROUGH (rows in partial form, no grouping), decided on
    the first batch of more than 4096 rows, as the reference does."""

    MERGE_EVERY = 8
    PASSTHROUGH_RATIO = 0.7

    def __init__(self, keys: Sequence[str], plan: AggPlan):
        self.keys = list(keys)
        self.plan = plan
        self.state: Optional[DeviceBatch] = None
        self._buffer: List[DeviceBatch] = []
        self._passthrough: Optional[bool] = None
        self._fused = fuse.FusedPartialAgg(self.keys, plan)

    def _partial(self, batch: DeviceBatch) -> DeviceBatch:
        try:
            g = self._fused(batch)
        except CompileError:
            fuse.note_fallback(batch)
            b = batch
            for name, e in self.plan.pre:
                b = b.with_column(name, evaluate_to_column(e, b))
            aggs = [
                (p, op, None if tmp is None else b.columns[tmp].data)
                for (p, op, tmp) in self.plan.partials
            ]
            g = kernels.groupby_aggregate(b, self.keys, aggs)
        return g.select(self.keys + [p for p, _, _ in self.plan.partials])

    def _recombine(self, parts: List[DeviceBatch]) -> DeviceBatch:
        parts = [kernels.compact(p) for p in parts]
        merged = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]
        aggs = [(p, op, merged.columns[p].data) for (p, op) in self.plan.recombine]
        g = kernels.groupby_aggregate(merged, self.keys, aggs)
        return g.select(self.keys + [p for p, _ in self.plan.recombine])

    def _merge(self) -> None:
        if not self._buffer:
            return
        parts, self._buffer = self._buffer, []
        if self.state is not None:
            parts.append(self.state)
        self.state = self._recombine(parts)

    def _partial_form(self, batch: DeviceBatch) -> DeviceBatch:
        """Rows in partial form, ungrouped: the partial inputs come from the
        pre-expression kernel (K5) as on the grouped path."""
        try:
            call = self._fused.prepare_general(batch)
            pre = dict(zip(call.outs, call.run()))
        except CompileError:
            fuse.note_fallback(batch)
            pre = {name: evaluate_to_column(e, batch).data for name, e in self.plan.pre}
        cols = {k: batch.columns[k] for k in self.keys}
        for pname, op, tmp in self.plan.partials:
            if op == "count":
                cols[pname] = NumCol(batch.valid.to(torch.int32), "i")
            else:
                cols[pname] = NumCol(pre[tmp], "f" if pre[tmp].is_floating_point() else "i")
        return DeviceBatch(cols, batch.valid, batch.nrows, None, batch.nrows_dev)

    def execute(self, batches, stream_id, channel):
        outs = []
        live = [b for b in batches if b is not None]
        if not self._passthrough:
            live = _coalesce(live)
        for b in live:
            if self._passthrough:
                outs.append(self._partial_form(b))
                continue
            g = self._partial(b)
            if self._passthrough is None:
                rows = b.count_valid()
                if rows > 4096:
                    self._passthrough = g.count_valid() >= self.PASSTHROUGH_RATIO * rows
            self._buffer.append(g)
        if len(self._buffer) >= self.MERGE_EVERY:
            self._merge()
        if not outs:
            return None
        return bridge.concat_batches(outs) if len(outs) > 1 else outs[0]

    def done(self, channel):
        self._merge()
        out, self.state = self.state, None
        return None if out is None else kernels.compact_if_large(out)


class FinalAggExecutor(Executor):
    """Downstream of the key shuffle: recombines partials for its key range
    (K3), then evaluates the final expressions, HAVING, ORDER BY and LIMIT
    at done."""

    MERGE_EVERY = 32
    MERGE_ROWS = 1 << 21

    def __init__(self, keys: Sequence[str], plan: AggPlan, device, having=None,
                 order_by: Optional[List[Tuple[str, bool]]] = None,
                 limit: Optional[int] = None):
        self.keys = list(keys)
        self.plan = plan
        self.device = torch.device(device)
        self.having = having
        self.order_by = order_by
        self.limit = limit
        self.state: Optional[DeviceBatch] = None
        self._buffer: List[DeviceBatch] = []

    def _merge(self) -> None:
        if not self._buffer:
            return
        parts, self._buffer = self._buffer, []
        if self.state is not None:
            parts.append(self.state)
        parts = [kernels.compact(p) for p in parts]
        merged = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]
        aggs = [(p, op, merged.columns[p].data) for (p, op) in self.plan.recombine]
        g = kernels.groupby_aggregate(merged, self.keys, aggs)
        self.state = g.select(self.keys + [p for p, _ in self.plan.recombine])

    def execute(self, batches, stream_id, channel):
        self._buffer.extend(b for b in batches if b is not None)
        if (len(self._buffer) >= self.MERGE_EVERY
                or sum(p.padded_len for p in self._buffer) >= self.MERGE_ROWS):
            self._merge()
        return None

    def done(self, channel):
        self._merge()
        if self.state is not None:
            self.state = kernels.compact_if_large(self.state)
        if self.state is None:
            if self.keys:
                return None
            # SQL: a global aggregate over zero rows yields one row
            import numpy as np

            cols = {}
            for pname, op, _tmp in self.plan.partials:
                if op == "count":
                    cols[pname] = np.array([0], dtype=np.int64)
                elif op == "sum":
                    cols[pname] = np.array([0.0])
                else:
                    cols[pname] = np.array([np.nan])
            self.state = bridge.host_to_device(bridge.HostTable(cols), self.device)
        g = self.state
        for name, e in self.plan.finals:
            g = g.with_column(name, evaluate_to_column(e, g))
        if self.having is not None:
            g = kernels.compact(kernels.apply_mask(g, evaluate_predicate(self.having, g)))
        seen, cols = set(), []
        for c in self.keys + [n for n, _ in self.plan.finals]:
            if c not in seen:
                seen.add(c)
                cols.append(c)
        self.state = None
        g = g.select(cols)
        if self.order_by:
            names = [n for n, _ in self.order_by]
            desc = [d for _, d in self.order_by]
            if self.limit is not None:
                return kernels.top_k(g, names, self.limit, desc)
            return kernels.sort_batch(g, names, desc)
        if self.limit is not None:
            return kernels.head(g, self.limit)
        return g


class BuildProbeJoinExecutor(Executor):
    """Streamed hash join: stream 1 is the build side (buffered until its
    stage completes), stream 0 probes.  Stage scheduling runs the build
    before the first probe batch arrives; a probe batch that still comes
    first is buffered until the build stream's ``source_done``."""

    def __init__(self, left_on: Sequence[str], right_on: Sequence[str],
                 how: str = "inner", suffix: str = "_2",
                 rename: Optional[Dict[str, str]] = None,
                 out_schema: Optional[List[str]] = None):
        join_ops.require_join_how(how)
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.suffix = suffix
        # plan-time output schema: a left join emits all-null payloads from
        # it when the build source emitted no batch at all
        self.out_schema = list(out_schema) if out_schema else None
        # plan-time rename of clashing build columns; None -> detect at
        # runtime from the first probe batch
        self.planned_rename = rename
        self.build_parts: List[DeviceBatch] = []
        self.build: Optional[DeviceBatch] = None
        self.build_done = False
        self.probe_buffer: List[DeviceBatch] = []
        self.build_unique: Optional[bool] = None
        self.payload: Optional[List[str]] = None
        self.rename: Dict[str, str] = {}
        self._build_rows = 0

    def _finalize_build(self, probe_cols: List[str]) -> None:
        if not self.build_parts:
            self.build = None
            return
        b = (bridge.concat_batches(self.build_parts) if len(self.build_parts) > 1
             else self.build_parts[0])
        self.build_parts = []
        # payload = build columns minus its join keys; rename clashes
        payload = [c for c in b.names if c not in self.right_on]
        if self.planned_rename is not None:
            self.rename = {c: n for c, n in self.planned_rename.items() if c in payload}
        else:
            self.rename = {c: c + self.suffix for c in payload if c in probe_cols}
        if self.rename:
            b = b.rename(self.rename)
            payload = [self.rename.get(c, c) for c in payload]
        self.payload = payload
        self.build = b
        self.build_unique = join_ops.build_keys_unique(b, self.right_on)
        # EXPLAIN ANALYZE: the build's padded length (host-known, no read)
        opstats.note(join_build_rows=b.padded_len)

    def execute(self, batches, stream_id, channel):
        live = [b for b in batches if b is not None]
        if not live:
            return None
        if stream_id == 1:
            assert self.build is None, "build batch arrived after probing began"
            self.build_parts.extend(live)
            # padded length bounds the live rows for free; the real counts
            # are read only once the bound crosses the spill threshold
            self._build_rows += sum(b.padded_len for b in live)
            if self._build_rows > config.SPILL_JOIN_BUILD_ROWS:
                rows = sum(b.count_valid() for b in self.build_parts)
                if rows > config.SPILL_JOIN_BUILD_ROWS:
                    raise NotImplementedError(
                        f"join build of {rows} rows on one channel passes "
                        f"SPILL_JOIN_BUILD_ROWS ({config.SPILL_JOIN_BUILD_ROWS}); the "
                        "grace-join spill tier is not in quokka_tpu_torch yet: "
                        "ROADMAP Queue 1, \"The rest of the DataStream/SQL surface\"")
                self._build_rows = rows
            return None
        if not self.build_done:
            self.probe_buffer.extend(live)
            return None
        return self._probe(live)

    def source_done(self, stream_id, channel):
        if stream_id != 1 or self.build_done:
            return None
        self.build_done = True
        buffered, self.probe_buffer = self.probe_buffer, []
        if buffered:
            return self._probe(buffered)
        return None

    def _probe(self, live: List[DeviceBatch]) -> Optional[DeviceBatch]:
        if self.build is None and self.build_parts:
            self._finalize_build(live[0].names)
        opstats.note(join_probe_rows=sum(
            b.nrows if b.nrows is not None else b.padded_len for b in live))
        # the dispatch's whole ready set flows through one join call
        live = _coalesce(live)
        if self.build is None:
            # the build source emitted no batch at all, so the payload kinds
            # are unknown: a left join's payloads become all-null float columns
            if self.how in ("inner", "semi"):
                return None
            outs = live
            if self.how == "left":
                if self.out_schema is None:
                    raise RuntimeError("left join: the build side produced no batches "
                                       "and no plan schema was given (out_schema=)")
                outs = []
                for b in live:
                    for c in self.out_schema:
                        if c not in b.columns:
                            b = b.with_column(c, NumCol(torch.full(
                                (b.padded_len,), float("nan"), dtype=torch.float64,
                                device=b.device), "f"))
                    outs.append(b)
            return bridge.concat_batches(outs) if len(outs) > 1 else outs[0]
        if self.build.count_valid() == 0 and self.how in ("inner", "semi"):
            return None
        # an empty build with a schema falls through for anti and left joins:
        # the general join finds every probe row unmatched
        outs = []
        for probe in live:
            if self.build_unique and self.how in join_ops.PK_HOWS:
                out = join_ops.hash_join_pk(probe, self.build, self.left_on, self.right_on,
                                            self.how, self.payload)
            else:
                out = join_ops.hash_join_general(probe, self.build, self.left_on,
                                                 self.right_on, self.how, self.payload)
            outs.append(out)
        return bridge.concat_batches(outs) if len(outs) > 1 else outs[0]


class BroadcastJoinExecutor(BuildProbeJoinExecutor):
    """Small side broadcast to every channel: the device logic is the same;
    only the build edge's partitioner differs (Broadcast)."""


class TopKExecutor(Executor):
    """Running top-k by sort keys; the running state is never larger than k."""

    def __init__(self, by: List[str], k: int, descending: List[bool]):
        self.by = by
        self.k = k
        self.descending = descending
        self.state: Optional[DeviceBatch] = None

    def execute(self, batches, stream_id, channel):
        parts = [b for b in batches if b is not None]
        if self.state is not None:
            parts.append(self.state)
        if not parts:
            return None
        merged = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]
        self.state = kernels.top_k(merged, self.by, self.k, self.descending)
        return None

    def done(self, channel):
        out, self.state = self.state, None
        return out
