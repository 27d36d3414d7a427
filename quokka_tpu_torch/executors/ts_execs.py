"""Time-series executors (port of ``quokka_tpu/executors/ts_execs.py``): the
streaming as-of join, tumbling / hopping / session / sliding windows and
shift.

Every executor assumes its channel receives a per-key time-ordered stream:
sorted sources deliver in global (seq, channel) order (the batch cache's
sorted plan, ``runtime/engine.py``) and the key hash exchange keeps each
key on one channel.  Executors keep only watermarks and the buffered tail
that later batches can still change; the per-batch work runs on the
batch's device.

Kernels of this module (each with its plain torch version beside it; the
wrappers take the plain version for CPU tensors only):

- K20a ``window_bounds`` (``csrc/window.cu``) replaces the reference's
  ``_bisect_left_segmented`` + ``_bisect_right_segmented``: every row's
  sliding-window bounds inside its key segment, in one pass;
- K20b ``range_minmax`` (``csrc/window.cu``) replaces ``_range_minmax``:
  min / max over each row's window, in two launches: per-chunk summaries,
  then tiles of rows answered from their span staged in shared memory.

``_rows_from_segment_end`` (a flip and a cummin), the session ids and the
rolling prefix sums are torch primitives (Queue 2 row 20, T); the segment
starts come from K19 (``ops/asof.seg_fill_forward``) and the watermarks
from ``kernels.reduce_array`` (row 9, T).

Times keep their native dtypes (int64, int32 days, float64), so window
arithmetic never leaves the column's type and the reference's int32
rebase of wide times is the identity here (``_TimeRebase``).  Checkpoint
and restore are not ported: fault tolerance raises in ``config.py``.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch

from quokka_tpu_torch.executors.base import Executor
from quokka_tpu_torch.obs import devprof, opstats
from quokka_tpu_torch.ops import asof as asof_ops
from quokka_tpu_torch.ops import bridge, kernels, native
from quokka_tpu_torch.ops import strategy as kstrategy
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, key_limbs, with_nulls
from quokka_tpu_torch.ops.expr_compile import AggPlan, evaluate_to_column
from quokka_tpu_torch.windows import (
    HoppingWindow,
    OnCompletionTrigger,
    SessionWindow,
    SlidingWindow,
    Trigger,
    TumblingWindow,
    Window,
)

# launches of the K20a and K20b CUDA kernels
WINDOW_BOUNDS_LAUNCHES = 0
RANGE_MINMAX_LAUNCHES = 0

_X_DT = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}


# ---------------------------------------------------------------------------
# watermarks
# ---------------------------------------------------------------------------


def _host_scalar(t: torch.Tensor):
    """A 0-d tensor read on the host: an exact int for integer dtypes, a
    float otherwise."""
    return float(t) if t.is_floating_point() else int(t)


def _time_max(batch: DeviceBatch, col: str):
    """Watermark: the max live time, read on the host (one sync)."""
    return _host_scalar(kernels.reduce_array(batch.columns[col].data, batch.valid, "max"))


def _time_min(batch: DeviceBatch, col: str, valid=None):
    """Min live time over ``valid`` (default batch.valid), on the host."""
    v = batch.valid if valid is None else valid
    return _host_scalar(kernels.reduce_array(batch.columns[col].data, v, "min"))


def _cmp_time(col: NumCol, v, op: str) -> torch.Tensor:
    """col <op> v for a host watermark v (int, float, or +/-inf)."""
    d = col.data
    if isinstance(v, float) and not math.isfinite(v):
        full = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
        hit = (v > 0) if op in ("<", "<=") else (v < 0)
        return full if hit else ~full
    if isinstance(v, float) and not d.is_floating_point():
        # compare in float64, as the reference's x64 promotion does
        v = torch.tensor(v, dtype=torch.float64, device=d.device)
    return {"<": d < v, "<=": d <= v, ">": d > v, ">=": d >= v,
            "=": d == v, "!=": d != v}[op]


class _TimeRebase:
    """The reference rebases wide and out-of-int32 times onto an int32 window
    relative to a host base, and restores emitted times with ``add_base``.
    The port keeps every time in its native dtype, so the base is 0 and the
    rebase is the identity; ``_restore_time`` gives emitted times the time
    column's kind and unit back, exactly."""

    _t_kind: Optional[str] = None
    _t_unit: Optional[str] = None

    def _rebase_batch(self, batch: DeviceBatch, col_name: str) -> DeviceBatch:
        if self._t_kind is None:
            col = batch.columns[col_name]
            self._t_kind, self._t_unit = col.kind, col.unit
        return batch

    def _restore_time(self, data: torch.Tensor, kind: str = "i") -> NumCol:
        return NumCol(data, self._t_kind or kind, self._t_unit)


# ---------------------------------------------------------------------------
# as-of join
# ---------------------------------------------------------------------------


class SortedAsofExecutor(Executor):
    """Streaming as-of join.  Stream 0 = left / trades, stream 1 = right /
    quotes.  Backward: trades are emitted once the quote watermark passes
    their time; the quote buffer is pruned past PRUNE_ROWS to the last quote
    per key below the frontier plus everything above it.  Forward: see
    ``_flush_forward``."""

    # large streams flush in chunks of at least this many ready trades
    MIN_FLUSH_ROWS = 1 << 19
    # prune the quote buffer only past this many rows: pruning sorts the
    # whole buffer, and keeping matched quotes is harmless for backward asof
    PRUNE_ROWS = 1 << 23
    # asof_probe="coalesced": mid-size streams hold ready trades until this
    # many accumulate (quotes arriving later sit at or above the watermark
    # that made them ready, so a later flush computes the same matches)
    COALESCE_ROWS = 1 << 15

    def __init__(self, left_on: str, right_on: str, left_by, right_by, suffix: str = "_2",
                 keep_unmatched: bool = False, direction: str = "backward"):
        if direction not in ("backward", "forward"):
            raise ValueError(direction)
        self.direction = direction
        self.left_on = left_on
        self.right_on = right_on
        self.left_by = list(left_by or [])
        self.right_by = list(right_by or [])
        self.suffix = suffix
        self.keep_unmatched = keep_unmatched
        self.trades: Optional[DeviceBatch] = None
        self.quotes: Optional[DeviceBatch] = None
        # incoming batches buffer in lists; the buffers concatenate only
        # when a flush runs a join.  Gates key on running live-row counts.
        self._t_parts: List[DeviceBatch] = []
        self._q_parts: List[DeviceBatch] = []
        self._t_rows = 0
        self._q_rows = 0
        self.q_watermark = None
        self.t_watermark = None
        self.q_done = False
        self.payload: Optional[List[str]] = None
        self.rename = {}
        # the renamed view of the quote buffer, one per buffer object, so the
        # searchsorted strategy's quote sort cached on it stays warm
        self._renamed_src: Optional[DeviceBatch] = None
        self._renamed: Optional[DeviceBatch] = None

    def _materialize_trades(self) -> None:
        if self._t_parts:
            parts = ([self.trades] if self.trades is not None else []) + self._t_parts
            self._t_parts = []
            self.trades = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]

    def _materialize_quotes(self) -> None:
        if self._q_parts:
            parts = ([self.quotes] if self.quotes is not None else []) + self._q_parts
            self._q_parts = []
            self.quotes = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]

    def execute(self, batches, stream_id, channel):
        live = [b for b in batches if b is not None and b.count_valid() > 0]
        if stream_id == 0:
            mode = kstrategy.choice("asof_probe")
            kstrategy.note_used("asof_probe", mode)
            if mode == "coalesced" and len(live) > 1:
                from quokka_tpu_torch.executors.sql_execs import _coalesce

                live = _coalesce(live)
        if stream_id == 1:
            for b in live:
                self._q_parts.append(b)
                self._q_rows += b.count_valid()
                wm = _time_max(b, self.right_on)
                if self.q_watermark is None or wm > self.q_watermark:
                    self.q_watermark = wm
            # the quote side is the as-of's build (counts already host-known)
            opstats.note(join_build_rows=sum(b.nrows for b in live))
            return self._flush()
        for b in live:
            self._t_parts.append(b)
            self._t_rows += b.count_valid()
            wm = _time_max(b, self.left_on)
            if self.t_watermark is None or wm > self.t_watermark:
                self.t_watermark = wm
        opstats.note(join_probe_rows=sum(
            b.nrows if b.nrows is not None else b.padded_len for b in live))
        return self._flush()

    def source_done(self, stream_id, channel):
        if stream_id == 1:
            self.q_done = True
            return self._flush()
        return None

    def done(self, channel):
        self.q_done = True
        return self._flush()

    def _setup_payload(self, probe_names):
        if self.payload is None:
            payload = [c for c in self.quotes.names
                       if c not in set(self.right_by) and c != self.right_on]
            self.rename = {c: c + self.suffix for c in payload if c in probe_names}
            self.payload = [self.rename.get(c, c) for c in payload]

    def _renamed_quotes(self) -> DeviceBatch:
        if not self.rename:
            return self.quotes
        if self._renamed_src is not self.quotes:
            self._renamed_src = self.quotes
            self._renamed = self.quotes.rename(self.rename)
        return self._renamed

    def _join(self, trades: DeviceBatch, direction: str) -> DeviceBatch:
        return asof_ops.asof_join(trades, self._renamed_quotes(), self.left_on, self.right_on,
                                  self.left_by, self.right_by, self.payload, direction)

    def _flush(self):
        self._materialize_trades()
        if self.trades is None or self.trades.count_valid() == 0:
            return None
        if self.quotes is None and not self._q_parts:
            if self.q_done:
                out, self.trades = self.trades, None
                return out if self.keep_unmatched else None
            return None
        if self.direction == "forward":
            self._materialize_quotes()
            return self._flush_forward()
        if self.q_done:
            safe = float("inf")
        elif self.q_watermark is None:
            return None
        else:
            safe = self.q_watermark
        tcol = self.trades.columns[self.left_on]
        # strictly below the quote watermark: a later quote batch may still
        # hold quotes at exactly `safe`, and a tie must win
        op = "<=" if safe == float("inf") else "<"
        ready_mask = self.trades.valid & _cmp_time(tcol, safe, op)
        nready = int(ready_mask.sum())
        if nready == 0:
            return None
        # each flush probes the whole quote buffer: large streams gather
        # ready trades into big flushes
        big = self._t_rows + self._q_rows > 4 * self.MIN_FLUSH_ROWS
        if big and not self.q_done and nready < self.MIN_FLUSH_ROWS:
            return None
        if (not self.q_done and nready < self.COALESCE_ROWS
                and self._t_rows + self._q_rows > 2 * self.COALESCE_ROWS
                and kstrategy.choice("asof_probe") == "coalesced"):
            return None
        self._materialize_quotes()
        ready = kernels.compact(kernels.apply_mask(self.trades, ready_mask))
        if ready.count_valid() == 0:
            return None
        rest = kernels.compact(kernels.apply_mask(self.trades, self.trades.valid & ~ready_mask))
        self.trades = rest if rest.count_valid() > 0 else None
        self._t_rows = 0 if self.trades is None else self.trades.count_valid()
        self._setup_payload(ready.names)
        out = self._join(ready, "backward")
        matched = out.columns.pop("__asof_matched__")
        if not self.keep_unmatched:
            out = kernels.apply_mask(out, matched.data)
        # prune only below what both streams have passed, and only past the
        # memory valve (the prune sorts the whole buffer)
        if self.quotes is not None and self._q_rows >= self.PRUNE_ROWS:
            prune_to = safe
            if self.t_watermark is not None:
                prune_to = min(prune_to, self.t_watermark)
            self._prune_quotes(prune_to)
            self._q_rows = 0 if self.quotes is None else self.quotes.count_valid()
        return out

    def _flush_forward(self):
        """Forward asof: a trade's match is the first quote of its key at or
        after its time.  A global watermark cannot tell that a key's match
        has arrived, so the whole buffer is joined and a matched trade is
        final (later quotes come later in time).  To keep the output in time
        order, matched trades wait until no earlier trade is unmatched."""
        self._setup_payload(self.trades.names)
        out = self._join(self.trades, "forward")
        matched = out.columns.pop("__asof_matched__").data
        if self.q_done:
            # every quote is in: each trade's match is final.  The buffer
            # stays for trades that arrive after the quote stream ended (the
            # reference drops it here, and with it those trades' matches)
            result = out if self.keep_unmatched else kernels.compact(
                kernels.apply_mask(out, matched))
            self.trades = None
        else:
            tcol = self.trades.columns[self.left_on]
            unmatched = self.trades.valid & ~matched
            emit = self.trades.valid & matched
            if bool(unmatched.any()):
                cutoff = _time_min(self.trades, self.left_on, unmatched)
                emit = emit & _cmp_time(tcol, cutoff, "<")
            result = kernels.compact(kernels.apply_mask(out, emit))
            rest = kernels.compact(kernels.apply_mask(self.trades, self.trades.valid & ~emit))
            self.trades = rest if rest.count_valid() > 0 else None
        self._t_rows = 0 if self.trades is None else self.trades.count_valid()
        # drop quotes below every kept and every later trade: a forward
        # match needs quote time >= trade time
        bound = self.t_watermark
        if self.trades is not None:
            tmin = _time_min(self.trades, self.left_on)
            bound = tmin if bound is None else min(bound, tmin)
        if bound is not None and self.quotes is not None:
            q = self.quotes
            keep = q.valid & _cmp_time(q.columns[self.right_on], bound, ">=")
            pruned = kernels.compact(kernels.apply_mask(q, keep))
            self.quotes = pruned if pruned.count_valid() > 0 else None
            self._q_rows = 0 if self.quotes is None else self.quotes.count_valid()
        return result if result.count_valid() > 0 else None

    def _prune_quotes(self, safe):
        """Drop quotes no later trade can match: everything at or below the
        frontier except the latest quote per key."""
        if self.quotes is None or safe == float("inf"):
            if self.q_done:
                self.quotes = None
            return
        q = self.quotes
        qt = q.columns[self.right_on]
        above = q.valid & _cmp_time(qt, safe, ">")
        below = q.valid & ~above
        if self.right_by:
            s = kernels.sort_batch(q, self.right_by + [self.right_on])
            st = s.columns[self.right_on]
            s_below = s.valid & _cmp_time(st, safe, "<=")
            n = s.padded_len
            next_key_same = torch.ones(n, dtype=torch.bool, device=s.device)
            for limb in key_limbs(s, self.right_by):
                next_key_same = next_key_same & (limb == torch.roll(limb, -1))
            next_key_same[n - 1] = False
            next_below = torch.roll(s_below, -1) & torch.roll(s.valid, -1)
            next_below[n - 1] = False
            # the last below-frontier quote of its key run: its successor is
            # another key, invalid, or above the frontier
            is_last_below = s_below & ~(next_key_same & next_below)
            keep_s = (s.valid & _cmp_time(st, safe, ">")) | is_last_below
            pruned = kernels.compact(kernels.apply_mask(s, keep_s))
        else:
            if bool(below.any()):
                maxt = _host_scalar(kernels.reduce_array(qt.data, below, "max"))
                keep = above | (below & _cmp_time(qt, maxt, "="))
            else:
                keep = above
            pruned = kernels.compact(kernels.apply_mask(q, keep))
        self.quotes = pruned if pruned.count_valid() > 0 else None


# ---------------------------------------------------------------------------
# window aggregation
# ---------------------------------------------------------------------------


def _evaluate_pre(plan: AggPlan, batch: DeviceBatch) -> DeviceBatch:
    for name, e in plan.pre:
        batch = batch.with_column(name, evaluate_to_column(e, batch))
    return batch


class _PartialWindowAgg:
    """Raw rows to partial-aggregate rows over (keys + window id), and the
    recombination of partial batches (the hash group-by, K3)."""

    def __init__(self, keys: Sequence[str], plan: AggPlan, wid_col: str = "__wid"):
        self.keys = list(keys)
        self.plan = plan
        self.wid_col = wid_col

    def partial(self, batch: DeviceBatch) -> DeviceBatch:
        b = _evaluate_pre(self.plan, batch)
        aggs = [(p, op, None if tmp is None else b.columns[tmp].data)
                for (p, op, tmp) in self.plan.partials]
        g = kernels.groupby_aggregate(b, self.keys + [self.wid_col], aggs)
        return kernels.compact(
            g.select(self.keys + [self.wid_col] + [p for p, _, _ in self.plan.partials]))

    def recombine(self, parts: List[DeviceBatch]) -> DeviceBatch:
        merged = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]
        aggs = [(p, op, merged.columns[p].data) for (p, op) in self.plan.recombine]
        g = kernels.groupby_aggregate(merged, self.keys + [self.wid_col], aggs)
        return kernels.compact(
            g.select(self.keys + [self.wid_col] + [p for p, _ in self.plan.recombine]))

    def finalize(self, g: DeviceBatch, extra: Sequence[str] = ()) -> DeviceBatch:
        for name, e in self.plan.finals:
            g = g.with_column(name, evaluate_to_column(e, g))
        cols = self.keys + list(extra) + [n for n, _ in self.plan.finals]
        return g.select(list(dict.fromkeys(cols)))


class HoppingWindowExecutor(_TimeRebase, Executor):
    """Hopping (and tumbling: hop == size) window aggregation.  Rows are
    replicated size // hop times onto the windows that cover them, partially
    aggregated, and windows are emitted once the watermark passes their end
    (OnEventTrigger) or all at done (OnCompletionTrigger)."""

    def __init__(self, time_col: str, keys: Sequence[str], window: Window, plan: AggPlan,
                 trigger: Optional[Trigger] = None):
        if isinstance(window, TumblingWindow):
            self.size, self.hop = window.size, window.size
        elif isinstance(window, HoppingWindow):
            self.size, self.hop = window.size, window.hop
        else:
            raise TypeError(f"expected Tumbling/HoppingWindow, got {type(window)}")
        self.time_col = time_col
        self.keys = list(keys)
        self.plan = plan
        self.emit_incremental = not isinstance(trigger, OnCompletionTrigger)
        self.helper = _PartialWindowAgg(self.keys, plan)
        self.state: Optional[DeviceBatch] = None

    def _assign_windows(self, batch: DeviceBatch) -> DeviceBatch:
        t = batch.columns[self.time_col].data
        base = torch.div(t, self.hop, rounding_mode="floor")
        if t.is_floating_point():
            base = base.to(torch.int64)
        reps = []
        for j in range(self.size // self.hop):
            wid = base - j
            start = wid * self.hop
            ok = (wid >= 0) & (t < start + self.size) & (t >= start)
            reps.append(kernels.apply_mask(batch.with_column("__wid", NumCol(wid, "i")), ok))
        return bridge.concat_batches(reps) if len(reps) > 1 else reps[0]

    def execute(self, batches, stream_id, channel):
        parts = []
        watermark = None
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            b = self._rebase_batch(b, self.time_col)
            watermark = _time_max(b, self.time_col)
            parts.append(self.helper.partial(self._assign_windows(b)))
        if self.state is not None:
            parts.append(self.state)
        if not parts:
            return None
        self.state = self.helper.recombine(parts)
        if not self.emit_incremental or watermark is None:
            return None
        # windows that end at or below the watermark receive no later row
        wid = self.state.columns["__wid"].data
        closed = self.state.valid & _cmp_time(NumCol(wid * self.hop + self.size), watermark,
                                              "<=")
        ready = kernels.compact(kernels.apply_mask(self.state, closed))
        if ready.count_valid() == 0:
            return None
        rest = kernels.compact(kernels.apply_mask(self.state, self.state.valid & ~closed))
        self.state = rest if rest.count_valid() > 0 else None
        return self._emit(ready)

    def _emit(self, g: DeviceBatch) -> DeviceBatch:
        start = g.columns["__wid"].data * self.hop
        g = g.with_column("window_start", self._restore_time(start))
        g = g.with_column("window_end", self._restore_time(start + self.size))
        return self.helper.finalize(g, extra=["window_start", "window_end"])

    def done(self, channel):
        if self.state is None:
            return None
        out, self.state = self._emit(self.state), None
        return out


TumblingWindowExecutor = HoppingWindowExecutor


class SessionWindowExecutor(_TimeRebase, Executor):
    """Gap-based session windows: a session closes when its key's gap
    exceeds the timeout; open sessions are carried as partial rows across
    batches.  Session ids are a cumsum over session starts (T)."""

    def __init__(self, time_col: str, keys: Sequence[str], window: SessionWindow,
                 plan: AggPlan):
        self.time_col = time_col
        self.keys = list(keys)
        self.timeout = window.timeout
        self.plan = plan
        self.open: Optional[DeviceBatch] = None  # partial rows of open sessions
        self.watermark = None

    def _to_partial_rows(self, batch: DeviceBatch) -> DeviceBatch:
        """Raw rows as partial-aggregate rows (count 1 etc.) with their first
        and last time."""
        b = _evaluate_pre(self.plan, batch)
        t = b.columns[self.time_col].data
        cols = {k: b.columns[k] for k in self.keys}
        for pname, op, tmp in self.plan.partials:
            cols[pname] = (NumCol(b.valid.to(torch.int32), "i") if op == "count"
                           else b.columns[tmp])
        cols["__first_t"] = NumCol(t, "i")
        cols["__last_t"] = NumCol(t, "i")
        return DeviceBatch(cols, b.valid, b.nrows, None, b.nrows_dev)

    def _sessionize(self, rows: DeviceBatch) -> DeviceBatch:
        """Session ids over key- and time-sorted partial rows, then combine."""
        s = kernels.sort_batch(rows, self.keys + ["__last_t"])
        n = s.padded_len
        iota = torch.arange(n, device=s.device)
        key_changed = torch.zeros(n, dtype=torch.bool, device=s.device)
        for limb in (key_limbs(s, self.keys) if self.keys else []):
            key_changed = key_changed | (limb != torch.roll(limb, 1))
        first_t = s.columns["__first_t"].data
        last_t = s.columns["__last_t"].data
        gap = first_t - torch.roll(last_t, 1)
        new_sess = (iota == 0) | key_changed | (gap > self.timeout)
        sess_id = torch.cumsum(new_sess.to(torch.int32), 0, dtype=torch.int32) - 1
        s = s.with_column("__sess", NumCol(sess_id, "i"))
        aggs = [(p, op, s.columns[p].data) for (p, op) in self.plan.recombine]
        aggs += [("__first_t", "min", first_t), ("__last_t", "max", last_t)]
        g = kernels.groupby_aggregate(s, self.keys + ["__sess"], aggs)
        return kernels.compact(g.select(self.keys + [p for p, _ in self.plan.recombine]
                                        + ["__first_t", "__last_t"]))

    def execute(self, batches, stream_id, channel):
        parts = []
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            b = self._rebase_batch(b, self.time_col)
            self.watermark = _time_max(b, self.time_col)
            parts.append(self._to_partial_rows(b))
        if self.open is not None:
            parts.append(self.open)
        if not parts:
            return None
        merged = bridge.concat_batches(parts) if len(parts) > 1 else parts[0]
        sessions = self._sessionize(merged)
        if self.watermark is None:
            self.open = sessions
            return None
        last = sessions.columns["__last_t"]
        closed = sessions.valid & _cmp_time(last, self.watermark - self.timeout, "<")
        ready = kernels.compact(kernels.apply_mask(sessions, closed))
        rest = kernels.compact(kernels.apply_mask(sessions, sessions.valid & ~closed))
        self.open = rest if rest.count_valid() > 0 else None
        if ready.count_valid() == 0:
            return None
        return self._emit(ready)

    def _emit(self, g: DeviceBatch) -> DeviceBatch:
        g = g.rename({"__first_t": "session_start", "__last_t": "session_end"})
        for c in ("session_start", "session_end"):
            g = g.with_column(c, self._restore_time(g.columns[c].data))
        helper = _PartialWindowAgg(self.keys, self.plan, wid_col="session_start")
        return helper.finalize(g, extra=["session_start", "session_end"])

    def done(self, channel):
        if self.open is None:
            return None
        out, self.open = self._emit(self.open), None
        return out


def _segments(s: DeviceBatch, keys: Sequence[str]):
    """(row ids int32, segment-start flags, each row's segment start) of a
    key-sorted batch; the starts come from K19.  The padding after the live
    rows is a segment of its own: the reference lets the last key's segment
    run on into padding rows of an equal key (every row, without keys), so
    its window searches and shift tails read them."""
    n = s.padded_len
    iota = torch.arange(n, dtype=torch.int32, device=s.device)
    key_changed = s.valid != torch.roll(s.valid, 1)
    for limb in (key_limbs(s, keys) if keys else []):
        key_changed = key_changed | (limb != torch.roll(limb, 1))
    flag = key_changed | (iota == 0)
    seg_start = asof_ops.seg_fill_forward(torch.where(flag, iota, torch.full_like(iota, -1)),
                                          flag)
    return iota, flag, seg_start


class SlidingWindowExecutor(_TimeRebase, Executor):
    """Per-event trailing windows [t - size, t]: sum / count / avg through
    prefix sums over each row's window bounds (K20a), min / max through
    K20b.  Each batch needs the previous batch's last `size` of time per
    key, kept as a tail and merged in with ``__new`` false: output rows come
    from new rows only."""

    def __init__(self, time_col: str, keys: Sequence[str], window: SlidingWindow,
                 plan: AggPlan):
        self.time_col = time_col
        self.keys = list(keys)
        self.size = window.size_before
        self.plan = plan
        for _, op, _ in plan.partials:
            if op not in ("sum", "count", "min", "max"):
                raise NotImplementedError(
                    f"sliding windows support sum/count/avg/min/max (got {op})")
        self.tail: Optional[DeviceBatch] = None

    def execute(self, batches, stream_id, channel):
        outs = []
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            out = self._process(b)
            if out is not None:
                outs.append(out)
        if not outs:
            return None
        return bridge.concat_batches(outs) if len(outs) > 1 else outs[0]

    def _process(self, batch: DeviceBatch) -> Optional[DeviceBatch]:
        b = _evaluate_pre(self.plan, self._rebase_batch(batch, self.time_col))
        b = b.with_column("__new", NumCol(torch.ones(b.padded_len, dtype=torch.bool,
                                                     device=b.device), "b"))
        if self.tail is not None:
            t0 = self.tail.with_column("__new", NumCol(torch.zeros(
                self.tail.padded_len, dtype=torch.bool, device=b.device), "b"))
            for c in b.names:
                col = b.columns[c]
                if c not in t0.columns and isinstance(col, NumCol):
                    t0 = t0.with_column(c, NumCol(torch.zeros(
                        t0.padded_len, dtype=col.data.dtype, device=b.device), col.kind))
            merged = bridge.concat_batches([t0.select(b.names), b])
        else:
            merged = b
        out = self._rolling(merged)
        # the next tail: rows within `size` of the max time
        wm = _time_max(b, self.time_col)
        tail_mask = merged.valid & _cmp_time(merged.columns[self.time_col], wm - self.size,
                                             ">=")
        tail = kernels.compact(kernels.apply_mask(merged, tail_mask))
        self.tail = (tail.select([c for c in tail.names if c != "__new"])
                     if tail.count_valid() > 0 else None)
        return out

    def _rolling(self, merged: DeviceBatch) -> Optional[DeviceBatch]:
        s = kernels.sort_batch(merged, self.keys + [self.time_col])
        n = s.padded_len
        iota, flag, seg_start = _segments(s, self.keys)
        t = s.columns[self.time_col].data
        seg_end = iota + _rows_from_segment_end(iota, flag, n)
        # each row's window inside its key segment: [first time >= t - size,
        # last time <= t]
        left, right = window_bounds(t, seg_start, seg_end, self.size)
        # a padding row's window is its own row: its results are never read,
        # and the padding's one wide window would cost K20b a long walk a row
        left, right = torch.where(s.valid, left, iota), torch.where(s.valid, right, iota)
        outs = {}
        for pname, op, tmp in self.plan.partials:
            if op in ("min", "max"):
                x = s.columns[tmp].data
                fill = kernels.max_sentinel(x.dtype) if op == "min" \
                    else kernels.min_sentinel(x.dtype)
                x = torch.where(s.valid, x, torch.full((), fill, dtype=x.dtype,
                                                       device=x.device))
                outs[pname] = range_minmax(x, left, right, op)
                continue
            if op == "count":
                x = s.valid.to(torch.float64)
            else:
                x = s.columns[tmp].data
                x = torch.where(s.valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
            cs = torch.cumsum(x, 0)
            lft = left.long()
            before = torch.where(lft > 0, cs[torch.clamp(lft - 1, min=0)],
                                 torch.zeros((), dtype=cs.dtype, device=cs.device))
            outs[pname] = cs[right.long()] - before
        g = s
        for pname, v in outs.items():
            g = g.with_column(pname, NumCol(v, "f"))
        for name, e in self.plan.finals:
            g = g.with_column(name, evaluate_to_column(e, g))
        only_new = kernels.apply_mask(g, g.valid & g.columns["__new"].data)
        keep = [c for c in merged.names if c != "__new" and not c.startswith("__pre")]
        keep += [nm for nm, _ in self.plan.finals if nm not in keep]
        keep = [c for c in keep if c in g.columns and not c.startswith("__agg")]
        return kernels.compact(only_new.select(keep))

    def done(self, channel):
        self.tail = None
        return None


class ShiftExecutor(Executor):
    """Per-key lag: the value of ``columns`` n rows earlier within the key
    (null where a row has fewer than n predecessors).  Keeps the last n rows
    per key as the next batch's carry."""

    def __init__(self, time_col: str, keys: Sequence[str], columns: Sequence[str], n: int):
        self.time_col = time_col
        self.keys = list(keys)
        self.columns = list(columns)
        self.n = n
        self.tail: Optional[DeviceBatch] = None

    def execute(self, batches, stream_id, channel):
        outs = []
        for b in batches:
            if b is None or b.count_valid() == 0:
                continue
            out = self._process(b)
            if out is not None:
                outs.append(out)
        if not outs:
            return None
        return bridge.concat_batches(outs) if len(outs) > 1 else outs[0]

    def _process(self, batch: DeviceBatch) -> Optional[DeviceBatch]:
        dev = batch.device
        b = batch.with_column("__new", NumCol(torch.ones(batch.padded_len, dtype=torch.bool,
                                                         device=dev), "b"))
        if self.tail is not None:
            t0 = self.tail.with_column("__new", NumCol(torch.zeros(
                self.tail.padded_len, dtype=torch.bool, device=dev), "b"))
            merged = bridge.concat_batches([t0.select(b.names), b])
        else:
            merged = b
        s = kernels.sort_batch(merged, self.keys + [self.time_col])
        rows = s.padded_len
        iota, flag, seg_start = _segments(s, self.keys)
        src = iota - self.n
        ok = src >= seg_start
        src = torch.clamp(src, 0, rows - 1).long()
        out = s
        for c in self.columns:
            # rows with under n predecessors in their key get null, for
            # every column kind
            taken = with_nulls(s.columns[c].take(src), ~ok)
            out = out.with_column(f"{c}_shifted_{self.n}", taken)
        # the last n rows per key carry over to the next batch
        tail_mask = s.valid & (_rows_from_segment_end(iota, flag, rows) < self.n)
        tail = kernels.compact(kernels.apply_mask(s, tail_mask))
        self.tail = tail.select(batch.names) if tail.count_valid() > 0 else None
        only_new = kernels.apply_mask(out, out.valid & out.columns["__new"].data)
        keep = [c for c in out.names if not c.startswith("__")]
        return kernels.compact(only_new.select(keep))


# ---------------------------------------------------------------------------
# segment arithmetic (T) and the window kernels K20a / K20b
# ---------------------------------------------------------------------------


def _rows_from_segment_end(iota: torch.Tensor, seg_start_flag: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Distance from each row to its segment's last row (0 = last): the
    segment ends one before the next start, found by a suffix min of the
    start rows (a flip and a cummin, T)."""
    starts_idx = torch.where(seg_start_flag, iota, torch.full_like(iota, n))
    suffix_min = torch.flip(torch.cummin(torch.flip(starts_idx, [0]), 0).values, [0])
    after = torch.cat([suffix_min[1:], torch.full((1,), n, dtype=iota.dtype,
                                                  device=iota.device)])
    return after - 1 - iota


def _window_bounds_plain(t: torch.Tensor, seg_start: torch.Tensor, seg_end: torch.Tensor,
                         size):
    """Plain version of K20a: the reference's two segmented binary searches
    of 32 lockstep steps each, with clamped gathers.  (left, right) int32."""
    n = t.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=t.device)
    lo_t = t - size
    lo, hi = seg_start.long(), iota
    for _ in range(32):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = t[torch.clamp(mid, 0, n - 1)] < lo_t
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    left = lo
    lo, hi = iota, seg_end.long()
    for _ in range(32):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        le = t[torch.clamp(mid, 0, n - 1)] <= t
        lo = torch.where(le, mid, lo)
        hi = torch.where(le, hi, mid - 1)
    return left.to(torch.int32), lo.to(torch.int32)


def _window_lib():
    lib = native.library("window")
    if not getattr(lib, "qk_bound", False):
        P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        lib.qk_window_bounds.argtypes = [P, I, P, P, L, L, D, P, P, P]
        lib.qk_window_bounds.restype = I
        lib.qk_range_minmax.argtypes = [P, I, L, P, P, I, P, P, P, P]
        lib.qk_range_minmax.restype = I
        for f in (lib.qk_range_scratch, lib.qk_range_tickets):
            f.argtypes, f.restype = [L], L
        lib.qk_bound = True
    return lib


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")


def _window_bounds_cuda(t, seg_start, seg_end, size):
    global WINDOW_BOUNDS_LAUNCHES
    _require_cuda(t, "window_bounds")
    lib = _window_lib()
    dev = t.device
    n = t.shape[0]
    for a in (seg_start, seg_end):
        if a.dtype != torch.int32 or a.device != dev or a.shape[0] != n:
            raise TypeError(f"window_bounds: segment bounds must be int32 of {n} rows on "
                            f"{dev}, got {a.dtype} {tuple(a.shape)} on {a.device}")
    # times run as int64 or float64 (exact widenings); a fractional size
    # makes the targets float64, as the reference's promotion does
    if t.is_floating_point() or float(size) != int(size):
        t, dt = t.to(torch.float64), 0
    else:
        t, dt = t.to(torch.int64), 2
    # held through the launch, as in _range_minmax_cuda
    t, seg_start, seg_end = t.contiguous(), seg_start.contiguous(), seg_end.contiguous()
    left = torch.empty(n, dtype=torch.int32, device=dev)
    right = torch.empty(n, dtype=torch.int32, device=dev)
    native.check(lib.qk_window_bounds(
        t.data_ptr(), dt, seg_start.data_ptr(),
        seg_end.data_ptr(), n, int(size) if dt == 2 else 0, float(size),
        left.data_ptr(), right.data_ptr(), native.stream_ptr(dev)), "qk_window_bounds")
    WINDOW_BOUNDS_LAUNCHES += 1
    return left, right


def window_bounds(t: torch.Tensor, seg_start: torch.Tensor, seg_end: torch.Tensor, size):
    """K20a: for rows sorted by (key, time) with each row's segment start and
    end, the first row of the segment with time >= t - size and the last
    with time <= t (int32 each).  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    n = t.shape[0]
    devprof.on_dispatch(("K20a", t.device.type, n, str(t.dtype)),
                        lambda: (0.0, float(n * (8 + 4 + 4 + 4 + 4)), float(8 * n)))
    if t.device.type == "cpu":
        return _window_bounds_plain(t, seg_start, seg_end, size)
    return _window_bounds_cuda(t, seg_start, seg_end, size)


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    k = torch.floor(torch.log2(v.to(torch.float64))).to(torch.int64)
    one = torch.ones_like(k)
    k = k - ((one << k) > v).to(torch.int64)
    return k + ((one << (k + 1)) <= v).to(torch.int64)


def _range_minmax_plain(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                        op: str) -> torch.Tensor:
    """Plain version of K20b, the reference's sparse table: level k holds
    the combine of 2^k rows from each row (past the end, the last row
    repeats); each row combines two overlapping power-of-two blocks."""
    combine = torch.minimum if op == "min" else torch.maximum
    n = x.shape[0]
    levels = [x]
    span = 1
    while span < n:
        prev = levels[-1]
        levels.append(combine(prev, torch.cat([prev[span:], prev[-1:].expand(span)])))
        span *= 2
    lft, rgt = left.long(), right.long()
    length = torch.clamp(rgt - lft + 1, min=1)
    k = torch.clamp(_floor_log2(length), 0, len(levels) - 1)
    table = torch.stack(levels)
    a = table[k, torch.clamp(lft, 0, n - 1)]
    b = table[k, torch.clamp(rgt - (torch.ones_like(k) << k) + 1, 0, n - 1)]
    return combine(a, b)


def _range_minmax_cuda(x, left, right, op: str):
    global RANGE_MINMAX_LAUNCHES
    _require_cuda(x, "range_minmax")
    lib = _window_lib()
    dev = x.device
    n = x.shape[0]
    if x.dtype not in _X_DT:
        raise TypeError(f"range_minmax: unsupported dtype {x.dtype}")
    for a in (left, right):
        if a.dtype != torch.int32 or a.device != dev or a.shape[0] != n:
            raise TypeError(f"range_minmax: bounds must be int32 of {n} rows on {dev}")
    # held through the launch: a contiguous copy freed before it could be
    # handed to the allocations below
    x, left, right = x.contiguous(), left.contiguous(), right.contiguous()
    # the summaries of 32, 1024 and 32768 rows, about n / 31 values
    # (csrc/window.cu)
    scratch = torch.empty(lib.qk_range_scratch(n), dtype=x.dtype, device=dev)
    out = torch.empty(n, dtype=x.dtype, device=dev)
    stream = native.stream_ptr(dev)
    native.check(lib.qk_range_minmax(
        x.data_ptr(), _X_DT[x.dtype], n, left.data_ptr(), right.data_ptr(),
        1 if op == "min" else 0, scratch.data_ptr(),
        native.tickets(dev, stream, lib.qk_range_tickets(n)).data_ptr(), out.data_ptr(), stream),
        "qk_range_minmax")
    RANGE_MINMAX_LAUNCHES += 1
    return out


def range_minmax(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                 op: str) -> torch.Tensor:
    """K20b: per row, the min or max of x over [left, right] (inclusive).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if op not in ("min", "max"):
        raise ValueError(op)
    n = x.shape[0]
    devprof.on_dispatch(("K20b", x.device.type, n, str(x.dtype), op),
                        lambda: (0.0, float(devprof.nbytes(x, left, right)
                                            + n * x.element_size()), float(n * x.element_size())))
    if x.device.type == "cpu":
        return _range_minmax_plain(x, left, right, op)
    return _range_minmax_cuda(x, left, right, op)
