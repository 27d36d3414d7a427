"""Per-operator runtime statistics: the EXPLAIN ANALYZE plane's ledger
(port of ``quokka_tpu/obs/opstats.py``).

A per-(query, actor, channel) ledger fed from the engine's choke points
(``runtime/engine.py``):

- ``Engine.handle_input_task`` reports each scan batch (reader rows,
  post-predicate rows, bytes, padded length);
- ``Engine.handle_exec_task`` reports consumed batches and emitted rows per
  dispatch, and marks the *current operator* on its thread so executors can
  note domain figures (join build / probe rows) with ``note()``;
- ``Engine.push`` reports delivered rows per (source, target, channel) on
  every exchange edge: the per-channel histograms the skew report reads;
- ``Engine.dispatch_task`` reports seconds per completed dispatch, so
  operators carry a time share.

No device read on the push path: a host-known ``batch.nrows`` lands as an
int; a count the host does not know yet rides as a deferred value (the
batch's ``nrows_dev``) onto a pending list, resolved with ``int()`` at the
engine's flush cadence and at the final snapshot.

``on_query_gc`` (the engine's cleanup) persists the measured cardinalities
per plan fingerprint under ``QK_CARDPROFILE_DIR`` (atomic tmp + replace,
max-merged; a corrupt or foreign-fingerprint profile is ignored wholesale)
and hands the final snapshot to ``obs/devprof.py``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_PROFILE_VERSION = 1
_TOP_N = 5

# per-operator integer fields every record carries
_FIELDS = ("rows_in", "rows_out", "bytes_in", "bytes_out", "batches_in",
           "batches_out", "dispatches", "padded_in", "rows_unknown")


def skew_ratio_threshold() -> float:
    """``QK_SKEW_RATIO``: max/mean channel-row ratio above which an exchange
    edge is flagged skewed (default 2.0; must exceed 1.0)."""
    try:
        return max(1.0, float(os.environ.get("QK_SKEW_RATIO", 2.0)))
    except ValueError:
        return 2.0


# thread-local current-operator marker: the engine sets it around
# ``executor.execute`` so an executor can report domain figures (join
# build/probe rows) without threading its (query, actor, channel) identity
# through every call signature
_CUR = threading.local()


def note(**figures) -> None:
    """Executor-side annotation onto the current operator's record (no-op
    outside a dispatch, or for an unregistered query).  Values accumulate:
    ``note(join_build_rows=n)`` twice records the sum."""
    key = getattr(_CUR, "key", None)
    if key is not None:
        OPSTATS._note(key, figures)


def batch_nbytes(batch) -> int:
    """Device bytes of a batch: the validity mask and every column's data
    (string codes for a string column)."""
    total = batch.valid.nbytes
    for c in batch.columns.values():
        data = getattr(c, "data", None)
        if data is None:
            data = getattr(c, "codes", None)
        if data is not None:
            total += data.nbytes
    return total


class OpStats:
    """Process-wide operator-statistics ledger.  All mutation is under one
    lock (the per-call work is a few dict increments); device-count scalars
    go to a pending list and resolve to ints at flush/snapshot time."""

    def __init__(self):
        self._lock = threading.Lock()
        # query_id -> {"actors": {aid: {...}}, "plan_fp", "size_hint_bytes",
        #              "t0"} — a query records ONLY while registered here, so
        # a straggler report after on_query_gc can never resurrect state
        self._plans: Dict[str, dict] = {}
        # (query_id, actor, channel) -> {field: int}
        self._ops: Dict[Tuple[str, int, int], Dict[str, int]] = {}
        # (query_id, actor, channel) -> wall seconds across dispatches
        self._time: Dict[Tuple[str, int, int], float] = {}
        # (query_id, src_actor, tgt_actor) -> {tgt_channel: rows}
        self._edges: Dict[Tuple[str, int, int], Dict[int, int]] = {}
        # (query_id, actor, channel) -> executor-noted domain figures
        self._notes: Dict[Tuple[str, int, int], Dict[str, int]] = {}
        # deferred device counts: ("op", key, field, dev) / ("edge", key, dev)
        self._pending: List[tuple] = []
        # query_id -> per-query gauge names created (GC'd in on_query_gc)
        self._gauges: Dict[str, List[str]] = {}
        # query_id -> worst edge skew ratio seen; the global shuffle.skew
        # gauge is the max over LIVE queries (recomputed at GC so a
        # /health skew alert clears without a process restart)
        self._skew_worst: Dict[str, float] = {}
        # most recently finished query's snapshot (what bench reads after a
        # one-shot run's cleanup)
        self._last: Optional[dict] = None

    # -- plan registration ---------------------------------------------------
    def register_plan(self, graph, op_names: Optional[Dict[int, str]] = None
                      ) -> None:
        """Capture a query's topology host-side (actor kinds, channel
        counts, targets, reader size hints).  Idempotent; a graph without a
        query_id (distributed worker shard of a foreign query) records
        under its shipped id like any other."""
        qid = getattr(graph, "query_id", None)
        if qid is None:
            return
        with self._lock:
            plan = self._plans.get(qid)
            if plan is not None:
                if op_names:
                    for aid, name in op_names.items():
                        if aid in plan["actors"]:
                            plan["actors"][aid]["op"] = name
                return
            actors: Dict[int, dict] = {}
            hint_total = 0
            for aid, info in graph.actors.items():
                ent = {
                    "kind": info.kind,
                    "op": (op_names or {}).get(aid) or _actor_op_name(info),
                    "channels": int(getattr(info, "channels", 1) or 1),
                    "targets": sorted(getattr(info, "targets", {}) or {}),
                    "stage": int(getattr(info, "stage", 0) or 0),
                }
                if info.kind == "input":
                    with contextlib.suppress(Exception):
                        h = int(info.reader.size_hint() or 0)
                        if h > 0:
                            ent["size_hint_bytes"] = h
                            hint_total += h
                    sig = getattr(info, "src_sig", None)
                    if sig:
                        # plan-independent scan identity: cardprofile
                        # persistence keys this scan's measured figures
                        # under it (the reference's planner/cost.py reads them back)
                        ent["src_sig"] = sig
                actors[aid] = ent
            self._plans[qid] = {
                "actors": actors,
                "plan_fp": getattr(graph, "plan_fp", None),
                "size_hint_bytes": hint_total,
                "t0": time.time(),
                # plan-time decisions (planner/decide.py), attached to the
                # graph at lowering; runtime adaptations append here
                "planner": list(getattr(graph, "planner_decisions", None)
                                or []),
            }

    def note_adaptation(self, qid: Optional[str], rec: dict) -> None:
        """Engine-side: append a runtime re-optimization record (skew
        trigger fired, exchange re-routed) to the query's planner-decision
        log so explain() shows plan-time choices and runtime adaptations in
        one section.  No-op for an unregistered query."""
        if qid is None:
            return
        with self._lock:
            plan = self._plans.get(qid)
            if plan is None:
                return
            plan.setdefault("planner", []).append(dict(rec))

    # -- hot-path recording (engine choke points) ----------------------------
    def _rec(self, key: Tuple[str, int, int]) -> Dict[str, int]:
        r = self._ops.get(key)
        if r is None:
            r = self._ops[key] = dict.fromkeys(_FIELDS, 0)
        return r

    def _add_rows(self, key, field: str, rows) -> None:
        """caller holds the lock.  rows: int (host-known), device scalar
        (deferred), or None (unknown without a sync: counted, never synced)."""
        if rows is None:
            self._rec(key)["rows_unknown"] += 1
        elif isinstance(rows, int):
            self._rec(key)[field] += rows
        else:
            self._pending.append(("op", key, field, rows))

    def scan(self, qid: Optional[str], actor: int, channel: int,
             rows_raw, rows_out, nbytes: int, padded: int) -> None:
        """One source batch: ``rows_raw`` pre-predicate (what the reader
        produced — reconciles against the source's own row count),
        ``rows_out`` post-predicate (what entered the pipeline)."""
        if qid is None:
            return
        with self._lock:
            if qid not in self._plans:
                return
            key = (qid, actor, channel)
            r = self._rec(key)
            r["dispatches"] += 1
            r["batches_in"] += 1
            r["batches_out"] += 1
            r["bytes_in"] += int(nbytes)
            r["bytes_out"] += int(nbytes)
            r["padded_in"] += int(padded)
            self._add_rows(key, "rows_in", rows_raw)
            self._add_rows(key, "rows_out", rows_out)

    def exec_in(self, qid: Optional[str], actor: int, channel: int,
                batches) -> None:
        """Batches a dispatch is about to consume (host-side metadata only)."""
        if qid is None:
            return
        rows_int = 0
        devs = []
        nbytes = 0
        padded = 0
        unknown = 0
        for b in batches:
            if b.nrows is not None:
                rows_int += b.nrows
            elif b.nrows_dev is not None:
                devs.append(b.nrows_dev)
            else:
                unknown += 1
            nbytes += batch_nbytes(b)
            padded += b.padded_len
        with self._lock:
            if qid not in self._plans:
                return
            key = (qid, actor, channel)
            r = self._rec(key)
            r["dispatches"] += 1
            r["batches_in"] += len(batches)
            r["bytes_in"] += nbytes
            r["padded_in"] += padded
            r["rows_in"] += rows_int
            r["rows_unknown"] += unknown
            for dev in devs:
                self._pending.append(("op", key, "rows_in", dev))

    def exec_out(self, qid: Optional[str], actor: int, channel: int,
                 rows_out) -> None:
        """Rows a dispatch emitted (int, device scalar, or 0 for no-emit)."""
        if qid is None:
            return
        with self._lock:
            if qid not in self._plans:
                return
            key = (qid, actor, channel)
            if not (isinstance(rows_out, int) and rows_out == 0):
                self._rec(key)["batches_out"] += 1
            self._add_rows(key, "rows_out", rows_out)

    def edge(self, qid: Optional[str], src: int, tgt: int, tgt_ch: int,
             rows) -> None:
        """Rows delivered on an exchange edge's target channel — the
        per-channel histogram the skew report is computed from."""
        if qid is None or rows is None:
            return
        with self._lock:
            if qid not in self._plans:
                return
            if isinstance(rows, int):
                d = self._edges.setdefault((qid, src, tgt), {})
                d[tgt_ch] = d.get(tgt_ch, 0) + rows
            else:
                self._pending.append(("edge", (qid, src, tgt, tgt_ch), rows))

    def dispatch_time(self, qid: Optional[str], actor: int, channel: int,
                      dur_s: float) -> None:
        if qid is None:
            return
        with self._lock:
            if qid not in self._plans:
                return
            key = (qid, actor, channel)
            self._time[key] = self._time.get(key, 0.0) + float(dur_s)

    def _note(self, key: Tuple[str, int, int], figures: Dict[str, int]
              ) -> None:
        with self._lock:
            if key[0] not in self._plans:
                return
            d = self._notes.setdefault(key, {})
            for name, v in figures.items():
                with contextlib.suppress(TypeError, ValueError):
                    d[name] = d.get(name, 0) + int(v)

    @contextlib.contextmanager
    def current_op(self, qid: Optional[str], actor: int, channel: int):
        """Engine-side: marks the operator executing on this thread so
        ``note()`` calls from inside the executor attribute correctly."""
        if qid is None:
            yield
            return
        prev = getattr(_CUR, "key", None)
        _CUR.key = (qid, actor, channel)
        try:
            yield
        finally:
            _CUR.key = prev

    # -- deferred device-count resolution ------------------------------------
    def resolve_pending(self) -> None:
        """Turn queued deferred counts into ints and fold them in.  The
        device scalars among them are read in ONE batched copy (counted on
        ``opstats.count_reads``); anything else resolves with ``int()``.  A
        count that fails to resolve is dropped: diagnostics never raise."""
        with self._lock:
            pend, self._pending = self._pending, []
        if not pend:
            return
        values = [ent[-1] for ent in pend]
        ints: List[Optional[int]] = [None] * len(pend)
        dev = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor)]
        if dev:
            with contextlib.suppress(Exception):
                by_type: Dict[torch.dtype, List[int]] = {}
                for i in dev:
                    by_type.setdefault(values[i].dtype, []).append(i)
                order = [i for idx in by_type.values() for i in idx]
                read = torch.cat([torch.stack([values[i].reshape(()) for i in idx])
                                  .to(torch.int64) for idx in by_type.values()]).tolist()
                for i, n in zip(order, read):
                    ints[i] = int(n)
                if values[dev[0]].device.type != "cpu":
                    from quokka_tpu_torch import obs

                    obs.REGISTRY.counter("opstats.count_reads").inc()
        for i, v in enumerate(values):
            if ints[i] is None and not isinstance(v, torch.Tensor):
                with contextlib.suppress(Exception):
                    ints[i] = int(v)
        with self._lock:
            for ent, n in zip(pend, ints):
                if n is None:
                    continue
                if ent[0] == "op":
                    _, key, field, _v = ent
                    if key[0] in self._plans:
                        self._rec(key)[field] += n
                else:
                    (qid, src, tgt, ch) = ent[1]
                    if qid in self._plans:
                        d = self._edges.setdefault((qid, src, tgt), {})
                        d[ch] = d.get(ch, 0) + n

    # -- snapshots / rendering ----------------------------------------------
    def snapshot(self, qid: str, top_n: int = _TOP_N) -> Optional[dict]:
        """The query's full operator report (operators, exchange edges with
        skew figures, top-N hot operators).  None for an unregistered id.
        Also refreshes the per-query ``opstats.*``/``shuffle.skew.*`` gauges
        (created here, GC'd in ``on_query_gc``)."""
        self.resolve_pending()
        thresh = skew_ratio_threshold()
        with self._lock:
            plan = self._plans.get(qid)
            if plan is None:
                last = self._last
                return last if last and last.get("query_id") == qid else None
            snap = self._render_locked(qid, plan, thresh, top_n)
        self._export_gauges(qid, snap)
        # device-efficiency join (obs/devprof.py): static program costs vs
        # the measured per-operator seconds above — outside the lock, no
        # device reads
        from quokka_tpu_torch.obs import devprof

        devprof.attach(qid, snap)
        return snap

    def _render_locked(self, qid: str, plan: dict, thresh: float,
                       top_n: int) -> dict:
        total_time = 0.0
        per_actor: Dict[int, dict] = {}
        for (q, aid, ch), r in self._ops.items():
            if q != qid:
                continue
            agg = per_actor.setdefault(aid, dict.fromkeys(_FIELDS, 0))
            for f in _FIELDS:
                agg[f] += r[f]
        times: Dict[int, float] = {}
        for (q, aid, ch), t in self._time.items():
            if q == qid:
                times[aid] = times.get(aid, 0.0) + t
                total_time += t
        notes: Dict[int, Dict[str, int]] = {}
        for (q, aid, ch), d in self._notes.items():
            if q == qid:
                agg = notes.setdefault(aid, {})
                for name, v in d.items():
                    agg[name] = agg.get(name, 0) + v
        operators = []
        for aid in sorted(plan["actors"]):
            ent = plan["actors"][aid]
            agg = per_actor.get(aid, dict.fromkeys(_FIELDS, 0))
            t = times.get(aid, 0.0)
            op = {
                "actor": aid,
                "op": ent["op"],
                "kind": ent["kind"],
                "channels": ent["channels"],
                "targets": ent["targets"],
                "stage": ent["stage"],
                **agg,
                "time_s": round(t, 6),
                "time_share": round(t / total_time, 4) if total_time else 0.0,
            }
            if agg["rows_in"]:
                op["selectivity"] = round(agg["rows_out"] / agg["rows_in"], 6)
            if agg["padded_in"]:
                # bucket-ladder waste: padded slots carried vs live rows
                op["pad_waste"] = round(
                    max(0.0, 1.0 - agg["rows_in"] / agg["padded_in"]), 4)
            if ent.get("size_hint_bytes"):
                op["size_hint_bytes"] = ent["size_hint_bytes"]
            if ent.get("src_sig"):
                op["src_sig"] = ent["src_sig"]
            if aid in notes:
                op.update(notes[aid])
            operators.append(op)
        edges = []
        for (q, src, tgt), chd in sorted(self._edges.items()):
            if q != qid or not chd:
                continue
            rows = [chd.get(c, 0)
                    for c in range(plan["actors"][tgt]["channels"])] \
                if tgt in plan["actors"] else list(chd.values())
            total = sum(rows)
            mean = total / len(rows) if rows else 0.0
            mx = max(rows) if rows else 0
            ratio = (mx / mean) if mean > 0 else 1.0
            edges.append({
                "edge": f"a{src}->a{tgt}",
                "src": src,
                "tgt": tgt,
                "channels": len(rows),
                "rows_total": total,
                "rows_max": mx,
                "rows_mean": round(mean, 2),
                "skew_ratio": round(ratio, 4),
                "skewed": bool(len(rows) > 1 and mean > 0
                               and ratio >= thresh),
                "channel_rows": rows,
            })
        hot = sorted(operators,
                     key=lambda o: (o["time_s"], o["rows_out"]),
                     reverse=True)[:top_n]
        rows_unknown = sum(o["rows_unknown"] for o in operators)
        return {
            "query_id": qid,
            "plan_fp": plan.get("plan_fp"),
            "wall_s": round(time.time() - plan["t0"], 6),
            "time_s": round(total_time, 6),
            "size_hint_bytes": plan.get("size_hint_bytes", 0),
            "skew_threshold": thresh,
            "operators": operators,
            "edges": edges,
            "top_operators": [
                {"actor": o["actor"], "op": o["op"], "time_s": o["time_s"],
                 "time_share": o["time_share"], "rows_out": o["rows_out"]}
                for o in hot],
            "rows_unknown": rows_unknown,
            # plan-time choices + runtime adaptations, with the figures
            # that drove them (explain's "planner decisions" section)
            "planner": [dict(d) for d in plan.get("planner") or []],
        }

    def _export_gauges(self, qid: str, snap: dict) -> None:
        """Per-query gauge twins (rows totals + per-edge skew ratios),
        created on first snapshot, names remembered for on_query_gc."""
        from quokka_tpu_torch import obs

        pairs = [
            (f"opstats.rows_in.{qid}",
             sum(o["rows_in"] for o in snap["operators"])),
            (f"opstats.rows_out.{qid}",
             sum(o["rows_out"] for o in snap["operators"])),
        ]
        worst = 0.0
        for e in snap["edges"]:
            pairs.append(
                (f"shuffle.skew.{qid}.{e['src']}-{e['tgt']}",
                 e["skew_ratio"]))
            worst = max(worst, e["skew_ratio"])
        with self._lock:
            if qid not in self._plans:
                return  # GC'd between render and export: do not resurrect
            self._gauges[qid] = [name for name, _ in pairs]
            self._skew_worst[qid] = max(self._skew_worst.get(qid, 0.0),
                                        worst)
            live_worst = max(self._skew_worst.values(), default=0.0)
        for name, value in pairs:
            obs.REGISTRY.gauge(name).set(value)
        # max over LIVE queries, not a process-lifetime ratchet: the gauge
        # falls back to 0 once the skewed query GCs (on_query_gc recomputes)
        obs.REGISTRY.gauge("shuffle.skew").set(live_worst)

    def top_operator(self, qid: str) -> Optional[str]:
        """One-line hottest-operator label for /status (non-creating; falls
        back to the stashed snapshot for the just-finished query)."""
        with self._lock:
            plan = self._plans.get(qid)
            if plan is None:
                last = self._last
                if not (last and last.get("query_id") == qid):
                    return None
                hot = last.get("top_operators") or []
                top = hot[0] if hot else None
            else:
                top = None
                best = (-1.0, -1)
                for (q, aid, ch), r in self._ops.items():
                    if q != qid:
                        continue
                    score = (self._time.get((q, aid, ch), 0.0), r["rows_out"])
                    if score > best:
                        best = score
                        ent = plan["actors"].get(aid, {})
                        top = {"actor": aid, "op": ent.get("op", "?"),
                               "time_s": score[0], "rows_out": r["rows_out"]}
        if top is None:
            return None
        return (f"{top['op']}(a{top['actor']}) "
                f"{top['time_s']:.3f}s rows={top['rows_out']}")

    def last_finished(self) -> Optional[dict]:
        """The most recently GC'd query's snapshot (what bench.py reads
        after a one-shot run's cleanup)."""
        with self._lock:
            return self._last

    # -- query GC + persistence ---------------------------------------------
    def on_query_gc(self, qid: Optional[str],
                    plan_fp: Optional[str] = None) -> Optional[dict]:
        """``TaskGraph.cleanup`` hook: final snapshot, persist measured
        cardinalities under the plan fingerprint, record size_hint drift,
        drop per-query state and gauge twins."""
        if qid is None:
            return None
        snap = self.snapshot(qid)
        with self._lock:
            plan = self._plans.pop(qid, None)
            if plan is None:
                return None
            for key in [k for k in self._ops if k[0] == qid]:
                del self._ops[key]
            for key in [k for k in self._time if k[0] == qid]:
                del self._time[key]
            for key in [k for k in self._edges if k[0] == qid]:
                del self._edges[key]
            for key in [k for k in self._notes if k[0] == qid]:
                del self._notes[key]
            self._pending = [p for p in self._pending if p[1][0] != qid]
            gauges = self._gauges.pop(qid, [])
            self._skew_worst.pop(qid, None)
            live_worst = max(self._skew_worst.values(), default=0.0)
            self._last = snap
        from quokka_tpu_torch import obs

        if gauges:
            obs.REGISTRY.remove(*gauges)
        # per-query epoch reset: with the skewed query gone the global max
        # drops to the worst LIVE query (0 when idle), so /health alerts
        # clear without a restart
        obs.REGISTRY.gauge("shuffle.skew").set(live_worst)
        from quokka_tpu_torch.obs import devprof

        devprof.on_query_finished(qid, plan_fp or (plan or {}).get("plan_fp"),
                                  snap or {})
        fp = plan_fp or (plan or {}).get("plan_fp")
        if snap is not None:
            record_cardinalities(fp, snap)
            hint = int(snap.get("size_hint_bytes", 0) or 0)
            actual = _source_bytes(snap)
            if hint > 0 and actual > 0:
                drift = abs(hint - actual)
                obs.REGISTRY.counter("opstats.size_hint_drift_bytes").inc(
                    drift)
        return snap

    def reset(self) -> None:
        """Tests only."""
        with self._lock:
            self._plans.clear()
            self._ops.clear()
            self._time.clear()
            self._edges.clear()
            self._notes.clear()
            self._pending.clear()
            self._gauges.clear()
            self._skew_worst.clear()
            self._last = None


def _actor_op_name(info) -> str:
    """Best-effort operator label straight from the ActorInfo (the engine
    upgrades exec labels to the bound executor's class name)."""
    if info.kind == "input":
        return type(info.reader).__name__
    factory = getattr(info, "executor_factory", None)
    f = getattr(factory, "func", factory)
    name = getattr(f, "__name__", None)
    if name and name != "<lambda>":
        return name
    return info.kind


def _source_bytes(snap: dict) -> int:
    return sum(o["bytes_out"] for o in snap.get("operators", ())
               if o.get("kind") == "input")


def _source_rows(snap: dict) -> int:
    return sum(o["rows_out"] for o in snap.get("operators", ())
               if o.get("kind") == "input")


OPSTATS = OpStats()


# ---------------------------------------------------------------------------
# Measured cardinalities: per-plan-fingerprint persistence, read back by
# measured_source_bytes / measured_calib_rows
# ---------------------------------------------------------------------------


def _profile_dir() -> Optional[str]:
    """``QK_CARDPROFILE_DIR`` overrides (empty disables, the QK_STRATEGY_DIR
    idiom); default lives beside the memory profiles under the cache root."""
    env = os.environ.get("QK_CARDPROFILE_DIR")
    if env is not None:
        return env or None
    from quokka_tpu_torch import config

    return os.path.join(config.CACHE_ROOT, "cardprofile")


def _profile_path() -> Optional[str]:
    d = _profile_dir()
    if d is None:
        return None
    from quokka_tpu_torch.obs import devprof

    return os.path.join(d, devprof.backend_fingerprint() + ".json")


def _load_profile(path: str) -> Optional[dict]:
    """The profile dict, or None when absent/corrupt/foreign.  A profile
    measured on a different backend topology is rejected wholesale."""
    try:
        with open(path, encoding="utf-8") as f:
            prof = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(prof, dict) or prof.get("version") != _PROFILE_VERSION:
        return None
    from quokka_tpu_torch.obs import devprof

    if prof.get("fingerprint") != devprof.backend_fingerprint():
        return None
    return prof if isinstance(prof.get("plans"), dict) else None


def record_cardinalities(plan_fp: Optional[str], snap: dict) -> None:
    """Persist a finished query's measured figures under its plan
    fingerprint (atomic tmp+replace, max-merged across runs so a partial
    run never shrinks a measured cardinality).  Best effort: never raises."""
    if not plan_fp or not snap:
        return
    src_rows = _source_rows(snap)
    src_bytes = _source_bytes(snap)
    if src_rows <= 0 and src_bytes <= 0:
        return
    path = _profile_path()
    if path is None:
        return
    try:
        from quokka_tpu_torch.obs import devprof

        prof = _load_profile(path) or {
            "version": _PROFILE_VERSION,
            "fingerprint": devprof.backend_fingerprint(),
            "plans": {},
        }
        ent = prof["plans"].get(plan_fp)
        ent = ent if isinstance(ent, dict) else {}
        rows = ent.get("rows") if isinstance(ent.get("rows"), dict) else {}
        for o in snap.get("operators", ()):
            k = f"a{o['actor']}:{o['op']}"
            rows[k] = max(int(o["rows_out"]), int(rows.get(k, 0) or 0))
        # plan-INDEPENDENT scan figures keyed by source signature: any plan
        # scanning the same (reader, predicate, projection) reuses them
        # (the reference planner's MEASURED basis)
        sources = prof.get("sources")
        sources = sources if isinstance(sources, dict) else {}
        for o in snap.get("operators", ()):
            sig = o.get("src_sig")
            if not sig or o.get("kind") != "input" or not o.get("rows_out"):
                continue
            cur = sources.get(sig)
            cur = cur if isinstance(cur, dict) else {}
            sources[sig] = {
                "rows_raw": max(int(o["rows_in"]),
                                int(cur.get("rows_raw", 0) or 0)),
                "rows": max(int(o["rows_out"]), int(cur.get("rows", 0) or 0)),
                "bytes": max(int(o["bytes_out"]),
                             int(cur.get("bytes", 0) or 0)),
                "runs": int(cur.get("runs", 0) or 0) + 1,
            }
        prof["sources"] = sources
        prof["plans"][plan_fp] = {
            "source_rows": max(src_rows, int(ent.get("source_rows", 0) or 0)),
            "source_bytes": max(src_bytes,
                                int(ent.get("source_bytes", 0) or 0)),
            "max_rows": max([int(o["rows_out"])
                             for o in snap.get("operators", ())] + [0]
                            + [int(ent.get("max_rows", 0) or 0)]),
            "rows": rows,
            "runs": int(ent.get("runs", 0) or 0) + 1,
        }
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(prof, f)
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError) as e:
        from quokka_tpu_torch import obs

        obs.diag(f"[opstats] cardinality persist for {plan_fp} failed: {e!r}")


def _plan_entry(plan_fp: Optional[str]) -> Optional[dict]:
    if not plan_fp:
        return None
    path = _profile_path()
    if path is None:
        return None
    prof = _load_profile(path)
    if prof is None:
        return None
    ent = prof["plans"].get(plan_fp)
    return ent if isinstance(ent, dict) else None


def measured_source_bytes(plan_fp: Optional[str]) -> Optional[int]:
    """Measured bytes the plan's sources actually produced, or None (the
    reference's admission falls back to ``size_hint()`` then)."""
    ent = _plan_entry(plan_fp)
    if ent is None:
        return None
    try:
        b = int(ent.get("source_bytes", 0))
    except (TypeError, ValueError):
        return None
    return b if b > 0 else None


def measured_calib_rows() -> Optional[int]:
    """A representative measured batch cardinality for strategy
    calibration: the largest per-operator row count any profiled plan
    produced on this backend, or None (calibration keeps its default)."""
    path = _profile_path()
    if path is None:
        return None
    prof = _load_profile(path)
    if prof is None:
        return None
    best = 0
    for ent in prof["plans"].values():
        if isinstance(ent, dict):
            with contextlib.suppress(TypeError, ValueError):
                best = max(best, int(ent.get("max_rows", 0) or 0))
    return best if best > 0 else None
