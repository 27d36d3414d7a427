"""EXPLAIN ANALYZE rendering: the plan DAG annotated with measured actuals
(port of ``quokka_tpu/obs/explain.py``, the same text format).

``opstats.py`` owns the ledger; this module turns one query's snapshot into
the artifacts a reader of a run uses:

- ``render(snap)``: the annotated DAG — one line per operator (rows in/out,
  selectivity, padded-waste, time share, executor-noted figures like join
  build/probe rows), a skew report per exchange edge (max/mean channel
  rows, flagged above ``QK_SKEW_RATIO``), and the top-N hot operators;
- ``operators_detail(snap)`` / ``efficiency_detail(snap)``: the compact
  per-operator and device-efficiency digests (what the reference's bench.py
  embeds in every bench line).

EXPLAIN ANALYZE of a finished query: ``render(OPSTATS.last_finished())``.

Pure host-side formatting over an already-resolved snapshot: no device
work, no registry mutation.
"""

from __future__ import annotations

from typing import List, Optional


def _fmt_rows(n: int) -> str:
    if n >= 10_000_000:
        return f"{n / 1e6:.1f}M"
    if n >= 100_000:
        return f"{n / 1e3:.0f}k"
    return str(n)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


_NOTE_FIELDS = ("join_build_rows", "join_probe_rows")


def _op_line(o: dict) -> str:
    bits = [f"a{o['actor']} {o['op']}",
            f"[{o['kind']} x{o['channels']}]"]
    if o["targets"]:
        bits.append("-> " + ",".join(f"a{t}" for t in o["targets"]))
    if o["kind"] != "input":
        bits.append(f"rows_in={_fmt_rows(o['rows_in'])}")
    bits.append(f"rows_out={_fmt_rows(o['rows_out'])}")
    if o.get("selectivity") is not None:
        bits.append(f"sel={o['selectivity']:.3f}")
    if o.get("pad_waste"):
        bits.append(f"pad_waste={o['pad_waste']:.0%}")
    if o["bytes_in"]:
        bits.append(f"bytes={_fmt_bytes(o['bytes_in'])}")
    bits.append(f"time={o['time_s']:.3f}s({o['time_share']:.0%})")
    bits.append(f"dispatches={o['dispatches']}")
    for f in _NOTE_FIELDS:
        if o.get(f):
            bits.append(f"{f.replace('join_', '')}={_fmt_rows(o[f])}")
    if o["rows_unknown"]:
        bits.append(f"rows_unknown={o['rows_unknown']}")
    return "  ".join(bits)


def _decision_line(d: dict) -> str:
    """One planner decision (planner/decide.py record shapes + the
    engine's runtime adapt_runtime records) as a terminal line."""
    kind = d.get("kind", "?")
    if kind == "broadcast":
        bits = [f"broadcast? {d.get('node')}: {d.get('choice')}",
                f"basis={d.get('basis')}"]
        if d.get("build_rows") is not None:
            bits.append(f"build_rows={_fmt_rows(d['build_rows'])}")
        if d.get("build_bytes") is not None:
            bits.append(f"build_bytes={_fmt_bytes(d['build_bytes'])}")
        if d.get("threshold_bytes") is not None:
            bits.append(
                f"QK_BROADCAST_BYTES={_fmt_bytes(d['threshold_bytes'])}")
        elif d.get("threshold_rows") is not None:
            bits.append(f"threshold_rows={_fmt_rows(d['threshold_rows'])}")
        if d.get("est_s_basis"):
            bits.append(
                f"broadcast_s={d.get('broadcast_s')}"
                f" partition_s={d.get('partition_s')}"
                f" [{d['est_s_basis']}"
                + (f", probe {d['probe_s_basis']}]"
                   if d.get("probe_s_basis") else "]"))
        return "  ".join(bits)
    if kind == "join_order":
        line = (f"join_order [{d.get('basis')}]: "
                + " | ".join(d.get("after") or []))
        if d.get("est_s_basis"):
            line += f"  est_s_basis={d['est_s_basis']}"
        return line
    if kind == "channels":
        return (f"channels {d.get('node')}: {d.get('default')}"
                f"->{d.get('channels')}  basis={d.get('basis')}"
                f" rows={_fmt_rows(d.get('rows', 0))}")
    if kind == "adapt_mark":
        joins = ", ".join(d.get("joins") or [])
        return (f"adaptive exchanges armed (QK_SKEW_RATIO="
                f"{d.get('skew_ratio')}): {joins}")
    if kind == "adapt_runtime":
        return (f"RUNTIME adapt {d.get('edge')}: channel "
                f"{d.get('fat_channel')} had "
                f"{_fmt_rows(d.get('fat_rows', 0))} of "
                f"{_fmt_rows(d.get('total_rows', 0))} rows "
                f"(ratio={d.get('ratio')}) -> {d.get('action')}")
    return " ".join(f"{k}={v}" for k, v in d.items())


def render(snap: Optional[dict], top_n: int = 5) -> str:
    """The human EXPLAIN ANALYZE report for one query's snapshot (what
    the reference's ``QueryHandle.explain()`` and ``bench.py --measure`` print)."""
    if not snap:
        return "explain: no operator statistics recorded"
    lines = [
        f"EXPLAIN ANALYZE {snap['query_id']}"
        f"  wall={snap['wall_s']:.3f}s dispatch_time={snap['time_s']:.3f}s"
        f"  operators={len(snap['operators'])}"
        f" exchange_edges={len(snap['edges'])}"
    ]
    # operators in stage-then-id order: sources first, sink last — the
    # closest linearization of the DAG a terminal can carry
    for o in sorted(snap["operators"],
                    key=lambda o: (o.get("stage", 0), o["actor"])):
        lines.append("  " + _op_line(o))
    if snap["edges"]:
        lines.append(f"skew report (QK_SKEW_RATIO={snap['skew_threshold']}):")
        for e in snap["edges"]:
            flag = "  ** SKEWED **" if e["skewed"] else ""
            lines.append(
                f"  {e['edge']}: channels={e['channels']} "
                f"rows={_fmt_rows(e['rows_total'])} "
                f"max={_fmt_rows(e['rows_max'])} mean={e['rows_mean']:.0f} "
                f"ratio={e['skew_ratio']:.2f}{flag}")
    eff = snap.get("efficiency")
    if eff and eff.get("operators"):
        peaks = eff.get("peaks")
        head = "device efficiency"
        if peaks:
            head += (f" (peaks: {peaks['peak_flops_s']:.3g} FLOP/s, "
                     f"{peaks['peak_bw_bytes_s']:.3g} B/s)")
        else:
            head += " (uncalibrated: run devprof.calibrate())"
        lines.append(head + ":")
        for r in eff["operators"]:
            bits = [f"a{r['actor']} {r['op']}"]
            if r.get("achieved_flops_s") is not None:
                bits.append(f"flops/s={r['achieved_flops_s']:.3g}")
            if r.get("achieved_bw_s") is not None:
                bits.append(f"bw={r['achieved_bw_s']:.3g}B/s")
            if r.get("intensity") is not None:
                bits.append(f"intensity={r['intensity']:.2f}")
            if r.get("efficiency") is not None:
                bits.append(f"roofline={r['efficiency']:.1%}")
            bits.append(f"programs={r['program_dispatches']}")
            flag = "  ** BELOW QK_EFF_FLOOR **" if r.get("flagged") else ""
            lines.append("  " + "  ".join(bits) + flag)
    planner = snap.get("planner") or []
    if planner:
        lines.append("planner decisions:")
        for d in planner:
            lines.append("  " + _decision_line(d))
    hot = (snap.get("top_operators") or [])[:top_n]
    if hot:
        lines.append("top operators by dispatch time:")
        for i, o in enumerate(hot, 1):
            lines.append(
                f"  {i}. a{o['actor']} {o['op']}  {o['time_s']:.3f}s "
                f"({o['time_share']:.0%})  rows_out={_fmt_rows(o['rows_out'])}")
    if snap.get("rows_unknown"):
        lines.append(f"note: {snap['rows_unknown']} batch(es) carried no "
                     "host-resolvable row count (never synced for a stat)")
    return "\n".join(lines)


def operators_detail(snap: Optional[dict]) -> Optional[dict]:
    """The compact machine-readable digest bench.py embeds as
    ``detail.operators``: per-operator actuals + the per-edge skew report."""
    if not snap or not snap.get("operators"):
        return None
    ops: List[dict] = []
    for o in snap["operators"]:
        ent = {
            "actor": o["actor"],
            "op": o["op"],
            "kind": o["kind"],
            "rows_in": o["rows_in"],
            "rows_out": o["rows_out"],
            "bytes_in": o["bytes_in"],
            "dispatches": o["dispatches"],
            "time_s": o["time_s"],
            "time_share": o["time_share"],
        }
        for k in ("selectivity", "pad_waste", *_NOTE_FIELDS):
            if o.get(k) is not None:
                ent[k] = o[k]
        ops.append(ent)
    return {
        "operators": ops,
        "skew": [
            {"edge": e["edge"], "channels": e["channels"],
             "rows_max": e["rows_max"], "rows_mean": e["rows_mean"],
             "ratio": e["skew_ratio"], "skewed": e["skewed"]}
            for e in snap["edges"]],
        "rows_unknown": snap.get("rows_unknown", 0),
        # plan-time choices + runtime adaptations (bench detail.plan's
        # "planner" section; same records explain() renders)
        "planner": [dict(d) for d in snap.get("planner") or []],
    }


def efficiency_detail(snap: Optional[dict]) -> Optional[dict]:
    """The compact device-efficiency digest bench.py embeds as
    ``detail.efficiency``: calibrated peaks + per-operator achieved rates
    and roofline percentages (obs/devprof.py attach)."""
    if not snap:
        return None
    eff = snap.get("efficiency")
    if not eff or not eff.get("operators"):
        return None
    return {
        "peaks": eff.get("peaks"),
        "operators": [
            {k: r.get(k)
             for k in ("actor", "op", "time_s", "flops", "bytes",
                       "intensity", "achieved_flops_s", "achieved_bw_s",
                       "efficiency", "program_dispatches", "flagged")}
            for r in eff["operators"]],
    }


def skew_flags(snap: Optional[dict]) -> List[str]:
    """The flagged edges only (what a stall dump headline cites)."""
    if not snap:
        return []
    return [e["edge"] for e in snap.get("edges", ()) if e["skewed"]]
