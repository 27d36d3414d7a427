"""Device-time and roofline efficiency plane (port of
``quokka_tpu/obs/devprof.py``).

1. **Per-kernel static cost ledger.**  The reference reads each compiled
   program's ``cost_analysis()``.  The port has no compiled executable to
   ask, so each kernel's wrapper states its cost as a formula of its launch
   shapes (the bytes it must move, and for K21 its operations: the same
   count as ``PERF.md``'s "bound" column) and hands it to
   :func:`on_dispatch` at the point that picks the kernel or its plain
   version; the first dispatch of a key records the cost.  The plain
   version is charged the same cost: the cost belongs to the function.

2. **Calibrated peaks.**  :func:`calibrate` times the reference's two
   workloads, a 256 x 256 float32 matmul (2 n^3 FLOPs) and a 2^21-element
   float32 add (12 bytes an element), best of 3 after one warm call, with
   CUDA events on the card and ``perf_counter`` on the CPU.  It runs on the
   card unless the caller asks for the CPU, and raises with no card.  The
   profile ``{peak_flops_s, peak_bw_bytes_s}`` persists under
   ``<dir>/<fingerprint>.json``; a foreign, corrupt or versioned-away
   profile is rejected wholesale.  The fingerprint holds the torch and CUDA
   versions, the device name and count, and the host.  At these sizes both
   workloads are launch-sized on an H100, so the peaks read far below the
   data sheet (PERF.md).

3. **Runtime attribution with no device read.**  :func:`on_dispatch`
   charges the kernel's static FLOPs / bytes to the operator that
   ``obs/opstats.py``'s thread-local marker names.  :func:`attach` joins
   them with the ledger's measured seconds into achieved rates and roofline
   efficiency on the snapshot that ``obs/explain.render`` prints.

Knobs (the reference's): ``QK_DEVPROF`` (``0``: the plane is off),
``QK_EFF_FLOOR`` (efficiency below which explain flags an operator, default
0.05), ``QK_DEVPROF_DIR`` (profile directory; empty disables persistence;
unset: ``<config.CACHE_ROOT>/devprof``), ``QK_DEVPROF_CALIBRATE`` (``0``:
``ensure_calibrated`` only loads a profile, never measures).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import platform
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from quokka_tpu_torch import config

_PROFILE_VERSION = 1
MATMUL_N = 256
STREAM_ELEMS = 1 << 21

# process-wide state: static kernel costs, per-(query, actor) attribution,
# per-key dispatch tallies, and the calibrated-peaks profile
_lock = threading.Lock()
_costs: Dict[Any, Dict[str, float]] = {}
_attr: Dict[Tuple[str, int], List[float]] = {}
_prog_disp: Dict[Any, int] = {}
_qgauges: Dict[str, List[str]] = {}
_peaks: Optional[Dict[str, Any]] = None
_calib_state = "unloaded"


# ---------------------------------------------------------------------------
# Knobs and the fingerprint
# ---------------------------------------------------------------------------


def enabled() -> bool:
    """``QK_DEVPROF``: unset/1 -> on; ``0`` -> the whole plane off."""
    return os.environ.get("QK_DEVPROF", "1") != "0"


def eff_floor() -> float:
    """``QK_EFF_FLOOR``: roofline-efficiency fraction below which an
    operator is flagged in explain() (default 0.05)."""
    try:
        return float(os.environ.get("QK_EFF_FLOOR", 0.05))
    except ValueError:
        return 0.05


def _dir() -> Optional[str]:
    """Profile directory; QK_DEVPROF_DIR='' disables persistence, unset
    falls back to <cache root>/devprof."""
    d = os.environ.get("QK_DEVPROF_DIR")
    if d is not None:
        return d or None
    return os.path.join(config.CACHE_ROOT, "devprof")


def backend_fingerprint(device=None) -> str:
    """Platform, device name and count, torch and CUDA versions, and the
    host: a profile measured under another fingerprint describes another
    machine.  ``device=None``: the card when there is one, else the CPU."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        kind, count = platform.processor() or platform.machine(), 1
    raw = "|".join([dev.type, str(kind), str(count), torch.__version__,
                    str(torch.version.cuda), platform.machine(), platform.node()])
    return f"{dev.type}-{count}x-{hashlib.sha256(raw.encode()).hexdigest()[:12]}"


def _profile_path(fingerprint: Optional[str] = None) -> Optional[str]:
    d = _dir()
    return os.path.join(d, f"{fingerprint or backend_fingerprint()}.json") if d else None


def key_hash(key) -> str:
    """Stable name of a cost key (keys are tuples of builtins)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:24]


# ---------------------------------------------------------------------------
# Calibration profile: load / validate / persist
# ---------------------------------------------------------------------------


def _valid_profile(data: Any) -> bool:
    if not isinstance(data, dict):
        return False
    if data.get("version") != _PROFILE_VERSION:
        return False
    if data.get("fingerprint") != backend_fingerprint():
        return False
    for k in ("peak_flops_s", "peak_bw_bytes_s"):
        v = data.get(k)
        if not isinstance(v, (int, float)) or not math.isfinite(v) or v <= 0:
            return False
    return isinstance(data.get("sources", {}), dict)


def _load_profile(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """Wholesale rejection: a corrupt, versioned-away or foreign-fingerprint
    profile is ignored entirely (never partially trusted)."""
    if not path:
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        if not _valid_profile(data):
            raise ValueError("invalid devprof profile")
        return data
    except (OSError, ValueError):
        return None


def _persist_profile(data: Dict[str, Any]) -> None:
    path = _profile_path(data["fingerprint"])
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError as e:
        from quokka_tpu_torch import obs

        obs.diag(f"devprof: profile persist failed: {e}")


def _install(prof: Optional[Dict[str, Any]]) -> None:
    """Adopt a profile in-process and mirror the peaks onto gauges."""
    global _peaks, _calib_state
    with _lock:
        if prof is not None:
            _peaks = prof
        _calib_state = "loaded"
    if prof is not None:
        from quokka_tpu_torch import obs

        obs.REGISTRY.gauge("devprof.peak_flops").set(prof["peak_flops_s"])
        obs.REGISTRY.gauge("devprof.peak_bw_bytes").set(prof["peak_bw_bytes_s"])


def _ensure_loaded() -> None:
    with _lock:
        if _calib_state == "loaded":
            return
    # file I/O outside the lock
    _install(_load_profile(_profile_path()))


def peaks() -> Optional[Dict[str, Any]]:
    """The installed calibration profile, lazily loaded from disk; None
    until calibrate() has run for this fingerprint."""
    _ensure_loaded()
    with _lock:
        return _peaks


def _time_best(fn, device: torch.device, reps: int = 3) -> float:
    """Seconds of one call of fn, best of ``reps`` after one warm call:
    CUDA events around the call on the card, perf_counter on the CPU."""
    fn()  # warm: first dispatch, allocator
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def calibrate(force: bool = False, device=None) -> Dict[str, Any]:
    """Time peak FLOP/s and memory bandwidth on ``device`` (the card unless
    the caller asks for the CPU; raises with no card), install the profile
    in-process and persist it.  Idempotent per fingerprint unless forced."""
    dev = config.resolve_device(device)
    if not force:
        existing = peaks()
        if existing is not None and existing.get("fingerprint") == backend_fingerprint(dev):
            return existing
    timings: Dict[str, float] = {}
    # peak FLOP/s: square matmul (2 n^3 FLOPs), at the default float32
    # matmul precision (allow_tf32 is recorded, not set)
    n = MATMUL_N
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    t_mm = _time_best(lambda: torch.matmul(a, a), dev)
    timings["matmul_s"] = t_mm
    peak_flops = (2.0 * n ** 3) / max(t_mm, 1e-9)
    # peak bandwidth: streaming elementwise add (read 2 arrays, write 1)
    m = STREAM_ELEMS
    v = torch.ones((m,), dtype=torch.float32, device=dev)
    t_add = _time_best(lambda: v + v, dev)
    timings["stream_s"] = t_add
    peak_bw = (3.0 * 4.0 * m) / max(t_add, 1e-9)

    prof: Dict[str, Any] = {
        "version": _PROFILE_VERSION,
        "fingerprint": backend_fingerprint(dev),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else f"cpu ({platform.machine()})"),
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "peak_flops_s": peak_flops,
        "peak_bw_bytes_s": peak_bw,
        "timings_s": timings,
        "sources": {},
    }
    # carry observations forward across re-calibration
    prev = peaks()
    if prev is not None and prev.get("fingerprint") == prof["fingerprint"]:
        prof["sources"] = dict(prev.get("sources", {}))
        if "observed_bw_bytes_s" in prev:
            prof["observed_bw_bytes_s"] = prev["observed_bw_bytes_s"]
    _install(prof)
    _persist_profile(prof)
    return prof


def ensure_calibrated(device=None) -> Dict[str, Any]:
    """Load-or-calibrate once: the smoke's entry point.  Honors
    ``QK_DEVPROF_CALIBRATE=0`` (load an existing profile only)."""
    p = peaks()
    if p is not None:
        return p
    if not enabled() or os.environ.get("QK_DEVPROF_CALIBRATE", "1") == "0":
        return {}
    return calibrate(device=device)


def reset() -> None:
    """Forget everything in-process (tests): costs, attribution, profile."""
    global _peaks, _calib_state
    with _lock:
        _costs.clear()
        _attr.clear()
        _prog_disp.clear()
        _qgauges.clear()
        _peaks = None
        _calib_state = "unloaded"


# ---------------------------------------------------------------------------
# Per-kernel static costs
# ---------------------------------------------------------------------------


def record_cost(key, flops: float, nbytes: float, out_bytes: float = 0.0) -> None:
    """Ledger a kernel's static cost under its key: a tuple of the kernel's
    name, the device type it ran on (``"cuda"``, or ``"cpu"`` for the plain
    version), then its launch shapes."""
    if not enabled():
        return
    with _lock:
        _costs[key] = {"flops": float(flops), "bytes": float(nbytes),
                       "out_bytes": float(out_bytes)}
    from quokka_tpu_torch import obs

    obs.REGISTRY.counter("devprof.programs_costed").inc()


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None entries count 0): the cost formulas'
    unit."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def costs_snapshot() -> List[Dict[str, Any]]:
    """Every costed kernel key: its kernel and device type, key hash,
    static figures, arithmetic intensity and lifetime dispatch count."""
    with _lock:
        items = [(k, dict(c), _prog_disp.get(k, 0)) for k, c in _costs.items()]
    out = []
    for key, cost, disp in items:
        out.append({
            "kernel": key[0] if isinstance(key, tuple) and key else str(key),
            "device": (key[1] if isinstance(key, tuple) and len(key) > 1
                       and isinstance(key[1], str) else None),
            "sig": key_hash(key),
            "flops": cost["flops"],
            "bytes": cost["bytes"],
            "out_bytes": cost["out_bytes"],
            "intensity": cost["flops"] / cost["bytes"] if cost["bytes"] > 0 else None,
            "dispatches": disp,
        })
    out.sort(key=lambda r: (-r["flops"], r["sig"]))
    return out


# ---------------------------------------------------------------------------
# Runtime attribution (the dispatch hot path)
# ---------------------------------------------------------------------------


def on_dispatch(key, cost: Optional[Callable[[], Tuple[float, float, float]]] = None) -> None:
    """Charge one kernel dispatch's static FLOPs / bytes to the current
    operator (opstats' thread-local marker).  ``cost`` gives (flops, bytes,
    out_bytes) and is called only when the key is not costed yet.  Dict
    lookups and float adds under a short lock, never a device read."""
    if not enabled():
        return
    c = _costs.get(key)
    if c is None:
        if cost is None:
            return  # an uncosted kernel
        record_cost(key, *cost())
        c = _costs[key]
    from quokka_tpu_torch.obs import opstats

    cur = getattr(opstats._CUR, "key", None)
    with _lock:
        _prog_disp[key] = _prog_disp.get(key, 0) + 1
        if cur is not None:
            slot = _attr.get((cur[0], cur[1]))
            if slot is None:
                slot = _attr[(cur[0], cur[1])] = [0.0, 0.0, 0.0, 0]
            slot[0] += c["flops"]
            slot[1] += c["bytes"]
            slot[2] += c["out_bytes"]
            slot[3] += 1


# ---------------------------------------------------------------------------
# Roofline math
# ---------------------------------------------------------------------------


def roofline(flops: float, nbytes: float, seconds: Optional[float],
             peak_flops: Optional[float], peak_bw: Optional[float]
             ) -> Dict[str, Optional[float]]:
    """Achieved rates + roofline efficiency for one (cost, seconds) pair.

    Efficiency = achieved / attainable, where attainable =
    ``min(peak_flops, intensity * peak_bw)``; a kernel with no FLOPs at all
    (pure data movement) is judged on bandwidth alone.  None when nothing
    is attributable or the peaks are uncalibrated."""
    intensity = flops / nbytes if nbytes > 0 else None
    if seconds is None or seconds <= 0 or (flops <= 0 and nbytes <= 0):
        return {"intensity": intensity, "achieved_flops_s": None,
                "achieved_bw_s": None, "efficiency": None}
    af = flops / seconds if flops > 0 else 0.0
    ab = nbytes / seconds if nbytes > 0 else 0.0
    eff: Optional[float] = None
    if peak_flops and peak_bw:
        if flops > 0:
            attainable = peak_flops
            if intensity is not None:
                attainable = min(peak_flops, intensity * peak_bw)
            eff = af / attainable if attainable > 0 else None
        else:
            eff = ab / peak_bw
    return {"intensity": intensity,
            "achieved_flops_s": af if flops > 0 else None,
            "achieved_bw_s": ab if nbytes > 0 else None,
            "efficiency": eff}


# ---------------------------------------------------------------------------
# Snapshot attachment + query lifecycle
# ---------------------------------------------------------------------------


def attach(qid: str, snap: Dict[str, Any]) -> None:
    """Join the query's per-operator attribution with opstats' measured
    seconds and attach the ``efficiency`` section to the snapshot; mirror
    each operator's roofline efficiency onto a per-query gauge."""
    if not enabled():
        return
    prof = peaks()
    pf = prof.get("peak_flops_s") if prof else None
    pb = prof.get("peak_bw_bytes_s") if prof else None
    with _lock:
        acc = {k[1]: list(v) for k, v in _attr.items() if k[0] == qid}
    rows: List[Dict[str, Any]] = []
    gnames: List[str] = []
    for op in snap.get("operators", []):
        slot = acc.get(op.get("actor"))
        if slot is None:
            continue
        flops, nbytes, out_b, disp = slot
        rl = roofline(flops, nbytes, op.get("time_s"), pf, pb)
        row = {
            "actor": op.get("actor"),
            "op": op.get("op"),
            "time_s": op.get("time_s"),
            "flops": flops,
            "bytes": nbytes,
            "out_bytes": out_b,
            "program_dispatches": disp,
            **rl,
        }
        row["flagged"] = rl["efficiency"] is not None and rl["efficiency"] < eff_floor()
        rows.append(row)
        if rl["efficiency"] is not None:
            from quokka_tpu_torch import obs

            name = f"devprof.eff.{qid}.a{op.get('actor')}"
            obs.REGISTRY.gauge(name).set(rl["efficiency"])
            gnames.append(name)
    rows.sort(key=lambda r: -(r["time_s"] or 0.0))
    snap["efficiency"] = {
        "peaks": ({"fingerprint": prof["fingerprint"],
                   "peak_flops_s": pf, "peak_bw_bytes_s": pb} if prof else None),
        "operators": rows,
    }
    if gnames:
        with _lock:
            _qgauges[qid] = sorted(set(_qgauges.get(qid, []) + gnames))


def on_query_finished(qid: str, plan_fp: Optional[str], snap: Dict[str, Any]) -> None:
    """Query-GC hook (rides ``opstats.on_query_gc``): drop the per-query
    attribution and gauges, and persist the run's observations (per-source
    scan seconds and the achieved bandwidth) into the calibration profile.
    Never raises; persistence is best effort."""
    with _lock:
        acc = {k[1]: list(v) for k, v in _attr.items() if k[0] == qid}
        for k in [k for k in _attr if k[0] == qid]:
            del _attr[k]
        gnames = _qgauges.pop(qid, [])
    if gnames:
        from quokka_tpu_torch import obs

        obs.REGISTRY.remove(*gnames)
    if not enabled():
        return
    prof = peaks()
    if prof is None or not _dir():
        return
    sources: Dict[str, Dict[str, float]] = {}
    tot_bytes = tot_s = 0.0
    for op in snap.get("operators", []):
        t = op.get("time_s")
        if isinstance(t, (int, float)) and t > 0:
            slot = acc.get(op.get("actor"))
            if slot is not None:
                tot_bytes += slot[1]
                tot_s += t
            sig = op.get("src_sig")
            if sig and op.get("kind") == "input":
                b = op.get("bytes_in") or 0
                sources[str(sig)] = {"seconds": float(t), "bytes": float(b)}
    if not sources and tot_s <= 0:
        return
    cur = _load_profile(_profile_path(prof.get("fingerprint"))) or prof
    merged = dict(cur)
    merged_sources = dict(cur.get("sources", {}))
    for sig, row in sources.items():
        prev = merged_sources.get(sig)
        runs = (prev.get("runs", 0) if isinstance(prev, dict) else 0) + 1
        merged_sources[sig] = {**row, "runs": runs}
    merged["sources"] = merged_sources
    if tot_s > 0 and tot_bytes > 0:
        obs_bw = tot_bytes / tot_s
        prev_bw = merged.get("observed_bw_bytes_s")
        if isinstance(prev_bw, (int, float)) and prev_bw > 0:
            obs_bw = 0.5 * prev_bw + 0.5 * obs_bw
        merged["observed_bw_bytes_s"] = obs_bw
    _install(merged)
    _persist_profile(merged)


def summary() -> Dict[str, Any]:
    """Compact process-level digest."""
    prof = peaks()
    with _lock:
        ncost = len(_costs)
        ndisp = sum(_prog_disp.values())
    return {
        "enabled": enabled(),
        "calibrated": prof is not None,
        "fingerprint": prof["fingerprint"] if prof else None,
        "peak_flops_s": prof["peak_flops_s"] if prof else None,
        "peak_bw_bytes_s": prof["peak_bw_bytes_s"] if prof else None,
        "observed_bw_bytes_s": (prof or {}).get("observed_bw_bytes_s"),
        "programs_costed": ncost,
        "program_dispatches": ndisp,
    }
