"""Typed counters, gauges and histograms (port of ``quokka_tpu/obs/metrics.py``:
the process-wide ``Registry`` and its instruments).

The operator-statistics ledger (``obs/opstats.py``) and the device
efficiency plane (``obs/devprof.py``) publish per-query gauges and
counters here.  The reference's per-channel ``EngineMetrics`` is not
ported: nothing in this package reads it.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotone counter.  ``inc`` takes the registry lock: increments are
    read-modify-write and these sit on per-task (not per-row) paths."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instrument (queue depths, buffer sizes)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)  # single store: atomic under the GIL

    @property
    def value(self) -> float:
        return self._value


# latency bucket ladder (seconds): sub-ms dispatch quanta up through the
# stall-timeout regime.  Fixed across the process so histograms merge and
# the Prometheus exposition stays a stable family.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Fixed-bucket latency histogram (task latency, rpc latency, admission
    queue wait).  ``observe`` takes the registry lock: it is a
    read-modify-write on the bucket counts and sits on per-task / per-rpc
    (not per-row) paths, same cost class as ``Counter.inc``."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None
                   else DEFAULT_LATENCY_BUCKETS))
        # one slot per finite bound + the +Inf overflow slot
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """One ATOMIC read: ([(upper_bound, cumulative_count)] ending with
        (inf, total), sum, count).  Buckets, sum and count come from the
        same locked instant, so the Prometheus exposition invariant
        ``bucket{le="+Inf"} == _count`` holds on every scrape even while
        dispatch threads keep observing."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        out: List[Tuple[float, int]] = []
        acc = 0
        for bound, n in zip(self.bounds, counts):
            acc += n
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out, total_sum, total_count

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)] ending with (inf, total) — the
        Prometheus ``_bucket{le=...}`` series."""
        return self.snapshot()[0]

    def _quantile_from(self, cum: List[Tuple[float, int]],
                       q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate over one snapshot (None
        when empty).  Values past the last finite bound report that bound —
        the estimate is for dashboards/stats, not for billing."""
        total = cum[-1][1]
        if total == 0:
            return None
        rank = q * total
        lo = 0.0
        prev = 0
        for bound, acc in cum:
            if acc >= rank and acc > prev:
                if bound == float("inf"):
                    return self.bounds[-1] if self.bounds else lo
                frac = (rank - prev) / (acc - prev)
                return lo + (bound - lo) * min(1.0, max(0.0, frac))
            lo, prev = (bound, acc) if bound != float("inf") else (lo, acc)
        return self.bounds[-1] if self.bounds else None

    def quantile(self, q: float) -> Optional[float]:
        return self._quantile_from(self.cumulative(), q)

    def stats(self) -> Dict[str, Optional[float]]:
        """{count, sum, p50, p95, p99} from ONE atomic snapshot — what
        service stats() embeds."""
        cum, total, count = self.snapshot()
        return {
            "count": count,
            "sum": round(total, 6),
            "p50": self._quantile_from(cum, 0.5),
            "p95": self._quantile_from(cum, 0.95),
            "p99": self._quantile_from(cum, 0.99),
        }

    @staticmethod
    def empty_stats() -> Dict[str, Optional[float]]:
        """The stats() shape for a histogram that does not (or no longer)
        exists — non-creating readers (service stats, /status) use this
        instead of resurrecting a GC'd per-query instrument."""
        return {"count": 0, "sum": 0.0, "p50": None, "p95": None,
                "p99": None}


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, self._lock, buckets))
        if buckets is not None and tuple(sorted(buckets)) != h.bounds:
            # silently handing back different bounds would scatter the
            # caller's observations across an unexpected ladder
            raise ValueError(
                f"histogram {name!r} already exists with bounds "
                f"{h.bounds}; requested {tuple(sorted(buckets))}")
        return h

    def histograms(self) -> Dict[str, Histogram]:
        """Live histogram instruments (the Prometheus exporter iterates)."""
        with self._lock:
            return dict(self._histograms)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {n: c.value
                                     for n, c in self._counters.items()}
            out.update({n: g.value for n, g in self._gauges.items()})
            # histograms flatten to their scalar moments; the full bucket
            # vector stays behind histograms()/cumulative()
            for n, h in self._histograms.items():
                out[f"{n}.count"] = h._count
                out[f"{n}.sum"] = round(h._sum, 6)
        return out

    def typed_snapshot(self) -> Dict[str, Dict]:
        """One atomic read of the whole registry, KEPT BY KIND — what the
        history ring records.  ``snapshot()`` flattens histograms into
        ``.count``/``.sum`` keys, which loses the kind distinction rate
        derivation needs (counters are rateable, gauges are not)."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: (h._count, round(h._sum, 6))
                               for n, h in self._histograms.items()},
            }

    def remove(self, *names: str) -> None:
        """Drop named instruments (per-query counters GC with their query —
        a long-lived service would otherwise grow one pair per query id)."""
        with self._lock:
            for n in names:
                self._counters.pop(n, None)
                self._gauges.pop(n, None)
                self._histograms.pop(n, None)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = Registry()
