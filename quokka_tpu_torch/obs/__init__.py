"""The port's observability plane (from ``quokka_tpu/obs``): the metric
registry, the per-operator statistics ledger behind EXPLAIN ANALYZE, its
renderer, and the device-efficiency plane.

- ``REGISTRY`` (``metrics.py``): named counters, gauges and histograms;
- ``OPSTATS`` (``opstats.py``): rows in / out, bytes, padded waste, time
  share and exchange-edge skew per (query, actor, channel), fed by the
  engine's choke points;
- ``explain.render(OPSTATS.last_finished())``: the EXPLAIN ANALYZE text of
  the last finished query;
- ``devprof``: calibrated peak FLOP/s and bandwidth, each kernel's static
  cost, charged per dispatch to the operator running it, and the roofline
  efficiency attached to every snapshot.

The reference's flight recorder, exporters, health, memory and progress
planes are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import contextlib
import sys

from quokka_tpu_torch.obs import devprof, explain, metrics, opstats
from quokka_tpu_torch.obs.metrics import REGISTRY
from quokka_tpu_torch.obs.opstats import OPSTATS


def diag(msg: str) -> None:
    """One diagnostic line to stderr, flushed (a closed stderr is ignored)."""
    with contextlib.suppress(OSError, ValueError):
        sys.stderr.write(msg.rstrip("\n") + "\n")
        sys.stderr.flush()
