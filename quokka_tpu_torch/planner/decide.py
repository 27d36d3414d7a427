"""Plan-time decisions of the planner (port of ``quokka_tpu/planner/decide.py``,
its adaptive-exchange pass only; the cost model and the cost-fed passes come
with a later slice)."""

from __future__ import annotations

import threading
from typing import Dict, List

from quokka_tpu_torch import config, logical

# a column of this name would collide with a salted exchange's routing
SALT_COLUMN = "__qk_salt"

# the decision log of the plan being optimized (thread-local: optimize()
# runs on the submitting thread); it rides the graph to the ledger, whose
# snapshot explain() renders under "planner decisions"
_TL = threading.local()


def begin_decisions() -> None:
    """Start collecting decisions for the plan being optimized."""
    _TL.log = []


def record(kind: str, **fields) -> None:
    log = getattr(_TL, "log", None)
    if log is not None:
        log.append({"kind": kind, **fields})


def take_decisions() -> List[dict]:
    """Return and clear the collected decisions (empty when collection was
    never begun)."""
    log = getattr(_TL, "log", None)
    _TL.log = None
    return list(log or [])


def plan_adaptive_exchanges(sub: Dict[int, logical.Node], sink_id: int) -> None:
    """Mark joins whose build exchange may be salted mid-query.

    Eligibility is decided here, over the logical plan, so the runtime
    trigger (``planner/adapt.py``) only ever fires on edges proven safe:
    inner hash joins only (salting keeps inner matches exactly-once but
    breaks the per-channel completeness that left / semi / anti joins
    need), not broadcast (a broadcast build has no partition to salt), and
    with no claimed output order (replicated probe slices interleave)."""
    from quokka_tpu_torch import optimizer

    if not config.adapt_enabled():
        return
    eligible = []
    for nid in optimizer._reachable(sub, sink_id):
        node = sub[nid]
        if not isinstance(node, logical.JoinNode) or SALT_COLUMN in node.schema:
            continue
        if node.how == "inner" and not node.broadcast and not node.sorted_by:
            node.adapt_salt = True
            eligible.append(node.describe())
    if eligible:
        record("adapt_mark", joins=eligible, skew_ratio=config.skew_ratio_threshold())
