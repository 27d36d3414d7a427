"""Whole-stage fusion: run a maximal linear operator chain as one exec actor
(port of ``quokka_tpu/ops/stagefuse.py``: ``StageSpec`` and
``FusedStageExecutor``).

The optimizer's ``fuse_stages`` pass rewrites single-consumer, non-blocking
chains (a hash join at the head, broadcast joins inside, a partial
aggregate at the tail) into one ``FusedStageNode``, which lowers to one
actor running a ``FusedStageExecutor``: a member's output feeds the next
member in-process, with no store round trip and no extra task dispatch
between them.  Stream 0 cascades through the members; each build stream
routes to its join member.

The reference's ``FusedElementwise`` (filter / projection / expression-map
members collapsed into one jitted program, PERF.md row 16) is not ported
yet: on TPC-H Q3 and Q5 ``push_filters`` and ``early_projection`` leave no
such member inside a stage, and a stage that would need one raises at
lowering (``logical.FusedStageNode``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from quokka_tpu_torch.executors.base import Executor
from quokka_tpu_torch.ops.batch import DeviceBatch


class StageSpec:
    """The member executor steps in chain order (label, factory) plus the
    fused actor's stream routing {stream: (member index, member stream)}."""

    def __init__(self, steps: Sequence[Tuple[str, Callable]],
                 routing: Dict[int, Tuple[int, int]]):
        self.steps = [tuple(s) for s in steps]
        self.routing = dict(routing)


class FusedStageExecutor(Executor):
    """One actor running a whole fused stage."""

    # one fused dispatch does the work of the whole member chain: drain a
    # wider slice of the ready queue per task than the per-operator default
    MAX_PIPELINE_BATCHES = 32

    def __init__(self, spec: StageSpec):
        self.steps = [factory() for _, factory in spec.steps]
        self.labels = [label for label, _ in spec.steps]
        self.routing = spec.routing

    def _cascade(self, start: int, out: Optional[DeviceBatch],
                 channel: int) -> Optional[DeviceBatch]:
        for i in range(start, len(self.steps)):
            if out is None:
                return None
            out = self.steps[i].execute([out], 0, channel)
        return out

    def execute(self, batches, stream_id, channel):
        idx, sub_stream = self.routing.get(stream_id, (0, 0))
        out = self.steps[idx].execute(batches, sub_stream, channel)
        return self._cascade(idx + 1, out, channel)

    def source_done(self, stream_id, channel):
        idx, sub_stream = self.routing.get(stream_id, (0, 0))
        out = self.steps[idx].source_done(sub_stream, channel)
        return self._cascade(idx + 1, out, channel)

    def done(self, channel) -> Optional[List[DeviceBatch]]:
        # interior members learn "main input exhausted" here: each member's
        # done() output feeds the rest of the chain before the next member
        # finalizes, the order the unfused actors would deliver it in
        pending: List[DeviceBatch] = []
        for m in self.steps:
            outs: List[DeviceBatch] = []
            for b in pending:
                o = m.execute([b], 0, channel)
                if o is not None:
                    outs.append(o)
            d = m.done(channel)
            if d is not None:
                outs.extend(o for o in ([d] if isinstance(d, DeviceBatch) else d)
                            if o is not None)
            pending = outs
        return pending or None
