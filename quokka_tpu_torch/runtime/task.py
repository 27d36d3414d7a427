"""Task types (port of ``quokka_tpu/runtime/task.py``, happy-path subset).

TapedInputTask reads one lineage entry per step; ExecutorTask advances an
operator channel one input-batch-set at a time.  Object names are 6-tuples
(source_actor, source_channel, seq, target_actor, partition_fn,
target_channel), as in the reference.  The replay task types come with the
fault-tolerance slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class TapedInputTask:
    actor: int
    channel: int
    tape: List[int]  # remaining seq numbers to generate, in order
    name = "input"

    def current_seq(self) -> Optional[int]:
        return self.tape[0] if self.tape else None

    def peek_next_seq(self) -> Optional[int]:
        """Seq after the current one (the IO prefetch looks one step ahead)."""
        return self.tape[1] if len(self.tape) > 1 else None

    def advance(self) -> "TapedInputTask":
        return TapedInputTask(self.actor, self.channel, self.tape[1:])


@dataclasses.dataclass
class ExecutorTask:
    actor: int
    channel: int
    state_seq: int
    out_seq: int
    # {source_actor: {source_channel: next_seq_needed}}
    input_reqs: Dict[int, Dict[int, int]]
    name = "exec"

    def advance(self, consumed: Dict[int, Dict[int, int]], new_out_seq: int) -> "ExecutorTask":
        reqs = {a: dict(chs) for a, chs in self.input_reqs.items()}
        for a, chs in consumed.items():
            for ch, nxt in chs.items():
                reqs[a][ch] = nxt
        return ExecutorTask(self.actor, self.channel, self.state_seq + 1, new_out_seq, reqs)
