"""Window specifications and triggers (a copy of ``quokka_tpu/windows.py``,
which is host-only but cannot be imported without loading JAX).

API parity with the reference's windowtypes (pyquokka/windowtypes.py:6-102):
Hopping/Tumbling/Sliding/Session windows plus OnEventTrigger /
OnCompletionTrigger.  Sizes are expressed in the time column's native units
(int days for date32, the timestamp's unit for timestamps, or plain numbers),
or as IntervalLit for convenience.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

from quokka_tpu_torch.expression import IntervalLit


def _to_units(v) -> int:
    if isinstance(v, IntervalLit):
        if v.months:
            raise ValueError("calendar-month windows not supported")
        return v.micros  # callers scale to the column's unit
    return v


class Window:
    def __init__(self, size_before, size_after=0, hop=None):
        self.size_before = _to_units(size_before)
        self.size_after = _to_units(size_after)
        self.hop = _to_units(hop) if hop is not None else None


class TumblingWindow(Window):
    """Non-overlapping fixed windows: window_id = t // size."""

    def __init__(self, size):
        super().__init__(size)
        self.size = _to_units(size)
        self.hop = self.size


class HoppingWindow(Window):
    """Fixed windows of `size` starting every `hop` (size % hop == 0 keeps the
    replication factor static — a TPU-friendly constraint)."""

    def __init__(self, size, hop):
        size, hop = _to_units(size), _to_units(hop)
        if size % hop != 0:
            raise ValueError("hopping window requires size % hop == 0")
        super().__init__(size, hop=hop)
        self.size = size


class SlidingWindow(Window):
    """Per-event trailing window [t - size_before, t] (groupby_rolling)."""

    def __init__(self, size_before, size_after=0):
        if _to_units(size_after) != 0:
            raise NotImplementedError("forward-looking sliding windows (todo)")
        super().__init__(size_before, size_after)


class SessionWindow(Window):
    """Gap-based sessions: a new session starts when the gap to the previous
    event (per key) exceeds `timeout`."""

    def __init__(self, timeout):
        super().__init__(timeout)
        self.timeout = _to_units(timeout)


class Trigger:
    pass


class OnEventTrigger(Trigger):
    """Emit incrementally as windows complete (watermark-driven)."""


class OnCompletionTrigger(Trigger):
    """Emit everything once the stream ends."""
