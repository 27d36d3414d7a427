"""Per-backend, per-operator kernel-strategy matrix (port of
``quokka_tpu/ops/strategy.py``: the matrix, its default rows, the forced
override and the record of what ran).

``choice(op)`` resolves an operator's strategy:
  1. ``QK_KERNEL_STRATEGY="op=choice,..."``, a forced override (tests,
     experiments).  An unknown operator or choice raises ``StrategyError``:
     a forced choice that silently no-ops is how wrong benchmarks happen.
  2. the static per-platform default row (``gpu`` when a CUDA device is
     present, else ``cpu``).

The CPU row takes ``asof=searchsorted``: the reference's ``host`` asof
(its native merge) is not ported, and forcing it raises
(``ops/asof.asof_join``).  The reference's calibration profile
(micro-timing every candidate on live arrays) is not ported yet; the
defaults are its pre-calibration rows.
``note_used(op, choice)`` records what actually ran: a diverged hash build
reports the sorted probe that served it, not the hashtable the matrix asked
for.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import torch

OPS: Dict[str, Tuple[str, ...]] = {
    "groupby": ("sort", "hashtable"),
    "join_build": ("sort", "hashtable"),
    "asof": ("host", "sort", "searchsorted"),
    "asof_probe": ("eager", "coalesced"),
    "shuffle": ("masked", "compacted"),
}

_PLATFORM_DEFAULTS: Dict[str, Dict[str, str]] = {
    "cpu": {"groupby": "hashtable", "join_build": "hashtable",
            "asof": "searchsorted", "asof_probe": "coalesced", "shuffle": "masked"},
    "gpu": {"groupby": "hashtable", "join_build": "hashtable",
            "asof": "searchsorted", "asof_probe": "coalesced",
            "shuffle": "masked"},
}

_lock = threading.Lock()
# parsed QK_KERNEL_STRATEGY, keyed by the raw env string so a changed env is
# seen on the next call
_env_cache: Tuple[Optional[str], Dict[str, str]] = (None, {})
_used: Dict[str, list] = {}


class StrategyError(ValueError):
    """Malformed QK_KERNEL_STRATEGY / unknown operator or choice."""


def _validate(op: str, choice_: str, origin: str) -> None:
    if op not in OPS:
        raise StrategyError(f"{origin}: unknown operator {op!r} (known: {sorted(OPS)})")
    if choice_ not in OPS[op]:
        raise StrategyError(
            f"{origin}: unknown choice {choice_!r} for {op!r} (known: {OPS[op]})")


def _env_overrides() -> Dict[str, str]:
    global _env_cache
    raw = os.environ.get("QK_KERNEL_STRATEGY")
    cached_raw, cached = _env_cache
    if raw == cached_raw:
        return cached
    parsed: Dict[str, str] = {}
    for item in (raw or "").split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise StrategyError(f"QK_KERNEL_STRATEGY: expected op=choice, got {item!r}")
        op, _, ch = item.partition("=")
        op, ch = op.strip(), ch.strip()
        _validate(op, ch, "QK_KERNEL_STRATEGY")
        parsed[op] = ch
    _env_cache = (raw, parsed)
    return parsed


def platform() -> str:
    return "gpu" if torch.cuda.is_available() else "cpu"


def resolve(op: str) -> Tuple[str, str]:
    """(choice, source) for an operator; source is "env" or "default"."""
    if op not in OPS:
        raise StrategyError(f"unknown operator {op!r} (known: {sorted(OPS)})")
    env = _env_overrides()
    if op in env:
        return env[op], "env"
    return _PLATFORM_DEFAULTS[platform()][op], "default"


def choice(op: str) -> str:
    return resolve(op)[0]


def note_used(op: str, ran: str) -> None:
    """Record that a dispatch site actually executed ``ran`` for ``op``."""
    with _lock:
        ops_ran = _used.setdefault(op, [])
        if ran not in ops_ran:
            ops_ran.append(ran)


def used_snapshot() -> Dict[str, str]:
    """{op: choice} of what ran since the last reset ('+'-joined when more
    than one kernel ran for an op)."""
    with _lock:
        return {op: "+".join(sorted(v)) for op, v in _used.items()}


def reset_used() -> None:
    with _lock:
        _used.clear()
