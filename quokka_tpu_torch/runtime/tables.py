"""Control-plane tables (port of ``quokka_tpu/runtime/tables.py``, the
in-process store).

The reference keeps scheduler state in prefix-namespaced tables behind a
ControlStore interface.  This slice keeps the tables the happy path reads
and writes -- NTT (task queues), LT (lineage), LIT (last seq), DST (done
channels), GIT (generated inputs), PFT (partition specs), AST (stages),
EWT (consumption watermarks) -- and ADT, the adaptive-exchange records
(``planner/adapt.py``): (src actor, tgt actor) -> {mode, fat, from_seq}, a
routing rewrite written before the first rerouted batch ships, read by the
partition functions.  All in one process, under one lock.  Namespaces, the
served store and the recovery tables come with later slices.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Any, Dict

_SET_TABLES = ("DST", "GIT")
TABLE_NAMES = ("NTT", "LT", "LIT", "DST", "GIT", "PFT", "AST", "EWT", "ADT")


class ControlStore:
    def __init__(self):
        self._lock = threading.RLock()
        self.tables: Dict[str, Any] = {name: {} for name in TABLE_NAMES}
        self.tables["NTT"] = defaultdict(deque)
        for name in _SET_TABLES:
            self.tables[name] = defaultdict(set)

    @contextmanager
    def transaction(self):
        with self._lock:
            yield self

    def ntt_push(self, node, task) -> None:
        with self._lock:
            self.tables["NTT"][node].append(task)

    def ntt_pop(self, node):
        with self._lock:
            q = self.tables["NTT"][node]
            return q.popleft() if q else None

    def ntt_total(self) -> int:
        with self._lock:
            return sum(len(q) for q in self.tables["NTT"].values())

    def tset(self, table: str, key, value) -> None:
        with self._lock:
            self.tables[table][key] = value

    def tget(self, table: str, key, default=None):
        with self._lock:
            return self.tables[table].get(key, default)

    def titems(self, table: str):
        with self._lock:
            return list(self.tables[table].items())

    def sadd(self, table: str, key, value=None) -> None:
        with self._lock:
            self.tables[table][key].add(value)

    def scontains(self, table: str, key, value=None) -> bool:
        with self._lock:
            return value in self.tables[table].get(key, ())
