"""Device-resident scan (buffer-pool) cache (port of
``quokka_tpu/runtime/scancache.py``).

The role a buffer pool plays in a CPU database: hot table segments stay
resident, so a repeated scan skips its IO.  The cached unit is the landed
``DeviceBatch``: decoded, dictionary-encoded, narrowed, copied to the
device and decoded by K23.  A warm re-scan of an unchanged file skips the
Parquet decode, the host encode and the host -> device copy.

Correctness: an entry is keyed by the reader's identity of the bytes under
it (path, row group, mtime_ns, size, columns) with the plan's projection,
sort columns and device, so a rewritten file never serves stale rows.
Readers opt in through ``cache_key(channel, lineage)``; one whose bytes
have no such identity (an in-memory table) returns no key and bypasses the
cache.  Capped by bytes with LRU eviction, host-resident and card-resident
batches each against a cap of their own: ``QUOKKA_SCAN_CACHE_BYTES`` (the
reference's setting; 0 disables) for both, else the reference's defaults,
256 MiB of host memory and 2 GiB on the card.

In-place writes: the reference's columns are immutable JAX arrays; torch
tensors are not.  The cache hands out a shallow copy of the batch (callers
attach their own row counts), ``put`` records every cached tensor's
version counter, and ``get`` raises when one has moved: a cached column
was written in place, and serving it would give a wrong answer.  A kernel
that writes through a raw pointer moves no version counter; none of the
port's kernels writes into the batches it reads (each writes tensors its
wrapper allocates).

``GLOBAL`` is process-global and thread-safe: the engine's IO threads look
it up and fill it.  Accounting is per query (``get(..., query=)`` feeds
``stats()["by_query"]``; ``drop_query`` forgets a finished query's).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from quokka_tpu_torch.ops.batch import DeviceBatch, StrCol


def _default_caps() -> Dict[str, int]:
    env = os.environ.get("QUOKKA_SCAN_CACHE_BYTES")
    if env is not None:
        return {"cpu": int(env), "cuda": int(env)}
    # the card holds 80 GB; host-resident batches get a modest cap, so tests
    # and small hosts are not pinned by cached scans
    return {"cpu": 256 << 20, "cuda": 2 << 30}


def _kind(batch: DeviceBatch) -> str:
    return "cuda" if batch.valid.is_cuda else "cpu"


def _tensors(batch: DeviceBatch) -> List[torch.Tensor]:
    ts = [batch.valid]
    ts.extend(c.codes if isinstance(c, StrCol) else c.data for c in batch.columns.values())
    if batch.nrows_dev is not None:
        ts.append(batch.nrows_dev)
    return ts


def _batch_nbytes(batch: DeviceBatch) -> int:
    """Bytes a cached batch keeps alive: each distinct storage under its
    tensors once (a column that travelled unnarrowed is a view into its
    batch's copied wire buffer, which it keeps whole)."""
    storages = {}
    for t in _tensors(batch):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values())


def _snapshot(batch: DeviceBatch) -> DeviceBatch:
    return DeviceBatch(dict(batch.columns), batch.valid, batch.nrows, batch.sorted_by,
                       batch.nrows_dev)


class ScanCache:
    """``cap_bytes``, where given, caps host-resident and card-resident
    batches alike; else ``_default_caps``."""

    def __init__(self, cap_bytes: Optional[int] = None):
        self.caps = (_default_caps() if cap_bytes is None
                     else {"cpu": cap_bytes, "cuda": cap_bytes})
        self._lock = threading.Lock()
        # key -> (batch, bytes, the version counter of each of its tensors)
        self._data: "OrderedDict[Tuple, Tuple[DeviceBatch, int, List[int]]]" = OrderedDict()
        self._bytes = {"cpu": 0, "cuda": 0}  # by where the batches lie
        self.hits = 0
        self.misses = 0
        self._by_query: dict = {}  # query id -> {"hits": n, "misses": n}

    @property
    def enabled(self) -> bool:
        return max(self.caps.values()) > 0

    def _account(self, query: Optional[str], field: str) -> None:
        if query is None:
            return
        q = self._by_query.get(query)
        if q is None:
            q = self._by_query[query] = {"hits": 0, "misses": 0}
        q[field] += 1

    def get(self, key: Tuple, query: Optional[str] = None) -> Optional[DeviceBatch]:
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                self.misses += 1
                self._account(query, "misses")
                return None
            batch, nb, versions = ent
            moved = [i for i, (t, v) in enumerate(zip(_tensors(batch), versions))
                     if t._version != v]
            if moved:
                # never served again: the next read of these bytes lands anew
                del self._data[key]
                self._bytes[_kind(batch)] -= nb
            else:
                self._data.move_to_end(key)
                self.hits += 1
                self._account(query, "hits")
        if moved:
            raise RuntimeError(
                f"scan cache: tensors {moved} of the cached batch {key!r} were written in "
                "place after they were cached; serving them would give a wrong answer")
        return _snapshot(batch)

    def put(self, key: Tuple, batch: DeviceBatch) -> None:
        if not self.enabled:
            return
        kind = _kind(batch)
        nb = _batch_nbytes(batch)
        if nb > self.caps[kind]:
            return
        snap = _snapshot(batch)
        versions = [t._version for t in _tensors(snap)]
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes[_kind(old[0])] -= old[1]
            self._data[key] = (snap, nb, versions)
            self._bytes[kind] += nb
            if self._bytes[kind] > self.caps[kind]:
                # the least recently used batches of the same kind go first
                for k in [k for k, ent in self._data.items() if _kind(ent[0]) == kind]:
                    if self._bytes[kind] <= self.caps[kind]:
                        break
                    self._bytes[kind] -= self._data.pop(k)[1]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = {"cpu": 0, "cuda": 0}

    def drop_query(self, query: str) -> None:
        """Forget a finished query's accounting.  Its cached batches stay:
        they are keyed by file identity and are the warmth the next query
        over the same files wants."""
        with self._lock:
            self._by_query.pop(query, None)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._data), "bytes": sum(self._bytes.values()),
                    "hits": self.hits,
                    "misses": self.misses,
                    "by_query": {q: dict(c) for q, c in self._by_query.items()}}


GLOBAL = ScanCache()


def clear() -> None:
    GLOBAL.clear()
