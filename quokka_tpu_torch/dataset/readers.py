"""Input readers (port of ``quokka_tpu/dataset/readers.py``: in-memory and
Parquet inputs).

Reader protocol, as the reference's:
  get_own_state(num_channels) -> {channel: [lineage, ...]}
  execute(channel, lineage)   -> a ``bridge.HostTable`` (numpy) or a
                                 pyarrow Table
Lineage entries are small, picklable descriptions of an input slice.
pyarrow is imported only by the readers that take Arrow or Parquet input.

The Parquet reader reads one segment ahead on a small host pool
(``_Readahead``) and names the bytes of each lineage (``cache_key``) for
the engine's scan cache (``runtime/scancache.py``); the in-memory readers
name none and bypass it.
"""

from __future__ import annotations

import collections
import datetime
import functools
import glob as globmod
import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from quokka_tpu_torch.expression import (
    BinOp,
    ColRef,
    DateLit,
    Expr,
    Literal,
    split_conjuncts,
)
from quokka_tpu_torch.ops.bridge import HostTable


def _row_slices(n: int, batch_rows: int, num_channels: int) -> Dict[int, List]:
    slices = [(s, min(batch_rows, n - s)) for s in range(0, n, batch_rows)] or [(0, 0)]
    return {ch: slices[ch::num_channels] for ch in range(num_channels)}


class InputHostDataset:
    """An in-memory numpy table split into row slices (from_pandas, and any
    caller holding numpy arrays)."""

    def __init__(self, table: HostTable, batch_rows: int = 1 << 20):
        self.table = table
        self.batch_rows = batch_rows

    @property
    def schema(self) -> List[str]:
        return self.table.column_names

    def get_own_state(self, num_channels: int) -> Dict[int, List]:
        return _row_slices(self.table.num_rows, self.batch_rows, num_channels)

    def execute(self, channel: int, lineage) -> HostTable:
        start, length = lineage
        return self.table.slice(start, length)


class InputArrowDataset:
    """An in-memory pyarrow Table split into row slices (from_arrow)."""

    def __init__(self, table, batch_rows: int = 1 << 20):
        self.table = table
        self.batch_rows = batch_rows

    @property
    def schema(self):
        return self.table.schema

    def get_own_state(self, num_channels: int) -> Dict[int, List]:
        return _row_slices(self.table.num_rows, self.batch_rows, num_channels)

    def execute(self, channel: int, lineage):
        start, length = lineage
        return self.table.slice(start, length)


class _Readahead:
    """One-segment scan readahead: while a channel's current batch lands
    and computes, the channel's next lineage is read on a small host pool,
    so a cold scan overlaps its reads with the engine's work.  A slot is
    served only to the dataset object that armed it, for the lineage it was
    armed for, and while the file's identity (``_file_ident``, taken before
    the read) is unchanged: a rewritten file, or a later dataset that
    reuses a dead one's ``id``, reads anew.  A mismatched or failed slot
    falls back to the synchronous read, which raises a read error again.
    One slot per (dataset, channel); the slot table is FIFO-bounded, so
    dead datasets cannot pin read tables.  The pool reads on the host only."""

    _MAX_SLOTS = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._slots: "collections.OrderedDict" = collections.OrderedDict()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=2,
                                                thread_name_prefix="quokka-readahead")
            return self._pool

    def take(self, ds, channel: int, lineage, ident):
        """The table read ahead for this exact dataset, lineage and file
        identity, or None."""
        with self._lock:
            ent = self._slots.pop((id(ds), channel), None)
        if ent is None:
            return None
        ref, armed_lineage, armed_ident, fut = ent
        if ref() is not ds or armed_lineage != lineage or ident is None \
                or armed_ident != ident:
            return None
        try:
            return fut.result()
        except Exception:
            return None  # the synchronous read raises it again

    def arm(self, ds, channel: int, lineage, ident, read_fn) -> None:
        if ident is None:
            return  # no identity to check the slot against
        fut = self._ensure_pool().submit(read_fn)
        with self._lock:
            self._slots[(id(ds), channel)] = (weakref.ref(ds), lineage, ident, fut)
            while len(self._slots) > self._MAX_SLOTS:
                self._slots.popitem(last=False)


_READAHEAD = _Readahead()


def _file_ident(path: str):
    """(mtime_ns, size) of a file, or None when it cannot be read."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_mtime_ns, st.st_size


def _successor_map(state: Dict[int, List]) -> Dict:
    """(channel, lineage) -> the channel's next lineage."""
    succ = {}
    for ch, pieces in state.items():
        for cur, nxt in zip(pieces, pieces[1:]):
            succ[(ch, cur)] = nxt
    return succ


def _expand_paths(path) -> List[str]:
    if isinstance(path, (list, tuple)):
        out = []
        for p in path:
            out.extend(_expand_paths(p))
        return out
    if os.path.isdir(path):
        return sorted(
            p for p in globmod.glob(os.path.join(path, "**", "*"), recursive=True)
            if os.path.isfile(p)
        )
    matches = sorted(globmod.glob(path))
    return matches if matches else [path]


class InputParquetDataset:
    """Local Parquet reader: channels own (file, row_group) pairs; column
    pushdown and row-group skipping from min/max statistics."""

    def __init__(self, path, columns: Optional[Sequence[str]] = None,
                 predicate: Optional[Expr] = None):
        self.path = path
        self.columns = list(columns) if columns else None
        self.predicate = predicate
        # ANN pushdown (optimizer.push_ann): (queries, nprobe) restricts the
        # scan to the row groups owning the queries' closest IVF cells when
        # a sidecar index exists (dataset/vector.py)
        self.ann_prune = None
        self._dict_cols: Dict[str, List[str]] = {}  # file -> its string columns

    @property
    def schema(self):
        import pyarrow.parquet as pq

        return pq.ParquetFile(_expand_paths(self.path)[0]).schema_arrow

    def get_own_state(self, num_channels: int) -> Dict[int, List]:
        import pyarrow.parquet as pq

        pieces = []
        for f in _expand_paths(self.path):
            keep = None
            if self.ann_prune is not None:
                from quokka_tpu_torch.dataset.vector import prune_row_groups

                keep = prune_row_groups(f, *self.ann_prune)
                keep = None if keep is None else {int(i) for i in keep}
            meta = pq.ParquetFile(f).metadata
            for rg in range(meta.num_row_groups):
                if keep is not None and rg not in keep:
                    continue
                if self.predicate is not None and _rowgroup_prunable(
                        meta.row_group(rg), self.predicate):
                    continue
                pieces.append((f, rg))
        state = {ch: pieces[ch::num_channels] for ch in range(num_channels)}
        self._succ = _successor_map(state)
        return state

    def execute(self, channel: int, lineage):
        table = _READAHEAD.take(self, channel, lineage, _file_ident(lineage[0]))
        if table is None:
            table = self._read(lineage)
        nxt = getattr(self, "_succ", {}).get((channel, lineage))
        if nxt is not None:
            # the identity is taken before the read, so bytes of a file
            # rewritten under the read do not match it afterwards
            _READAHEAD.arm(self, channel, nxt, _file_ident(nxt[0]),
                           functools.partial(self._read, nxt))
        return table

    def _read(self, lineage):
        import pyarrow as pa
        import pyarrow.parquet as pq

        f, rg = lineage
        # dictionary-encoded string pages come back as DictionaryArray: the
        # bridge then skips a host-side re-encode
        dict_cols = self._dict_cols.get(f)
        if dict_cols is None:
            dict_cols = self._dict_cols[f] = [
                fld.name for fld in pq.read_schema(f)
                if pa.types.is_string(fld.type) or pa.types.is_large_string(fld.type)]
        return pq.ParquetFile(f, read_dictionary=dict_cols).read_row_group(
            rg, columns=self.columns)

    def cache_key(self, channel: int, lineage):
        """The scan cache's identity of this lineage's bytes: mtime_ns and
        size guard against serving a rewritten file."""
        f, rg = lineage
        ident = _file_ident(f)
        if ident is None:
            return None
        return ("parquet", f, rg, *ident, tuple(self.columns) if self.columns else None)


def _rowgroup_prunable(rg_meta, predicate: Expr) -> bool:
    """True if row-group min/max stats prove no row satisfies the predicate."""
    stats = {}
    for i in range(rg_meta.num_columns):
        col = rg_meta.column(i)
        if col.statistics is not None and col.statistics.has_min_max:
            stats[col.path_in_schema] = (col.statistics.min, col.statistics.max)
    return any(_conjunct_excludes(c, stats) for c in split_conjuncts(predicate))


def _conjunct_excludes(conj: Expr, stats) -> bool:
    if not isinstance(conj, BinOp) or conj.op not in ("<", "<=", ">", ">=", "="):
        return False
    left, right, op = conj.left, conj.right, conj.op
    if not isinstance(left, ColRef):
        left, right = right, left
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}[op]
    if not isinstance(left, ColRef) or left.name not in stats:
        return False
    mn, mx = stats[left.name]
    if isinstance(right, DateLit):
        val = right.days
        if not isinstance(mn, datetime.date):
            return False
        mn = (mn - datetime.date(1970, 1, 1)).days
        mx = (mx - datetime.date(1970, 1, 1)).days
    elif isinstance(right, Literal) and isinstance(right.value, (int, float)):
        val = right.value
        if not isinstance(mn, (int, float)):
            return False
    else:
        return False
    return {"<": mn >= val, "<=": mn > val, ">": mx <= val, ">=": mx < val,
            "=": val < mn or val > mx}[op]
