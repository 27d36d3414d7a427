"""Input readers (port of ``quokka_tpu/dataset/readers.py``: in-memory and
Parquet inputs).

Reader protocol, as the reference's:
  get_own_state(num_channels) -> {channel: [lineage, ...]}
  execute(channel, lineage)   -> a ``bridge.HostTable`` (numpy) or a
                                 pyarrow Table
Lineage entries are small, picklable descriptions of an input slice.
pyarrow is imported only by the readers that take Arrow or Parquet input.
"""

from __future__ import annotations

import datetime
import glob as globmod
import os
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
        return {ch: pieces[ch::num_channels] for ch in range(num_channels)}

    def execute(self, channel: int, lineage):
        import pyarrow as pa
        import pyarrow.parquet as pq

        f, rg = lineage
        # dictionary-encoded string pages come back as DictionaryArray: the
        # bridge then skips a host-side re-encode
        schema = pq.read_schema(f)
        dict_cols = [fld.name for fld in schema
                     if pa.types.is_string(fld.type) or pa.types.is_large_string(fld.type)]
        return pq.ParquetFile(f, read_dictionary=dict_cols).read_row_group(
            rg, columns=self.columns)


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
