"""Sorted input readers (port of ``quokka_tpu/dataset/ordered.py``).

A sorted reader hands its channels lineages in global time order, dealt
either round-robin ("stride": channel c holds pieces c, c + n, ...; the
batch cache's sorted plan delivers them back in global (seq, channel)
order) or as contiguous time ranges ("range": channel c holds the c-th
run of pieces).  Two readers:

- ``InputSortedHostDataset``: a numpy ``HostTable`` sorted by one column,
  cut into row slices (no Arrow: what the card's machine runs);
- ``InputSortedParquetDataset``: Parquet row groups ordered by their min /
  max statistics on the sort column, non-overlap asserted (pyarrow is
  imported only when it is used).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from quokka_tpu_torch.dataset.readers import (
    InputHostDataset,
    InputParquetDataset,
    _expand_paths,
    _rowgroup_prunable,
)
from quokka_tpu_torch.ops.bridge import HostTable

MODES = ("stride", "range")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"sorted reader mode {mode!r}: expected one of {MODES}")


def assign_channels(lineages: Sequence, num_channels: int, mode: str) -> Dict[int, List]:
    """Deal time-ordered lineages to channels: round-robin ("stride") or in
    contiguous runs ("range")."""
    lineages = list(lineages)
    if mode == "stride":
        return {ch: lineages[ch::num_channels] for ch in range(num_channels)}
    per = (len(lineages) + num_channels - 1) // max(num_channels, 1)
    return {ch: lineages[ch * per:(ch + 1) * per] for ch in range(num_channels)}


class InputSortedHostDataset(InputHostDataset):
    """A numpy table sorted by ``sorted_by``, read in ``batch_rows`` slices
    dealt to channels in ``mode``.  The order is checked once, on the host,
    when the plan is built."""

    def __init__(self, table: HostTable, sorted_by: str, batch_rows: int = 1 << 20,
                 mode: str = "stride"):
        super().__init__(table, batch_rows)
        _check_mode(mode)
        self.sorted_by = sorted_by
        self.mode = mode

    def get_own_state(self, num_channels: int) -> Dict[int, List]:
        col = np.asarray(self.table.columns[self.sorted_by])
        if len(col) > 1 and bool(np.any(col[1:] < col[:-1])):
            raise ValueError(f"table is not sorted by {self.sorted_by}")
        n = self.table.num_rows
        slices = [(s, min(self.batch_rows, n - s)) for s in range(0, n, self.batch_rows)]
        return assign_channels(slices or [(0, 0)], num_channels, self.mode)


class InputSortedParquetDataset(InputParquetDataset):
    """Parquet row groups in time order: ordered by their min statistics on
    ``sorted_by``, with overlapping row groups refused."""

    def __init__(self, path, sorted_by: str, columns=None, predicate=None,
                 mode: str = "stride"):
        super().__init__(path, columns=columns, predicate=predicate)
        _check_mode(mode)
        self.sorted_by = sorted_by
        self.mode = mode

    def get_own_state(self, num_channels: int) -> Dict[int, List]:
        import pyarrow.parquet as pq

        pieces = []  # (min, max, file, row group)
        for f in _expand_paths(self.path):
            meta = pq.ParquetFile(f).metadata
            col_idx = ({meta.row_group(0).column(i).path_in_schema: i
                        for i in range(meta.num_columns)} if meta.num_row_groups else {})
            if meta.num_row_groups and self.sorted_by not in col_idx:
                raise ValueError(f"sort column {self.sorted_by} not in {f}")
            for rg in range(meta.num_row_groups):
                rgm = meta.row_group(rg)
                st = rgm.column(col_idx[self.sorted_by]).statistics
                if st is None or not st.has_min_max:
                    raise ValueError(f"row group {rg} of {f} lacks min/max statistics on "
                                     f"{self.sorted_by}; cannot order")
                if self.predicate is not None and _rowgroup_prunable(rgm, self.predicate):
                    continue
                pieces.append((st.min, st.max, f, rg))
        pieces.sort(key=lambda p: p[0])
        for a, b in zip(pieces, pieces[1:]):
            if a[1] > b[0]:
                raise ValueError(f"row groups overlap on {self.sorted_by}: "
                                 f"[{a[0]}, {a[1]}] vs [{b[0]}, {b[1]}]")
        return assign_channels([(f, rg) for _, _, f, rg in pieces], num_channels, self.mode)
