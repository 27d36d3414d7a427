"""Result dataset (port of ``quokka_tpu/runtime/dataset.py``): collects a
blocking node's outputs as host numpy column dicts keyed by (channel, seq)."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class ResultDataset:
    def __init__(self, name: str = "result", schema: Optional[List[str]] = None):
        self.name = name
        self.schema = list(schema or [])
        self._lock = threading.Lock()
        self._tables: Dict[int, Dict[int, Dict[str, np.ndarray]]] = defaultdict(dict)

    def append(self, channel: int, columns: Dict[str, np.ndarray],
               seq: Optional[int] = None) -> None:
        with self._lock:
            if seq is None:
                seq = len(self._tables[channel])
            self._tables[channel][seq] = columns

    def _parts(self) -> List[Dict[str, np.ndarray]]:
        with self._lock:
            return [self._tables[ch][s] for ch in sorted(self._tables)
                    for s in sorted(self._tables[ch])]

    def to_numpy(self) -> Optional[Dict[str, np.ndarray]]:
        """All rows as one dict of numpy arrays (None when nothing arrived)."""
        parts = self._parts()
        if not parts:
            return None
        names = list(parts[0])
        return {n: np.concatenate([p[n] for p in parts]) for n in names}

    def to_df(self):
        from quokka_tpu_torch.ops import bridge

        cols = self.to_numpy()
        if cols is None:
            import pandas as pd

            return pd.DataFrame(columns=self.schema)
        return bridge.to_pandas(cols)

    def to_arrow(self):
        import pyarrow as pa

        cols = self.to_numpy()
        if cols is None:
            return None
        return pa.table({n: pa.FixedSizeListArray.from_arrays(pa.array(a.reshape(-1)), a.shape[1])
                         if a.ndim == 2 else pa.array(a, from_pandas=True)
                         for n, a in cols.items()})
