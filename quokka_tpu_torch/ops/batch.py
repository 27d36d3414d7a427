"""Device-resident columnar batch (PyTorch port of ``quokka_tpu/ops/batch.py``).

A batch is a dict of padded torch tensors plus a validity mask, all on one
device.  Strings are dictionary-encoded on the host: the device sees int32
codes; the dictionary (unique values) and their 64-bit FNV hashes, split
into two int32 limbs, stay on the host and are gathered by code.

Dtypes follow the reference's x64 regime natively: ints int64, floats
float64, dates int32 days, bools bool, string codes int32.  Nulls are the
reference's sentinels: NaN, INT64_MIN / INT32_MIN, code -1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# String dictionaries
# ---------------------------------------------------------------------------

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(s) -> int:
    """Stable 64-bit FNV-1a hash (process-independent, unlike Python hash()).
    Accepts str or bytes."""
    h = _FNV_OFFSET
    data = (
        s if isinstance(s, (bytes, bytearray))
        else s.encode("utf-8", errors="surrogatepass")
    )
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _hash_strings(values: Sequence) -> np.ndarray:
    return np.array([fnv1a64(v) if v is not None else 0 for v in values],
                    dtype=np.uint64)


class StringDict:
    """Host-side dictionary for a string column: values (None = null) and
    their 64-bit hashes as two int32 limb arrays."""

    def __init__(self, values: np.ndarray, binary: Optional[bool] = None):
        vals = np.asarray(values, dtype=object)
        if len(vals) == 0:
            # a dictionary is never empty: all-invalid batches get one null
            # slot so every consumer can gather by clamped code
            vals = np.array([None], dtype=object)
        self.values = vals
        if binary is None:
            binary = next(
                (isinstance(v, (bytes, bytearray)) for v in vals if v is not None),
                False,
            )
        self.binary = bool(binary)
        self._h64: Optional[np.ndarray] = None
        self._none: Optional[np.ndarray] = None
        self._none_known = False
        self._dev: Dict[tuple, torch.Tensor] = {}
        # dictionary transforms of these values (expr_compile._dict_transform)
        self._transforms: Dict[tuple, tuple] = {}

    def __len__(self) -> int:
        return len(self.values)

    @property
    def h64(self) -> np.ndarray:
        if self._h64 is None:
            self._h64 = _hash_strings(self.values)
        return self._h64

    @property
    def hash_hi(self) -> np.ndarray:
        return (self.h64 >> np.uint64(32)).astype(np.uint32).astype(np.int32)

    @property
    def hash_lo(self) -> np.ndarray:
        return (self.h64 & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)

    def code_of(self, literal: str) -> int:
        hits = np.nonzero(self.values == literal)[0]
        return int(hits[0]) if len(hits) else -1

    @property
    def none_entries(self) -> Optional[np.ndarray]:
        """Bool mask of None (null) entries, or None when there are none."""
        if not self._none_known:
            m = np.array([x is None for x in self.values], dtype=bool)
            self._none = m if m.any() else None
            self._none_known = True
        return self._none

    def on_device(self, what: str, device: torch.device) -> torch.Tensor:
        """A host-side per-entry array ('hi', 'lo', 'none') uploaded once per
        device and cached on the dictionary."""
        key = (what, str(device))
        t = self._dev.get(key)
        if t is None:
            host = {"hi": self.hash_hi, "lo": self.hash_lo,
                    "none": self.none_entries}[what]
            t = torch.from_numpy(np.ascontiguousarray(host)).to(device)
            self._dev[key] = t
        return t


# ---------------------------------------------------------------------------
# Columns
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NumCol:
    """Numeric / boolean / date column.  kind: 'f' float, 'i' int, 'b' bool,
    'd' date32 days, 't' timestamp."""

    data: torch.Tensor
    kind: str = "f"
    unit: Optional[str] = None  # timestamp unit

    @property
    def padded_len(self) -> int:
        return self.data.shape[0]

    def take(self, idx: torch.Tensor) -> "NumCol":
        return NumCol(self.data[idx], self.kind, self.unit)


@dataclasses.dataclass
class StrCol:
    """Dictionary-encoded string column: int32 codes on device, dict on host."""

    codes: torch.Tensor
    dictionary: StringDict

    @property
    def padded_len(self) -> int:
        return self.codes.shape[0]

    def hash_limbs(self):
        """Two int32 tensors (hi, lo) of the 64-bit value hash per row.  Null
        rows (code < 0) hash to (0, 0), the pair None entries get."""
        dev = self.codes.device
        c = torch.clamp(self.codes, min=0).long()
        isnull = self.codes < 0
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        hi = torch.where(isnull, zero, self.dictionary.on_device("hi", dev)[c])
        lo = torch.where(isnull, zero, self.dictionary.on_device("lo", dev)[c])
        return hi, lo

    def take(self, idx: torch.Tensor) -> "StrCol":
        return StrCol(self.codes[idx], self.dictionary)


@dataclasses.dataclass
class VecCol:
    """Fixed-width vector (embedding) column: a ``[padded_rows, dim]``
    tensor, float64 in the x64 regime.  The bridge's target for Arrow
    ``fixed_size_list<float>`` columns and the input of vector search
    (K21, ``ops/vector.py``).  A null row is a zero vector."""

    data: torch.Tensor  # [padded_rows, dim]

    @property
    def padded_len(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    def take(self, idx: torch.Tensor) -> "VecCol":
        return VecCol(self.data[idx])


Column = object  # NumCol | StrCol | VecCol

NULL_I32 = -(2**31)
NULL_I64 = -(2**63)


def int_sentinel(dtype: torch.dtype) -> int:
    return NULL_I64 if dtype == torch.int64 else NULL_I32


def null_mask(col) -> torch.Tensor:
    """Per-row null mask for any column kind."""
    if isinstance(col, StrCol):
        isnull = col.codes < 0
        none = col.dictionary.none_entries
        if none is not None:
            table = col.dictionary.on_device("none", col.codes.device)
            isnull = isnull | table[torch.clamp(col.codes, min=0).long()]
        return isnull
    if isinstance(col, VecCol) or col.kind == "b":
        return torch.zeros(col.padded_len, dtype=torch.bool, device=col.data.device)
    if col.kind == "f":
        return torch.isnan(col.data)
    return col.data == int_sentinel(col.data.dtype)


def with_nulls(col, null_where: torch.Tensor):
    """``col`` with the rows of ``null_where`` set to null: NaN for floats,
    the int sentinel for ints and dates, code -1 for strings; bools have no
    spare value and become int32 0/1 with the int32 sentinel; a null vector
    is a zero vector."""
    if isinstance(col, StrCol):
        return StrCol(torch.where(null_where, torch.full_like(col.codes, -1), col.codes),
                      col.dictionary)
    if isinstance(col, VecCol):
        return VecCol(torch.where(null_where[:, None], torch.zeros_like(col.data), col.data))
    data = col.data
    if col.kind == "f":
        return NumCol(torch.where(null_where, torch.full_like(data, float("nan")), data),
                      "f", col.unit)
    if col.kind == "b":
        data = data.to(torch.int32)
        return NumCol(torch.where(null_where, torch.full_like(data, NULL_I32), data), "i")
    sent = torch.full_like(data, int_sentinel(data.dtype))
    return NumCol(torch.where(null_where, sent, data), col.kind, col.unit)


# ---------------------------------------------------------------------------
# Batch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceBatch:
    """A padded columnar batch.  ``valid`` marks live rows; every kernel
    respects it.  ``nrows`` is the host-known live count (None after
    device-side filtering until read); ``nrows_dev`` a device scalar of it."""

    columns: Dict[str, Column]
    valid: torch.Tensor  # bool[padded]
    nrows: Optional[int] = None
    sorted_by: Optional[List[str]] = None
    nrows_dev: Optional[torch.Tensor] = None

    @property
    def padded_len(self) -> int:
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def count_valid(self) -> int:
        if self.nrows is None:
            src = self.nrows_dev if self.nrows_dev is not None else self.valid.sum()
            self.nrows = int(src)
        return self.nrows

    def note_count(self, num: torch.Tensor) -> "DeviceBatch":
        """Record a device scalar as this batch's live count (read lazily)."""
        self.nrows_dev = num
        return self

    def select(self, names: Sequence[str]) -> "DeviceBatch":
        return DeviceBatch({n: self.columns[n] for n in names}, self.valid,
                           self.nrows, self.sorted_by, self.nrows_dev)

    def with_column(self, name: str, col: Column) -> "DeviceBatch":
        cols = dict(self.columns)
        cols[name] = col
        return DeviceBatch(cols, self.valid, self.nrows, self.sorted_by,
                           self.nrows_dev)

    def rename(self, mapping: Dict[str, str]) -> "DeviceBatch":
        return DeviceBatch({mapping.get(n, n): c for n, c in self.columns.items()},
                           self.valid, self.nrows, self.sorted_by, self.nrows_dev)

    def take(self, idx: torch.Tensor, valid: torch.Tensor,
             nrows: Optional[int]) -> "DeviceBatch":
        return DeviceBatch(gather_columns(self.columns, idx), valid, nrows,
                           self.sorted_by)


def gather_columns(columns: Dict[str, Column], idx: torch.Tensor) -> Dict[str, Column]:
    """Row-gather a whole column dict at one index vector.

    The reference fuses this into one XLA program (``_gather_all``); here it
    is one ``index_select`` per column, a plain gather."""
    idx = idx.long()
    out: Dict[str, Column] = {}
    for n, c in columns.items():
        if isinstance(c, StrCol):
            out[n] = StrCol(c.codes.index_select(0, idx), c.dictionary)
        elif isinstance(c, VecCol):
            out[n] = VecCol(c.data.index_select(0, idx))
        else:
            out[n] = NumCol(c.data.index_select(0, idx), c.kind, c.unit)
    return out


def key_limbs(batch: DeviceBatch, cols: Sequence[str]) -> List[torch.Tensor]:
    """Key columns as equality limbs: strings become their two hash limbs,
    numeric columns their native-width data."""
    limbs: List[torch.Tensor] = []
    for name in cols:
        c = batch.columns[name]
        if isinstance(c, StrCol):
            hi, lo = c.hash_limbs()
            limbs.append(hi)
            limbs.append(lo)
        else:
            limbs.append(c.data)
    return limbs
