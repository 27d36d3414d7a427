"""Host <-> device bridge (PyTorch port of ``quokka_tpu/ops/bridge.py``).

The port's core host format is numpy: a ``HostTable`` is a dict of column
arrays plus optional per-column validity and optional dictionaries for
columns that arrive already dictionary-encoded.  ``host_to_device`` pads
every column to the bucket ladder, writes null sentinels, dictionary-encodes
strings on the host, and lands the whole batch on the device through
``ops/pack.py``: narrowed integer and dictionary-coded float wires, the
validity mask as one count, ONE copy through a pinned staging buffer and
one wire decode (K23 on CUDA).  Arrow and pandas are optional: only
``arrow_to_device`` / ``device_to_arrow`` / ``to_pandas`` import them, and
only when called.

``batch_from_numpy`` takes a batch already in device form (padded arrays,
validity mask, dictionaries) — how a reference ``DeviceBatch`` read back with
``np.asarray`` becomes the port's batch in the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import native, pack
from quokka_tpu_torch.ops.batch import (
    NULL_I32,
    NULL_I64,
    DeviceBatch,
    NumCol,
    StrCol,
    StringDict,
    VecCol,
)

_EPOCH = np.datetime64("1970-01-01", "D")

# launches of K8 (csrc/concat.cu); columns a launch writes (QK_CAT_MAX_COLS);
# K8's part and column descriptors
CONCAT_LAUNCHES = 0
CONCAT_MAX_COLUMNS = 16
_CAT_PART = np.dtype([("valid", "<i8"), ("rows", "<i8")])
_CAT_COL = np.dtype([("dst", "<i8"), ("width", "<i4"), ("unit", "<i4")])


@dataclasses.dataclass
class HostTable:
    """A batch on the host in numpy.

    ``columns``: name -> 1-D array.  Object arrays are strings (None =
    null); ``datetime64[D]`` arrays are dates; a 2-D float array
    ``[rows, dim]`` is a vector column; other dtypes map to ints, floats,
    bools.  ``validity``: name -> bool array, True where non-null.
    ``dictionaries``: name -> values array for a column whose array holds
    int32 codes into it (code -1 = null)."""

    columns: Dict[str, np.ndarray]
    validity: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    dictionaries: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def select(self, names: Sequence[str]) -> "HostTable":
        names = [n for n in names if n in self.columns]
        return HostTable({n: self.columns[n] for n in names},
                         {n: v for n, v in self.validity.items() if n in names},
                         {n: d for n, d in self.dictionaries.items() if n in names})

    def slice(self, start: int, length: int) -> "HostTable":
        end = start + length
        return HostTable({n: a[start:end] for n, a in self.columns.items()},
                         {n: v[start:end] for n, v in self.validity.items()},
                         dict(self.dictionaries))


def _encode_strings(vals: np.ndarray, nullm: Optional[np.ndarray]):
    """Dictionary-encode an object array of strings: (int32 codes, values)."""
    isnull = np.array([v is None for v in vals], dtype=bool)
    if nullm is not None:
        isnull |= nullm
    live = vals[~isnull]
    uniq, inv = np.unique(live.astype(str), return_inverse=True)
    codes = np.full(len(vals), -1, dtype=np.int32)
    codes[~isnull] = inv.astype(np.int32)
    return codes, uniq.astype(object)


def _host_column(name: str, arr: np.ndarray, nullm: Optional[np.ndarray],
                 dictionary: Optional[np.ndarray]):
    """One host column in device form (unpadded): (array, kind, dictionary)."""
    if dictionary is not None:
        codes = np.asarray(arr, dtype=np.int32)
        if nullm is not None:
            codes = np.where(nullm, np.int32(-1), codes)
        return codes, "s", StringDict(np.asarray(dictionary, dtype=object))
    arr = np.asarray(arr)
    if arr.ndim == 2:
        if arr.dtype.kind != "f":
            raise NotImplementedError(f"column {name}: vectors of {arr.dtype}")
        out = arr.astype(np.float64, copy=False)
        if nullm is not None:
            out = np.where(nullm[:, None], 0.0, out)
        return out, "v", None
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        codes, values = _encode_strings(arr.astype(object), nullm)
        return codes, "s", StringDict(values)
    if arr.dtype.kind == "M":
        days = arr.astype("datetime64[D]")
        nat = np.isnat(days)
        out = (days - _EPOCH).astype(np.int64).astype(np.int32)
        nm = nat if nullm is None else (nat | nullm)
        return np.where(nm, np.int32(NULL_I32), out), "d", None
    if arr.dtype == np.bool_:
        out = arr if nullm is None else np.where(nullm, False, arr)
        return out, "b", None
    if arr.dtype.kind in ("i", "u"):
        out = arr.astype(np.int64, copy=False)
        if nullm is not None:
            out = np.where(nullm, np.int64(NULL_I64), out)
        return out, "i", None
    if arr.dtype.kind == "f":
        out = arr.astype(np.float64, copy=False)
        if nullm is not None:
            out = np.where(nullm, np.nan, out)
        return out, "f", None
    raise NotImplementedError(f"column {name}: numpy dtype {arr.dtype} not supported")


def _pad(arr: np.ndarray, padded: int) -> np.ndarray:
    """``arr`` 0-filled to ``padded`` rows (a 2-D array keeps its width),
    before narrowing, as the reference pads: min / max and the wire layouts
    see the same values."""
    if len(arr) == padded:
        return arr
    out = np.zeros((padded,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def host_to_device(table: HostTable, device, sorted_by: Optional[List[str]] = None) -> DeviceBatch:
    """Land a host table on ``device`` as a padded DeviceBatch: one narrowed
    transfer and one wire decode (``ops/pack.py``, K23 on CUDA)."""
    device = torch.device(device)
    n = table.num_rows
    padded = config.bucket_size(n)
    specs = []
    for name, arr in table.columns.items():
        v = table.validity.get(name)
        nullm = None if v is None else ~np.asarray(v, dtype=bool)
        specs.append((name, *_host_column(name, arr, nullm,
                                          table.dictionaries.get(name))))
    landed = pack.pack_put([pack.ValidCount(padded, n)]
                           + [_pad(a, padded) for _, a, _, _ in specs], device)
    cols = {}
    for (name, _, kind, d), t in zip(specs, landed[1:]):
        cols[name] = (StrCol(t, d) if kind == "s" else VecCol(t) if kind == "v"
                      else NumCol(t, kind))
    return DeviceBatch(cols, landed[0], nrows=n, sorted_by=sorted_by)


def batch_from_numpy(columns: Dict[str, np.ndarray], valid: np.ndarray,
                     dictionaries: Optional[Dict[str, Sequence]] = None,
                     kinds: Optional[Dict[str, str]] = None,
                     device="cpu") -> DeviceBatch:
    """A DeviceBatch from arrays already in device form: padded column data
    (null sentinels in place, int32 codes for columns in ``dictionaries``),
    the validity mask, and the dictionaries.  ``kinds`` overrides the kind
    inferred from the dtype (e.g. 'd' for int32 date columns).  A 2-D
    array is a vector column."""
    device = torch.device(device)
    dictionaries = dictionaries or {}
    kinds = kinds or {}
    cols = {}
    for name, arr in columns.items():
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
        if name in dictionaries:
            cols[name] = StrCol(t.to(torch.int32),
                                StringDict(np.asarray(dictionaries[name], dtype=object)))
            continue
        if t.dim() == 2:
            cols[name] = VecCol(t)
            continue
        kind = kinds.get(name)
        if kind is None:
            kind = ("b" if t.dtype == torch.bool else
                    "f" if t.is_floating_point() else "i")
        cols[name] = NumCol(t, kind)
    v = torch.from_numpy(np.array(valid, dtype=bool, copy=True)).to(device)
    return DeviceBatch(cols, v, None)


# ---------------------------------------------------------------------------
# device -> host
# ---------------------------------------------------------------------------


def device_to_host(batch: DeviceBatch, pinned: bool = False) -> Dict[str, np.ndarray]:
    """Live rows as numpy: strings object (None = null), dates
    datetime64[D] (NaT = null), ints int64 (float64 with NaN where a column
    has nulls, as pandas shows them), floats float64, bools bool, vectors
    2-D float64 ``[rows, dim]``.  ``pinned``: the copies land in page-locked
    buffers (``pack.get_packed``), which the live rows are then taken from."""
    host = pack.get_packed([batch.valid] + [c.codes if isinstance(c, StrCol) else c.data
                                            for c in batch.columns.values()], pinned=pinned)
    mask = host[0]
    out: Dict[str, np.ndarray] = {}
    for (name, col), arr in zip(batch.columns.items(), host[1:]):
        if isinstance(col, StrCol):
            codes = arr[mask]
            vals = col.dictionary.values
            ok = (codes >= 0) & (codes < len(vals))
            res = np.full(len(codes), None, dtype=object)
            res[ok] = vals[codes[ok]]
            out[name] = res
            continue
        data = arr[mask]
        if isinstance(col, VecCol):
            out[name] = data
        elif col.kind == "d":
            nullm = data == NULL_I32
            days = data.astype(np.int64).astype("datetime64[D]")
            days[nullm] = np.datetime64("NaT")
            out[name] = days
        elif col.kind in ("i", "t"):
            sent = NULL_I64 if data.dtype == np.int64 else NULL_I32
            nullm = data == sent
            out[name] = np.where(nullm, np.nan, data) if nullm.any() else data.astype(np.int64)
        else:
            out[name] = data
    return out


def to_pandas(batch_or_columns):
    """A pandas DataFrame of a batch or of ``device_to_host`` output.  Date
    columns become ``datetime.date`` objects, as Arrow's conversion gives."""
    import pandas as pd

    cols = batch_or_columns
    if isinstance(cols, DeviceBatch):
        cols = device_to_host(cols)
    conv = {}
    for name, arr in cols.items():
        if arr.dtype.kind == "M":
            conv[name] = np.array([None if np.isnat(d) else d.astype(datetime.date)
                                   for d in arr], dtype=object)
        elif arr.ndim == 2:
            conv[name] = list(arr)  # one array per row, as Arrow's list conversion
        else:
            conv[name] = arr
    return pd.DataFrame(conv)


def arrow_to_host(table) -> HostTable:
    """A pyarrow Table as a HostTable (dictionary columns stay encoded)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    cols, validity, dicts = {}, {}, {}
    for name in table.column_names:
        arr = table.column(name).combine_chunks()
        t = arr.type
        if pa.types.is_fixed_size_list(t):
            # before fill_null, which lists do not take; flatten() drops the
            # null slots, so the live vectors go back to their own rows and
            # a null row stays a zero vector
            flat = arr.flatten().to_numpy(zero_copy_only=False).astype(np.float64)
            if arr.null_count == 0:
                cols[name] = flat.reshape(len(arr), t.list_size)
                continue
            live = np.nonzero(arr.is_valid().to_numpy(zero_copy_only=False))[0]
            mat = np.zeros((len(arr), t.list_size), dtype=np.float64)
            mat[live] = flat.reshape(-1, t.list_size)
            cols[name] = mat
            continue
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            arr = pc.dictionary_encode(arr)
            t = arr.type
        if pa.types.is_dictionary(t):
            idx = arr.indices
            codes = (pc.fill_null(idx, -1) if idx.null_count else idx)
            cols[name] = codes.to_numpy(zero_copy_only=False).astype(np.int32)
            dicts[name] = np.array(arr.dictionary.to_pylist(), dtype=object)
            continue
        if arr.null_count:
            validity[name] = arr.is_valid().to_numpy(zero_copy_only=False)
            arr = pc.fill_null(arr, False if pa.types.is_boolean(t) else 0)
        if pa.types.is_date32(t):
            cols[name] = arr.cast(pa.int32()).to_numpy(zero_copy_only=False).astype(
                "datetime64[D]")
        elif pa.types.is_boolean(t) or pa.types.is_integer(t) or pa.types.is_floating(t):
            cols[name] = arr.to_numpy(zero_copy_only=False)
        elif pa.types.is_decimal(t):
            cols[name] = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
        else:
            raise NotImplementedError(f"arrow type {t} of {name} not supported by "
                                      "quokka_tpu_torch yet")
    return HostTable(cols, validity, dicts)


def arrow_to_device(table, device, sorted_by: Optional[List[str]] = None) -> DeviceBatch:
    return host_to_device(arrow_to_host(table), device, sorted_by)


def device_to_arrow(batch: DeviceBatch):
    import pyarrow as pa

    arrays = []
    for name, arr in device_to_host(batch).items():
        col = batch.columns[name]
        if isinstance(col, NumCol) and col.kind == "d":
            arrays.append(pa.array(arr.astype("datetime64[D]"), type=pa.date32()))
        elif isinstance(col, VecCol):
            arrays.append(pa.FixedSizeListArray.from_arrays(pa.array(arr.reshape(-1)),
                                                            col.dim))
        else:
            arrays.append(pa.array(arr, from_pandas=True))
    return pa.table(arrays, names=list(batch.columns))


def reland(batch: DeviceBatch) -> DeviceBatch:
    """The live rows of a batch read back to the host and landed again as
    one compact batch through the narrowed wire (K23 on CUDA): the
    reference mesh's host gather (``device_to_arrow`` then
    ``arrow_to_device``) without Arrow.  The live rows are gathered on the
    device first (``nonzero`` reads their count), so only they cross to
    the host, not a shuffle's P-fold padding.  Every column keeps its
    dtype, kind, unit and dictionary; null sentinels travel as values."""
    idx = torch.nonzero(batch.valid).flatten()
    n = idx.shape[0]
    host = pack.get_packed([(c.codes if isinstance(c, StrCol) else c.data).index_select(0, idx)
                            for c in batch.columns.values()])
    padded = config.bucket_size(n)
    landed = pack.pack_put([pack.ValidCount(padded, n)] + [_pad(a, padded) for a in host],
                           batch.device)
    cols = {}
    for (name, c), t in zip(batch.columns.items(), landed[1:]):
        cols[name] = (StrCol(t, c.dictionary) if isinstance(c, StrCol) else VecCol(t)
                      if isinstance(c, VecCol) else NumCol(t, c.kind, c.unit))
    return DeviceBatch(cols, landed[0], nrows=n, sorted_by=batch.sorted_by)


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------


def merge_dicts(dicts: Sequence[StringDict]):
    """Merge string dictionaries; returns (merged StringDict, [remap arrays])."""
    if len(dicts) == 1:
        return dicts[0], [None]
    if all(d is dicts[0] for d in dicts):
        return dicts[0], [None] * len(dicts)
    all_vals = np.concatenate([d.values for d in dicts])
    sent = "\x00__null__"
    flat = np.array([sent if v is None else v for v in all_vals], dtype=object)
    uniq, first_idx, inverse = np.unique(
        flat.astype(str), return_index=True, return_inverse=True
    )
    merged_vals = np.array(
        [None if flat[i] == sent else all_vals[i] for i in first_idx], dtype=object)
    merged = StringDict(merged_vals, binary=any(d.binary for d in dicts))
    remaps = []
    off = 0
    for d in dicts:
        remaps.append(inverse[off: off + len(d)].astype(np.int32))
        off += len(d)
    return merged, remaps


def _remap_codes(codes: torch.Tensor, remap) -> torch.Tensor:
    if remap is None:
        return codes
    table = torch.from_numpy(remap).to(codes.device)
    g = table[torch.clamp(codes, min=0).long()]
    return torch.where(codes < 0, torch.full_like(codes, -1), g)


def _concat_parts(batches: Sequence[DeviceBatch]):
    """Per column: the per-part arrays (string codes remapped into one merged
    dictionary), plus the merged dictionaries."""
    names = batches[0].names
    per_col, dicts = {}, {}
    for name in names:
        cols = [b.columns[name] for b in batches]
        if isinstance(cols[0], StrCol):
            merged, remaps = merge_dicts([c.dictionary for c in cols])
            per_col[name] = [_remap_codes(c.codes, r) for c, r in zip(cols, remaps)]
            dicts[name] = merged
        elif isinstance(cols[0], VecCol) and len({c.dim for c in cols}) != 1:
            raise ValueError(f"concat of vector column {name}: widths differ")
        else:
            per_col[name] = [c.data for c in cols]
    return per_col, dicts


def _assemble(batches, per_col, dicts, idx, valid, nrows) -> DeviceBatch:
    out = {}
    for name, parts in per_col.items():
        data = torch.cat(parts)
        if idx is not None:
            data = data[idx]
            live = valid if data.dim() == 1 else valid[:, None]
            data = torch.where(live, data, torch.zeros((), dtype=data.dtype,
                                                        device=data.device))
        elif data.shape[0] < valid.shape[0]:
            data = torch.cat([data, torch.zeros((valid.shape[0] - data.shape[0],)
                                                + data.shape[1:],
                                                dtype=data.dtype, device=data.device)])
        out[name] = _column_like(batches[0].columns[name], data, dicts.get(name))
    return DeviceBatch(out, valid, nrows, batches[0].sorted_by)


def _column_like(src, data: torch.Tensor, dictionary):
    return (StrCol(data, dictionary) if isinstance(src, StrCol)
            else VecCol(data) if isinstance(src, VecCol)
            else NumCol(data, src.kind, src.unit))


def compact_concat_plain(batches, per_col, dicts, total: int, padded: int) -> DeviceBatch:
    """Plain version of K8: the live rows of every part, in part and row
    order, gathered to the front of ``padded`` rows of every column (the
    per-part arrays of ``per_col``, string codes already remapped), the rest
    zero, and the validity ``arange(padded) < total`` (the reference's
    ``_fused_concat_kernel``).  A torch.cat a column, one nonzero (a host
    read of its count) and a gather and a where a column."""
    vcat = torch.cat([b.valid for b in batches])
    idx = torch.nonzero(vcat).flatten()
    if idx.shape[0] < padded:
        idx = torch.cat([idx, torch.zeros(padded - idx.shape[0], dtype=idx.dtype,
                                          device=idx.device)])
    valid = torch.arange(padded, device=vcat.device) < total
    return _assemble(batches, per_col, dicts, idx, valid, total)


def _concat_lib():
    lib = native.library("concat")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_concat_scratch.argtypes = [P, I]
        lib.qk_concat_scratch.restype = L
        lib.qk_concat.argtypes = [P, P, I, P, P, I, L, L, P, P, P]
        lib.qk_concat.restype = I
        lib.qk_bound = True
    return lib


def _unit(width: int, ptrs) -> int:
    """Bytes a K8 copy moves: the largest power of two up to 16 that divides
    the row width and every pointer of the column."""
    u = 16
    while u > 1 and (width % u or any(p % u for p in ptrs)):
        u //= 2
    return u


def _charge_concat(dev_type: str, lens, total: int, padded: int, widths, first: bool) -> None:
    """devprof's charge of one K8 launch (or plain call): every part row's
    validity byte and each live row of each column read once, ``padded``
    rows of each column and (``first``) of the validity written."""
    out = padded * (sum(widths) + (1 if first else 0))
    devprof.on_dispatch(("K8", dev_type, tuple(lens), total, padded, tuple(widths), first),
                        lambda: (0.0, float(sum(lens) + total * sum(widths) + out), float(out)))


def compact_concat(batches, per_col, dicts, total: int, padded: int) -> DeviceBatch:
    """K8: the compact-concat (see ``compact_concat_plain``).  CUDA tensors
    launch the kernel, one launch a ``CONCAT_MAX_COLUMNS`` columns; CPU
    tensors take the plain version."""
    dev = batches[0].device
    if dev.type == "cpu":
        _charge_concat("cpu", [b.padded_len for b in batches], total, padded,
                       [_row_bytes(_promoted(p), p[0].shape[1:]) for p in per_col.values()],
                       True)
        return compact_concat_plain(batches, per_col, dicts, total, padded)
    if dev.type != "cuda":
        raise RuntimeError(f"compact_concat: unsupported device {dev}")
    return _compact_concat_cuda(batches, per_col, dicts, total, padded)


def _promoted(parts) -> torch.dtype:
    """The dtype torch.cat gives the parts of a column."""
    dt = parts[0].dtype
    for t in parts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _row_bytes(dtype: torch.dtype, row) -> int:
    return dtype.itemsize * math.prod(row)


def _compact_concat_cuda(batches, per_col, dicts, total: int, padded: int) -> DeviceBatch:
    global CONCAT_LAUNCHES
    dev = batches[0].device
    # every contiguous or converted copy stays in these locals until the
    # launches have been issued
    valids = [b.valid.contiguous() for b in batches]
    lens = [v.shape[0] for v in valids]
    if any(v.device != dev or v.dtype != torch.bool or v.dim() != 1 for v in valids):
        raise TypeError("compact_concat: every part's validity is a 1-D bool tensor on "
                        f"{dev}")
    held, outs = {}, {}
    for name, parts in per_col.items():
        dt = _promoted(parts)
        held[name] = [t.to(dt).contiguous() for t in parts]
        row = held[name][0].shape[1:]
        if any(t.device != dev or t.shape[1:] != row or t.shape[0] != m
               for t, m in zip(held[name], lens)):
            raise TypeError(f"compact_concat: column {name}'s parts do not match their "
                            "validity")
        outs[name] = torch.empty((padded,) + tuple(row), dtype=dt, device=dev)
    out_valid = torch.empty(padded, dtype=torch.bool, device=dev)
    names = list(per_col)
    groups = [names[i: i + CONCAT_MAX_COLUMNS]
              for i in range(0, len(names), CONCAT_MAX_COLUMNS)] or [[]]
    # the descriptors of every launch in one pinned buffer, one copy: the
    # parts, then each launch's columns and (part-major) source pointers
    n_parts = len(batches)
    part_desc = np.zeros(n_parts, dtype=_CAT_PART)
    part_desc["valid"] = [v.data_ptr() for v in valids]
    part_desc["rows"] = lens
    blobs, offs = [part_desc.tobytes()], [0]
    off = len(blobs[0])
    for group in groups:
        cols = np.zeros(len(group), dtype=_CAT_COL)
        srcs = np.zeros((n_parts, len(group)), dtype=np.int64)
        for j, name in enumerate(group):
            width = _row_bytes(outs[name].dtype, outs[name].shape[1:])
            ptrs = [t.data_ptr() for t in held[name]]
            cols[j] = (outs[name].data_ptr(), width, _unit(width, ptrs + [outs[name].data_ptr()]))
            srcs[:, j] = ptrs
        offs.append(off)
        blobs.append(cols.tobytes())
        off += len(blobs[-1])
        offs.append(off)
        blobs.append(srcs.tobytes())
        off += len(blobs[-1])
    lib = _concat_lib()
    rows = (ctypes.c_longlong * n_parts)(*lens)
    desc_bytes = -(-off // 8) * 8
    ws = torch.empty(desc_bytes // 8 + lib.qk_concat_scratch(rows, n_parts), dtype=torch.int64,
                     device=dev)
    staging = torch.empty(desc_bytes, dtype=torch.uint8, pin_memory=True)
    staging.numpy()[:off] = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    ws.view(torch.uint8)[:desc_bytes].copy_(staging, non_blocking=True)
    base, stream = ws.data_ptr(), native.stream_ptr(dev)
    for gi, group in enumerate(groups):
        _charge_concat("cuda", lens, total, padded,
                       [_row_bytes(outs[n].dtype, outs[n].shape[1:]) for n in group], gi == 0)
        native.check(lib.qk_concat(
            base, rows, n_parts, base + offs[1 + 2 * gi], base + offs[2 + 2 * gi], len(group),
            total, padded, out_valid.data_ptr() if gi == 0 else None, base + desc_bytes,
            stream), "qk_concat")
        CONCAT_LAUNCHES += 1
    cols = {name: _column_like(batches[0].columns[name], outs[name], dicts.get(name))
            for name in names}
    return DeviceBatch(cols, out_valid, total, batches[0].sorted_by)


def concat_batches(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    """Concatenate same-schema batches into one padded batch.

    With every live count known on the host, live rows are compacted to the
    front of one bucket (K8, ``compact_concat``).  Otherwise the padded
    regions and masks are stacked as they are, with no host sync."""
    if len(batches) == 1:
        return batches[0]
    for b in batches:
        if b.nrows is None and b.nrows_dev is not None:
            b.count_valid()
    per_col, dicts = _concat_parts(batches)
    stacked = sum(b.padded_len for b in batches)
    if any(b.nrows is None for b in batches) and stacked <= config.MAX_BUCKET:
        vcat = torch.cat([b.valid for b in batches])
        valid = torch.cat([vcat, torch.zeros(config.bucket_size(stacked) - stacked,
                                             dtype=torch.bool, device=vcat.device)])
        return _assemble(batches, per_col, dicts, None, valid, None)
    total = sum(b.count_valid() for b in batches)
    return compact_concat(batches, per_col, dicts, total, config.bucket_size(total))


def pad_tail(arr: torch.Tensor, padded: int) -> torch.Tensor:
    n = arr.shape[0]
    if n >= padded:
        return arr[:padded]
    return torch.cat([arr, torch.zeros(padded - n, dtype=arr.dtype, device=arr.device)])
