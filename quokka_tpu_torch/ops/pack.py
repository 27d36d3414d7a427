"""Coalesced host -> device transfers with a narrowed wire, and K23, the
wire decode (port of ``quokka_tpu/ops/pack.py``).

Every batch lands on the device with ONE copy.  Before it, each leaf is
narrowed on the host as the reference narrows it:

- integer columns whose value range fits 8 or 16 bits travel as
  offset-encoded uint8 / uint16 plus a bias;
- float columns with few distinct values (TPC-H's two-decimal discounts
  and taxes) travel as uint8 / uint16 codes plus a small value table;
- the validity mask travels as one count (``ValidCount``).

Narrowing decisions are sticky per batch signature (dtypes and shapes):
the first batch picks each leaf's wire, later batches conform, a plan
widens monotonically when a batch's range no longer fits, and a float
dictionary that stops saving bytes degrades to full width for good.  The
plans are the reference's, decision for decision.

The float dictionary is exact on the bit pattern: it is built on the
column's integer view, so NaN nulls and -0.0 come back bit-identical.  It
is cheap where it can be: the 4096-value sample's distinct bit patterns are
the candidate table, every value is looked up (a multiplicative hash into a
small array, ``np.searchsorted`` for large tables) and checked, and a full
``np.unique`` runs only when the sample missed a value.

On CUDA the wires, biases, tables, validity counts and K23's leaf
descriptors are staged in one pinned buffer, one host -> device copy moves
it, and one K23 launch (``csrc/pack.cu``) decodes every leaf of the batch;
``pass`` leaves stay views into the copied buffer.  The reference decodes
in one jitted program per layout; K23 reads the layout from its descriptors,
so it is compiled once, not once per layout.  On the CPU ``decode_plain``,
the same decode in torch ops, runs instead.

``get_packed`` reads device tensors back to numpy with no device program.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import native

# below this many elements a min/max or distinct scan costs more than it saves
_NARROW_MIN_ELEMS = 4096
# float columns: the sample, and its distinct cutoff before a full encode
_FLOAT_DICT_SAMPLE = 4096
_FLOAT_DICT_SAMPLE_DISTINCT = 200
_FLOAT_DICT_MAX = 65535

_WIDTH = {"uint8": 0, "uint16": 1}  # narrowing lattice; full width = 2

# launches of K23
LAUNCHES = 0

# K23's leaf kinds and its descriptor (csrc/pack.cu ``QkLeaf``, 64 bytes)
_KIND = {"valid": 0, "bool": 1, "widen": 2, "dict": 3}
_DESC = np.dtype([("src", "<i8"), ("dst", "<i8"), ("n", "<i8"), ("bias", "<i8"),
                  ("table", "<i8"), ("kind", "<i4"), ("src_bytes", "<i4"),
                  ("dst_bytes", "<i4"), ("table_len", "<i4"), ("pad", "<i8")])
_ALIGN = 256


def _int_wire_needed(mn: int, mx: int) -> str:
    width = mx - mn
    if width <= 0xFF:
        return "uint8"
    if width <= 0xFFFF:
        return "uint16"
    return "full"


class ValidCount:
    """Marker leaf for pack_put: becomes a bool[padded] validity mask
    ``arange(padded) < nrows`` on the device (only the count is shipped)."""

    def __init__(self, padded: int, nrows: int):
        self.padded = padded
        self.nrows = nrows


class _IntPlan:
    __slots__ = ("wire",)

    def __init__(self, wire: str):
        self.wire = wire  # "uint8" | "uint16" | "full"


class _FloatPlan:
    __slots__ = ("mode", "tlen")

    def __init__(self, mode: str, tlen: int = 0):
        self.mode = mode  # "dict" | "full"
        self.tlen = tlen  # power-of-two table length when mode == "dict"


# batch signature -> per-leaf sticky plans.  The engine's IO threads encode
# side by side: each call decides on the plans it read, and its decisions
# join the stored ones under _LOCK (the wider wins), so a plan still only
# widens.  _LOCK also guards LAUNCHES.
_PLANS: Dict[Tuple, List] = {}
_LOCK = threading.Lock()


class _Narrow:
    """An integer wire not yet written: ``flat - mn`` as ``dtype``, written
    straight into the staging buffer on CUDA, materialized on the CPU."""

    __slots__ = ("flat", "mn", "dtype")

    def __init__(self, flat: np.ndarray, mn: int, dtype: np.dtype):
        self.flat, self.mn, self.dtype = flat, mn, dtype

    @property
    def nbytes(self) -> int:
        return self.flat.size * self.dtype.itemsize

    def write(self, out: np.ndarray) -> None:
        # the difference fits the wire, so the wrapping cast is exact
        np.subtract(self.flat, self.flat.dtype.type(self.mn), out=out, casting="unsafe")

    def array(self) -> np.ndarray:
        out = np.empty(self.flat.size, dtype=self.dtype)
        self.write(out)
        return out


# odd 64-bit multipliers for the lookup's hash (tried in turn until one
# separates the table's entries)
_HASH_MULTS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
               0xD6E8FEB86659FD93)


# the lookup walks a column in chunks of this many values, so that its
# temporaries stay in the CPU's cache
_LOOKUP_CHUNK = 1 << 15


def _lookup(table: np.ndarray, bits: np.ndarray) -> Optional[np.ndarray]:
    """Each value's index in the sorted ``table`` (integer bit patterns), or
    None when a value is not in it.  Tables of up to 256 entries go through
    a multiplicative hash into a uint8 lookup array of about
    ``len(table)^2`` slots, chunk by chunk; larger ones, or a table no
    multiplier separates, through ``np.searchsorted``.  Every index is
    checked against the value either way."""
    m = table.size
    if m <= 256:
        k = max(4, 2 * int(m).bit_length() + 1)
        shift = np.uint64(64 - k)
        ukey = table.astype(np.uint64)  # a wrapping cast: the columns' own
        for mult in _HASH_MULTS:
            slots = (ukey * np.uint64(mult)) >> shift
            if np.unique(slots).size == m:
                break
        else:
            mult = None
        if mult is not None:
            lut = np.zeros(1 << k, dtype=np.uint8)
            lut[slots] = np.arange(m)
            idx = np.empty(bits.size, dtype=np.uint8)
            h = np.empty(min(_LOOKUP_CHUNK, bits.size), dtype=np.uint64)
            for lo in range(0, bits.size, _LOOKUP_CHUNK):
                v = bits[lo: lo + _LOOKUP_CHUNK]
                hv, out = h[: v.size], idx[lo: lo + v.size]
                np.copyto(hv, v, casting="unsafe")
                np.multiply(hv, np.uint64(mult), out=hv)
                np.right_shift(hv, shift, out=hv)
                np.take(lut, hv.view(np.int64), out=out)
                if not np.array_equal(np.take(table, out), v):
                    return None
            return idx
    idx = np.searchsorted(table, bits)
    np.minimum(idx, m - 1, out=idx)
    return idx if np.array_equal(np.take(table, idx), bits) else None


def _float_dict_encode(flat: np.ndarray, plan: Optional[_FloatPlan]):
    """Dictionary-encode a float column per the (possibly new) sticky plan.
    Returns (codes, table, plan) or (None, None, full_plan)."""
    if plan is not None and plan.mode == "full":
        return None, None, plan
    stride = max(1, flat.size // _FLOAT_DICT_SAMPLE)
    sample = flat[::stride][:_FLOAT_DICT_SAMPLE]
    if plan is None and np.unique(sample).size > _FLOAT_DICT_SAMPLE_DISTINCT:
        return None, None, _FloatPlan("full")
    bits_t = np.dtype(f"<i{flat.dtype.itemsize}")
    bits = flat.view(bits_t)
    uniq = np.unique(sample.view(bits_t))
    idx = _lookup(uniq, bits)
    if idx is None:
        # the sample missed a value: the full distinct set
        uniq, idx = np.unique(bits, return_inverse=True)
    if uniq.size > _FLOAT_DICT_MAX or uniq.size == 0:
        return None, None, _FloatPlan("full")
    tlen = max(16, 1 << (int(uniq.size - 1).bit_length()))
    if plan is None or tlen > plan.tlen:
        plan = _FloatPlan("dict", tlen)  # grow monotonically
    wdt = np.uint8 if plan.tlen <= 256 else np.uint16
    codes = idx.astype(wdt, copy=False)
    if plan.tlen > uniq.size:
        uniq = np.concatenate([uniq, np.full(plan.tlen - uniq.size, uniq[-1], uniq.dtype)])
    if codes.nbytes + uniq.nbytes >= flat.nbytes:
        # a stream that started low-cardinality drifted: stop paying the
        # encode on every later batch too (sticky degrade)
        return None, None, _FloatPlan("full")
    return codes, uniq.view(flat.dtype), plan


def _rank(plan) -> Tuple[int, int]:
    """A plan's place in its lattice: int wires uint8 < uint16 < full;
    float dictionaries by table length, below full."""
    if isinstance(plan, _IntPlan):
        return (_WIDTH.get(plan.wire, 2), 0)
    return (1, 0) if plan.mode == "full" else (0, plan.tlen)


def _join(stored, decided):
    """The wider of a stored plan and a call's decision."""
    if stored is None or _rank(decided) >= _rank(stored):
        return decided
    return stored


def _encode(leaves: Sequence):
    """(wires, layout) of one batch, updating its signature's sticky plans.
    The layout is the reference's: ("valid", padded), ("bool", shape),
    ("widen", target, shape), ("dict", shape), ("pass", dtype, shape)."""
    items, sig = [], []
    for arr in leaves:
        if isinstance(arr, ValidCount):
            sig.append(("__valid__", arr.padded))
        else:
            arr = np.ascontiguousarray(arr)
            sig.append((str(arr.dtype), arr.shape))
        items.append(arr)
    with _LOCK:
        stored = _PLANS.setdefault(tuple(sig), [None] * len(items))
        read = list(stored)
    plans = list(read)
    try:
        return _encode_with(items, plans)
    finally:
        with _LOCK:
            for idx, (was, now) in enumerate(zip(read, plans)):
                if now is not was:
                    stored[idx] = _join(stored[idx], now)


def _encode_with(items: List, plans: List):
    """The wires and layout of ``items`` under ``plans`` (this call's copy
    of its signature's plans, updated in place with its decisions)."""
    wires: List = []
    layout: List[Tuple] = []
    for idx, arr in enumerate(items):
        if isinstance(arr, ValidCount):
            wires.append(np.array([arr.nrows], dtype=np.int32))
            layout.append(("valid", arr.padded))
            continue
        shape = arr.shape
        flat = arr.reshape(-1)
        n = flat.size
        if arr.dtype == np.bool_:
            wires.append(flat.view(np.uint8))
            layout.append(("bool", shape))
            continue
        if arr.dtype in (np.int32, np.int64) and n >= _NARROW_MIN_ELEMS:
            plan: Optional[_IntPlan] = plans[idx]
            mn, mx = int(flat.min()), int(flat.max())
            needed = _int_wire_needed(mn, mx)
            if plan is None:
                plan = _IntPlan(needed)
            elif needed == "full" or (plan.wire != "full"
                                      and _WIDTH[needed] > _WIDTH[plan.wire]):
                plan = _IntPlan(needed)  # widen monotonically
            plans[idx] = plan
            if plan.wire != "full":
                wires.append(_Narrow(flat, mn, np.dtype(plan.wire)))
                wires.append(np.array([mn], dtype=arr.dtype))
                layout.append(("widen", str(arr.dtype), shape))
                continue
        elif arr.dtype in (np.float32, np.float64) and n >= _NARROW_MIN_ELEMS:
            codes, table, plans[idx] = _float_dict_encode(flat, plans[idx])
            if codes is not None:
                wires.append(codes)
                wires.append(table)
                layout.append(("dict", shape))
                continue
        wires.append(arr)
        layout.append(("pass", str(arr.dtype), shape))
    return wires, layout


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _leaves(layout, wires):
    """Per decoded leaf: (kind, index of its first wire, output dtype name,
    output shape)."""
    i = 0
    for spec in layout:
        kind = spec[0]
        if kind == "valid":
            yield kind, i, "bool", (spec[1],)
        elif kind == "bool":
            yield kind, i, "bool", spec[1]
        elif kind == "dict":
            yield kind, i, str(wires[i + 1].dtype), spec[1]
        else:  # widen, pass
            yield kind, i, spec[1], spec[2]
        i += 2 if kind in ("widen", "dict") else 1


def _cost(layout, wires) -> Tuple[int, int]:
    """K23's bytes: (read: the non-pass wires and tables, written: the
    decoded non-pass leaves).  The valid count rides the descriptor."""
    read = write = 0
    for kind, i, dt, shape in _leaves(layout, wires):
        if kind == "pass":
            continue
        if kind != "valid":
            read += wires[i].nbytes
        if kind == "dict":
            read += wires[i + 1].nbytes
        write += int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
    return read, write


def _charge(layout, wires, device: str) -> None:
    """Charge one K23 dispatch on ``device`` (a device type) to devprof,
    kernel or plain version alike."""
    if all(spec[0] == "pass" for spec in layout):
        return
    read, write = _cost(layout, wires)
    devprof.on_dispatch(("K23", device, tuple(layout), read),
                        lambda: (0.0, float(read + write), float(write)))


def decode_plain(layout, wires: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of K23: the reference's decode program in torch ops,
    over the wire list (on any device)."""
    outs: List[torch.Tensor] = []
    i = 0
    for spec in layout:
        kind = spec[0]
        if kind == "valid":
            cnt = wires[i][0]
            outs.append(torch.arange(spec[1], dtype=torch.int32, device=cnt.device) < cnt)
            i += 1
        elif kind == "bool":
            outs.append((wires[i] != 0).reshape(spec[1]))
            i += 1
        elif kind == "widen":
            arr = wires[i].to(_torch_dtype(spec[1])) + wires[i + 1][0]
            outs.append(arr.reshape(spec[2]))
            i += 2
        elif kind == "dict":
            codes, table = wires[i], wires[i + 1]
            outs.append(table[codes.to(torch.int64)].reshape(spec[1]))
            i += 2
        else:
            outs.append(wires[i].reshape(spec[2]))
            i += 1
    return outs


# ---------------------------------------------------------------------------
# CUDA: one pinned staging buffer, one copy, one K23 launch
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Staged:
    """One batch's wire on the device: the copied buffer, the wire list as
    views into it (the plain version's input), K23's descriptors (at
    ``desc_off``) and the outputs they point at."""

    layout: List[Tuple]
    buf: torch.Tensor
    wires: List[torch.Tensor]
    outs: List[torch.Tensor]
    desc_off: int
    n_desc: int
    max_n: int


def _lib():
    lib = native.library("pack")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_decode.argtypes = [P, L, I, L, P]
        lib.qk_decode.restype = I
        lib.qk_bound = True
    return lib


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def stage(layout, wires: Sequence, device: torch.device) -> Staged:
    """Stage a batch's wires and K23's descriptors in one pinned buffer,
    copy it to ``device`` in one transfer, and allocate the outputs."""
    offs, total = [], 0
    for w in wires:
        offs.append(total)
        total += _align(w.nbytes)
    outs: List[Optional[torch.Tensor]] = []
    descs = []
    max_n = 0
    for kind, i, dt, shape in _leaves(layout, wires):
        if kind == "pass":
            outs.append(None)
            continue
        out = torch.empty(shape, dtype=_torch_dtype(dt), device=device)
        n = out.numel()
        d = dict(src=offs[i], dst=out.data_ptr(), n=n, bias=int(wires[i][0]) if kind == "valid"
                 else int(wires[i + 1][0]) if kind == "widen" else 0,
                 table=offs[i + 1] if kind == "dict" else 0, kind=_KIND[kind],
                 src_bytes=wires[i].dtype.itemsize, dst_bytes=out.element_size(),
                 table_len=wires[i + 1].size if kind == "dict" else 0, pad=0)
        descs.append(tuple(d[k] for k in _DESC.names))
        outs.append(out)
        max_n = max(max_n, n)
    desc_off = total
    total += len(descs) * _DESC.itemsize
    staging = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    host = staging.numpy()
    for w, off in zip(wires, offs):
        if isinstance(w, _Narrow):
            w.write(host[off: off + w.nbytes].view(w.dtype))
        else:
            host[off: off + w.nbytes] = np.ascontiguousarray(w).reshape(-1).view(np.uint8)
    host[desc_off: desc_off + len(descs) * _DESC.itemsize].view(_DESC)[:] = descs
    buf = staging.to(device, non_blocking=True)
    dev_wires = [buf[off: off + w.nbytes].view(_torch_dtype(str(w.dtype)))
                 for w, off in zip(wires, offs)]
    for j, (kind, i, dt, shape) in enumerate(_leaves(layout, wires)):
        if kind == "pass":
            outs[j] = dev_wires[i].view(shape)
    return Staged(list(layout), buf, dev_wires, outs, desc_off, len(descs), max_n)


def decode_launch(st: Staged) -> List[torch.Tensor]:
    """Launch K23 on a staged batch: writes every non-pass output."""
    global LAUNCHES
    dev = st.buf.device
    if dev.type != "cuda":
        raise RuntimeError(f"wire decode: unsupported device {dev}")
    if st.n_desc:
        native.check(_lib().qk_decode(st.buf.data_ptr(), st.desc_off, st.n_desc, st.max_n,
                                      native.stream_ptr(dev)), "qk_decode")
        with _LOCK:
            LAUNCHES += 1
    return st.outs


def pack_put(leaves: Sequence, device) -> List[torch.Tensor]:
    """Move numpy arrays (and ``ValidCount`` markers) to ``device``; returns
    tensors with the original dtypes and shapes.  CUDA: one copy and one
    K23 launch; CPU: the plain decode."""
    if not leaves:
        return []
    device = torch.device(device)
    wires, layout = _encode(leaves)
    if device.type == "cpu":
        # the plain decode over private copies (a pass leaf must not alias
        # the caller's array)
        host = [w.array() if isinstance(w, _Narrow) else np.array(w) for w in wires]
        _charge(layout, host, "cpu")
        return decode_plain(layout, [torch.from_numpy(w) for w in host])
    if device.type != "cuda":
        raise RuntimeError(f"pack_put: unsupported device {device}")
    st = stage(layout, wires, device)
    _charge(layout, wires, "cuda")
    return decode_launch(st)


def get_packed(arrays: Sequence[torch.Tensor], pinned: bool = False) -> List[np.ndarray]:
    """Read tensors back to the host as numpy, leaf by leaf, with no device
    program (the reference's rule for this direction).  With ``pinned``, a
    device tensor lands in page-locked memory (a DMA at the link's rate on
    the caller's current stream, which the copy then waits for) and comes
    back as a numpy view of it."""
    if not pinned:
        return [a.cpu().numpy() for a in arrays]
    out = []
    for a in arrays:
        if a.is_cuda:
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            h.copy_(a)
            a = h
        out.append(a.numpy())
    return out
