"""Device hash table: group-by and PK-join probe (PyTorch port of
``quokka_tpu/ops/hashtable.py``).

Kernel K3.  ``hash_groupby`` groups rows by equality of their key limbs and
computes segment aggregates in one pass over a power-of-two open-addressing
table (load factor <= 0.5, double hash with an odd stride).  On a CUDA
tensor it launches the hand-written kernels of ``csrc/hashtable.cu`` (see
the note there for what bounds them and why they are shaped so); on a CPU
tensor it runs ``hash_groupby_plain``, the same function in plain torch ops,
which the CPU tests hold against the reference.

Contract (the reference's ``sorted_groupby`` contract): returns
``(outs, counts, rep, num)`` with every output indexed by group rank,
``rep`` each group's smallest valid row and ``num`` a device scalar.  Group
ranks follow table-slot order, so group order differs from the reference's
(claim order); no consumer depends on it, and results compare after a sort
on the keys.  A NaN key makes its own group and -0.0 equals +0.0, as
``canonical_limbs`` defines them.  Float sums and means are the same bits
in every run on the card (the segment pass adds them as 128-bit fixed-point
integers at each group's largest exponent, so the order of the blocks'
adds cannot change them); they agree with the plain version's row-order
sums to rounding.  On the card a call is four device operations and no
host read: the table has cap >= 2n slots
(``capbits_for``), its probe walk visits every slot, claims are never
undone and at most n slots are claimed, so every live row finds an empty
slot or its own key and the insert cannot fail.  Only a table patched to
cap <= n can fail: then, and only then, ``hash_groupby`` reads the flag
and reruns the batch through the sort group-by (``kernels.sorted_groupby``),
as the reference does; the plain version returns None for such a batch,
and the PK build raises ``HashTableConvergenceError``.

Kernel K11, the PK-join build and probe: ``build_table`` inserts a build
batch's canonical int32 key limbs once (``qk_hash_build``) and
caches the table on the batch; ``pk_probe`` walks each probe row's probe
sequence (``qk_probe_kernel``) to the slot holding its key or to an EMPTY
slot.  The table holds row ids directly (the reference packs a claim round
above the row id, which its ``table_rid`` decodes; the port needs neither).
A build whose insert did not converge is remembered on the batch
(``_DIVERGED``) and raises ``HashTableConvergenceError`` at every later
call, so the join takes the sorted probe (K12) for it.  The probe kernel's
plain twin, ``_probe_plain``, walks the plain insert's table.
"""

from __future__ import annotations

import array
import ctypes
from typing import List, Sequence, Tuple

import torch

from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import native, strategy

EMPTY = 2**31 - 1

# launches of the CUDA group-by (one C call: memset, insert, rank, segment)
LAUNCHES = 0
# launches of K11: PK build inserts and probes
BUILD_LAUNCHES = 0
PROBE_LAUNCHES = 0

_OP_CODES = {"sum": 0, "count": 1, "min": 2, "max": 3, "mean": 4, "first": 5}
_DT_CODES = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}


class HashTableConvergenceError(RuntimeError):
    """The insert failed to place every valid row within its probe cap.
    Unplaced rows would otherwise alias slot 0's group."""


def capbits_for(n: int) -> int:
    """Capacity exponent giving load factor <= 0.5 (min 256 slots)."""
    bits = 8
    while (1 << bits) < 2 * max(n, 1):
        bits += 1
    return bits


def canonical_limbs(limbs: Sequence[torch.Tensor],
                    nan_unique: bool = True) -> Tuple[torch.Tensor, ...]:
    """Equality-preserving int32 form of key limbs, as the reference's:
    -0.0 equals +0.0, NaN is one bit pattern and (``nan_unique``) every NaN
    row gets a companion limb of its row id + 1 so it is its own group;
    64-bit limbs split into two int32 limbs (low word first for floats, as
    a bitcast lays them out; hi then lo for ints)."""
    out: List[torch.Tensor] = []
    for l in limbs:
        if l.is_floating_point():
            isnan = torch.isnan(l)
            f = torch.where(l == 0.0, torch.zeros((), dtype=l.dtype, device=l.device), l)
            f = torch.where(isnan, torch.full((), float("nan"), dtype=l.dtype,
                                              device=l.device), f)
            if l.dtype == torch.float64:
                pair = f.contiguous().view(torch.int32).view(-1, 2)
                out.append(pair[:, 0].contiguous())
                out.append(pair[:, 1].contiguous())
            else:
                out.append(f.to(torch.float32).contiguous().view(torch.int32))
            if nan_unique:
                rid = torch.arange(1, l.shape[0] + 1, dtype=torch.int32, device=l.device)
                out.append(torch.where(isnan, rid, torch.zeros_like(rid)))
        elif l.dtype == torch.int32:
            out.append(l)
        elif l.dtype == torch.int64:
            out.append((l >> 32).to(torch.int32))
            out.append((l & 0xFFFFFFFF).to(torch.int32))
        else:
            out.append(l.to(torch.int32))
    return tuple(out)


def nan_rows(limbs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rows with a NaN in any float limb (excluded from join matching)."""
    m = torch.zeros(limbs[0].shape, dtype=torch.bool, device=limbs[0].device)
    for l in limbs:
        if l.is_floating_point():
            m = m | torch.isnan(l)
    return m


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & 0xFFFFFFFF


def _hash_stride(limbs: Sequence[torch.Tensor], mask: int):
    """Start slot and odd stride per row (uint32 arithmetic in int64)."""
    h = torch.full(limbs[0].shape, 0x9747B28C, dtype=torch.int64,
                   device=limbs[0].device)
    for l in limbs:
        h = _u32((h ^ _u32(l.to(torch.int64))) * 0x9E3779B1)
        h = h ^ (h >> 16)
    h = _u32((h ^ (h >> 13)) * 0x85EBCA6B)
    h = _u32((h ^ (h >> 16)) * 0xC2B2AE35)
    slot = (h ^ (h >> 15)) & mask
    stride = ((h >> 7) | 1) & mask
    return slot, stride


def _insert_plain(limbs, valid, capbits: int):
    """Plain version of the insert: every unplaced row probes one step per
    round; within a round the smallest row id claims a contested EMPTY slot
    (a sequential CAS order), and rows whose key equals the occupant's join
    it.  Returns (slot per row, table of claiming row ids, converged)."""
    cap = 1 << capbits
    mask = cap - 1
    n = valid.shape[0]
    dev = valid.device
    slot, stride = _hash_stride(limbs, mask)
    table = torch.full((cap,), EMPTY, dtype=torch.int64, device=dev)
    myslot = torch.zeros(n, dtype=torch.int64, device=dev)
    pending = valid.clone()
    rid = torch.arange(n, dtype=torch.int64, device=dev)
    for _ in range(2 * cap):
        if not bool(pending.any()):
            return myslot, table, True
        act = torch.nonzero(pending).flatten()
        s = slot[act]
        empty = table[s] == EMPTY
        claim = torch.full((cap,), EMPTY, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, s[empty], rid[act][empty], reduce="amin")
        table = torch.where(table == EMPTY, claim, table)
        occ = table[s]
        same = torch.ones_like(act, dtype=torch.bool)
        for l in limbs:
            same &= l[occ] == l[act]
        placed = same  # the claimer's own key always equals itself
        myslot[act[placed]] = s[placed]
        pending[act[placed]] = False
        nxt = act[~placed]
        slot[nxt] = (slot[nxt] + stride[nxt]) & mask
    return myslot, table, not bool(pending.any())


def _max_sentinel(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _min_sentinel(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def segment_aggs_plain(ranks, valid, arrays, ops):
    """Segment aggregates over dense ranks (the reference's
    ``kernels._segment_aggs_body`` in torch ops)."""
    n = ranks.shape[0]
    dev = ranks.device
    r = ranks.long()
    vi = valid.to(torch.int32)
    counts = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, r, vi)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    rep = torch.full((n,), n - 1, dtype=torch.int32, device=dev)
    rep = rep.scatter_reduce(0, r, torch.where(valid, iota, torch.full_like(iota, n - 1)),
                             reduce="amin")
    outs = []
    for arr, op in zip(arrays, ops):
        if op == "count":
            if arr.is_floating_point():
                c = (valid & ~torch.isnan(arr)).to(torch.int32)
                outs.append(torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, r, c))
            else:
                outs.append(counts)
        elif op in ("sum", "mean"):
            x = torch.where(valid, arr, torch.zeros((), dtype=arr.dtype, device=dev))
            s = torch.zeros(n, dtype=arr.dtype, device=dev).index_add_(0, r, x)
            if op == "mean":
                s = s / torch.clamp(counts, min=1).to(s.dtype)
            outs.append(s)
        elif op in ("min", "max"):
            ident = _max_sentinel(arr.dtype) if op == "min" else _min_sentinel(arr.dtype)
            x = torch.where(valid, arr, torch.full((), ident, dtype=arr.dtype, device=dev))
            init = torch.full((n,), ident, dtype=arr.dtype, device=dev)
            red = init.scatter_reduce(0, r, x, reduce="amin" if op == "min" else "amax")
            if arr.is_floating_point():
                # NaN propagates, as XLA's segment_min/max do
                nan_seg = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
                    0, r, (valid & torch.isnan(arr)).to(torch.int32)) > 0
                red = torch.where(nan_seg, torch.full_like(red, float("nan")), red)
            outs.append(red)
        elif op == "first":
            outs.append(arr[rep.long()])
        else:
            raise ValueError(f"unknown agg {op}")
    return outs, counts, rep


def hash_groupby_plain(limbs, arrays, ops, valid):
    """Plain torch version of K3 (CPU batches; the card's reference):
    (outs, counts, rep, num), or None when the insert did not converge."""
    climbs = canonical_limbs(limbs)
    capbits = capbits_for(valid.shape[0])
    myslot, table, converged = _insert_plain(climbs, valid, capbits)
    if not converged:
        return None
    flag = (table != EMPTY).to(torch.int64)
    rank_of_slot = torch.cumsum(flag, 0) - flag
    ranks = rank_of_slot[myslot]
    num = flag.sum().to(torch.int32)
    outs, counts, rep = segment_aggs_plain(ranks, valid, arrays, ops)
    return tuple(outs), counts, rep, num


def segment_aggs(ranks: torch.Tensor, valid: torch.Tensor,
                 arrays: Sequence[torch.Tensor], ops: Sequence[str]):
    """Segment aggregates over given dense ranks: (outs, counts, rep).
    CUDA tensors launch K3's segment pass; CPU tensors the plain version."""
    if valid.device.type == "cpu":
        return segment_aggs_plain(ranks, valid, arrays, ops)
    _require_cuda(valid, "segment_aggs")
    return _segment_ranked_cuda(ranks, valid, tuple(arrays), tuple(ops))


def hash_groupby(limbs: Sequence[torch.Tensor], arrays: Sequence[torch.Tensor],
                 ops: Sequence[str], valid: torch.Tensor):
    """Group by key limbs and aggregate: (outs, counts, rep, num).
    CUDA tensors launch K3; CPU tensors take the plain version.  When the
    insert did not converge (only possible with cap <= n), the batch is
    grouped by the sort group-by instead (``groupby`` is then recorded as
    ``sort``)."""
    from quokka_tpu_torch.ops import kernels  # kernels imports this module

    n = valid.shape[0]

    def cost():
        row = 8 + sum(a.element_size() for a in arrays)
        return 0.0, float(devprof.nbytes(*limbs, *arrays, valid) + n * row), float(n * row)

    if valid.device.type == "cpu":
        devprof.on_dispatch(("K3", "cpu", n, tuple(str(l.dtype) for l in limbs),
                             tuple(str(a.dtype) for a in arrays)), cost)
        res = hash_groupby_plain(limbs, arrays, ops, valid)
    else:
        _require_cuda(valid, "hash_groupby")
        capbits = capbits_for(n)
        plan = _plan(n, 1 << capbits, limbs, arrays, ops)
        devprof.on_dispatch(plan.dp_key, cost)
        *res, failed = _hash_groupby_cuda(limbs, arrays, ops, valid, capbits, plan)
        # cap > n: the insert cannot fail, and the flag is not read
        if (1 << capbits) <= n and int(failed):
            res = None
    if res is None:
        strategy.note_used("groupby", "sort")
        return kernels.sorted_groupby(limbs, arrays, ops, valid)
    strategy.note_used("groupby", "hashtable")
    return tuple(res)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")


def _lib():
    lib = native.library("hashtable")
    if not getattr(lib, "qk_bound", False):
        P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        PP = ctypes.POINTER(ctypes.c_void_p)
        lib.qk_gb_scratch.argtypes, lib.qk_gb_scratch.restype = [L, L], L
        lib.qk_groupby.argtypes = [L, L, P, P, P, P, P, I, P, I, P, P]
        lib.qk_groupby.restype = I
        lib.qk_segment_ranked.argtypes = [L, P, I, P, P, P, P, I, P, P]
        lib.qk_segment_ranked.restype = I
        lib.qk_hash_build.argtypes = [PP, I, P, L, P, U, P, P]
        lib.qk_hash_build.restype = I
        lib.qk_pk_probe.argtypes = [PP, PP, I, P, L, P, U, L, P, P, P]
        lib.qk_pk_probe.restype = I
        lib.qk_bound = True
    return lib


def _align(nbytes: int) -> int:
    return (nbytes + 15) & ~15


_SIZE = {torch.float64: 8, torch.int64: 8, torch.float32: 4, torch.int32: 4}


class _Plan:
    """One signature's layout (rows, table size, key dtypes, each column's
    dtype and op) and its column words but the pointers.

    Outputs, one allocation: a 16-byte header (num, failed), counts and
    rep, then the kernel columns' outputs grouped by dtype, each group an
    [its columns, n] block.  Scratch, the other: what ``qk_gb_scratch``
    asks for (counters; for the group-by the table and its scan), then the
    integer means' sums, then each float sum's and mean's fixed-point
    accumulators (24 bytes a group: the kernel adds them as 128-bit
    integers, so their bits do not depend on the order of the adds)."""

    __slots__ = ("n", "cap", "k", "cols", "out_bytes", "scratch_bytes", "groups", "src", "outs",
                 "accs", "fxs", "view", "key_dts", "keys_cast", "dp_key")

    def __init__(self, n: int, cap: int, key_dts, sig):
        self.n, self.cap = n, cap
        cols = []  # per kernel column: (kind, out dtype, acc bytes or 0)
        self.src = []  # per column: (how, kernel column): "counts", "gather" or "out"
        for dt, op in sig:
            if op not in _OP_CODES:
                raise ValueError(f"unknown agg {op}")
            if op == "count" and not dt.is_floating_point:
                self.src.append(("counts", None))
                continue
            if dt not in _DT_CODES:
                if op == "first":  # any other dtype: gathered at rep after the call
                    self.src.append(("gather", None))
                    continue
                raise TypeError(f"segment aggregates: unsupported input {dt}")
            out_dt, acc = (torch.int32 if op == "count" else dt), 0
            if op == "mean" and not dt.is_floating_point:
                out_dt = torch.get_default_dtype()
                if out_dt != torch.float32:
                    raise TypeError(f"segment aggregates: mean of {dt} into {out_dt}")
                acc = _align(n * _SIZE[dt])
            self.src.append(("out", len(cols)))
            cols.append((_OP_CODES[op] * 4 + _DT_CODES[dt], out_dt, acc))
        if len(cols) > 32:
            raise ValueError("segment aggregates: at most 32 per launch")
        self.k = len(cols)
        off = 16 + 8 * n  # header, counts, rep
        self.groups = []  # (dtype, byte offset, columns)
        self.outs, self.view = [0] * self.k, [0] * self.k
        for dt in _SIZE:
            members = [c for c, col in enumerate(cols) if col[1] == dt]
            if members:
                off = _align(off)
                self.groups.append((dt, off, len(members)))
                for c in members:
                    self.outs[c], self.view[c] = off, sum(g[2] for g in self.groups[:-1]) + \
                        members.index(c)
                    off += n * _SIZE[dt]
        self.out_bytes = _align(off)
        base = _lib().qk_gb_scratch(n, cap)
        self.accs = []
        for _, _, acc in cols:
            self.accs.append(base if acc else None)
            base += acc
        self.fxs = []
        for kind, _, _ in cols:
            fixed = kind // 4 in (_OP_CODES["sum"], _OP_CODES["mean"]) and \
                kind % 4 in (_DT_CODES[torch.float64], _DT_CODES[torch.float32])
            self.fxs.append(base if fixed else None)
            base += _align(24 * n) if fixed else 0
        self.scratch_bytes = base
        self.cols = [0] * (4 * self.k) + [col[0] for col in cols]
        self.key_dts = [_DT_CODES.get(dt, 3) for dt in key_dts]
        self.keys_cast = [dt not in _DT_CODES for dt in key_dts]
        self.dp_key = ("K3", "cuda", n, tuple(str(dt) for dt in key_dts),
                       tuple(str(dt) for dt, _ in sig))


_PLANS = {}


def _plan(n: int, cap: int, limbs, arrays, ops) -> _Plan:
    """The cached plan of a signature; cap 0 for the segment pass alone."""
    key = (n, cap, tuple(l.dtype for l in limbs), tuple(a.dtype for a in arrays), tuple(ops))
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) > 256:
            _PLANS.clear()
        plan = _PLANS[key] = _Plan(n, cap, key[2], tuple(zip(key[3], key[4])))
    return plan


def _ptrs(tensors, n: int, di: int, what: str, keep: list) -> List[int]:
    """The data pointers of n-row tensors on device index di, each made
    contiguous.  A copy goes into ``keep``, which the caller holds until its
    launch is issued: a copy freed earlier goes back to the allocator, and
    the next allocation on the stream could take its memory."""
    out = []
    for t in tensors:
        if t.shape[0] != n or t.get_device() != di:
            raise TypeError(f"{what}: unsupported input {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        out.append(t.data_ptr())
    return out


def _cols(plan: _Plan, arrays, di: int, ob: int, sb: int, keep: list):
    """The plan's column words with the pointers filled in."""
    w = list(plan.cols)
    k = plan.k
    ins = [a for a, (how, _) in zip(arrays, plan.src) if how == "out"]
    w[:k] = _ptrs(ins, plan.n, di, "segment aggregates", keep)
    w[k:2 * k] = [ob + off for off in plan.outs]
    w[2 * k:3 * k] = [ob + off if acc is None else sb + acc
                      for off, acc in zip(plan.outs, plan.accs)]
    w[3 * k:4 * k] = [0 if fx is None else sb + fx for fx in plan.fxs]
    return array.array("q", w)


def _results(plan: _Plan, buf, arrays):
    """(outs, counts, rep, num, failed) as views of the output buffer."""
    n = plan.n
    hdr, counts, rep = buf[:16 + 8 * n].view(torch.int32).split_with_sizes([4, n, n])
    views = []
    for dt, off, cnt in plan.groups:
        views.extend(buf[off:off + cnt * n * _SIZE[dt]].view(dt).view(cnt, n).unbind(0))
    outs = tuple(views[plan.view[c]] if how == "out" else
                 counts if how == "counts" else a[rep.long()]
                 for a, (how, c) in zip(arrays, plan.src))
    num, failed = hdr[:2].unbind(0)
    return outs, counts, rep, num, failed


def _device_index(dev) -> int:
    return dev.index if dev.type == "cuda" else -1


def _hash_groupby_cuda(limbs, arrays, ops, valid, capbits: int, plan=None):
    """Launch K3: (outs, counts, rep, num, failed), the last two 0-d device
    tensors; ``failed`` is 1 only if the insert could not place a row,
    which needs cap <= n."""
    global LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    if not 1 <= len(limbs) <= 16:
        raise ValueError("hash_groupby: 1 to 16 key columns")
    if plan is None:
        plan = _plan(n, 1 << capbits, limbs, arrays, ops)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    buf = torch.empty(plan.out_bytes, dtype=torch.uint8, device=dev)
    if n == 0:
        buf.zero_()
        return _results(plan, buf, arrays)
    di, ob, sb = _device_index(dev), buf.data_ptr(), scratch.data_ptr()
    keys = [l.to(torch.int32) if cast else l for l, cast in zip(limbs, plan.keys_cast)]
    keep = []  # the contiguous copies, held through the launch
    cols = _cols(plan, arrays, di, ob, sb, keep)
    key_words = array.array("q", _ptrs(keys, n, di, "hash_groupby", keep) + plan.key_dts)
    vp = _ptrs((valid,), n, di, "hash_groupby", keep)[0]
    native.check(_lib().qk_groupby(n, plan.cap, vp, sb, ob, ob + 16, ob + 16 + 4 * n, len(keys),
                                   key_words.buffer_info()[0], plan.k, cols.buffer_info()[0],
                                   native.stream_ptr(dev)), "qk_groupby")
    LAUNCHES += 1
    return _results(plan, buf, arrays)


def _segment_ranked_cuda(ranks, valid, arrays, ops):
    """K3's segment pass over given ranks: (outs, counts, rep)."""
    dev = valid.device
    n = valid.shape[0]
    if ranks.dtype not in (torch.int32, torch.int64):
        ranks = ranks.to(torch.int64)
    plan = _plan(n, 0, (), arrays, ops)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    buf = torch.empty(plan.out_bytes, dtype=torch.uint8, device=dev)
    if n > 0:
        di, ob, sb = _device_index(dev), buf.data_ptr(), scratch.data_ptr()
        keep = []  # the contiguous copies, held through the launch
        cols = _cols(plan, arrays, di, ob, sb, keep)
        rp, vp = _ptrs((ranks, valid), n, di, "segment_aggs", keep)
        native.check(_lib().qk_segment_ranked(n, rp, _DT_CODES[ranks.dtype], vp, sb, ob + 16,
                                              ob + 16 + 4 * n, plan.k, cols.buffer_info()[0],
                                              native.stream_ptr(dev)), "qk_segment_ranked")
    return _results(plan, buf, arrays)[:3]


# ---------------------------------------------------------------------------
# K11: PK-join build and probe
# ---------------------------------------------------------------------------


class _TableCache:
    """Hash table of a finalized build batch, cached on the batch object:
    one build serves every probe batch, so the insert (and the build-side
    null-mask work) is paid once."""

    __slots__ = ("tbl", "limbs", "raw_dtypes", "capbits")

    def __init__(self, tbl, limbs, raw_dtypes, capbits):
        self.tbl = tbl
        self.limbs = limbs
        self.raw_dtypes = raw_dtypes
        self.capbits = capbits


# negative-cache sentinel: a diverged build is remembered on the batch so a
# long probe stream does not re-run the failed insert for every probe
_DIVERGED = object()


def _build_insert(limbs: Tuple[torch.Tensor, ...], ok: torch.Tensor, capbits: int):
    """K11's insert over canonical limbs: (table, converged).  The CUDA route
    reads the device flag once: the one host read a build pays."""
    n = ok.shape[0]
    devprof.on_dispatch(("K11 build", ok.device.type, n, len(limbs), capbits),
                        lambda: (0.0, float(devprof.nbytes(*limbs, ok) + 4 * (1 << capbits)
                                            + 4 * n), float(4 * (1 << capbits))))
    if ok.device.type == "cpu":
        _, table, converged = _insert_plain(limbs, ok, capbits)
        return table, converged
    _require_cuda(ok, "build_table")
    global BUILD_LAUNCHES
    lib = _lib()
    dev = ok.device
    if len(limbs) > 16:
        raise ValueError("build_table: at most 16 key limbs")
    limbs = [l.contiguous() for l in limbs]
    table = torch.full((1 << capbits,), EMPTY, dtype=torch.int32, device=dev)
    failed = torch.zeros(1, dtype=torch.int32, device=dev)
    native.check(lib.qk_hash_build(
        native.ptr_array([l.data_ptr() for l in limbs]), len(limbs),
        ok.contiguous().view(torch.uint8).data_ptr(), ok.shape[0], table.data_ptr(),
        (1 << capbits) - 1, failed.data_ptr(), native.stream_ptr(dev)), "qk_hash_build")
    BUILD_LAUNCHES += 1
    return table, not bool(failed.item())


def build_table(build, build_keys: Sequence[str], key_limbs_fn, valid_fn) -> _TableCache:
    """The cached hash table of a build batch's key columns.  Raises
    ``HashTableConvergenceError`` when the insert did not converge, now or
    on an earlier call for the same batch and keys."""
    cache = getattr(build, "_ht_cache", None)
    if cache is None:
        cache = build._ht_cache = {}
    key = tuple(build_keys)
    hit = cache.get(key)
    if hit is _DIVERGED:
        raise HashTableConvergenceError(
            "hash-table build previously failed to converge for this build "
            "batch (cached); take the sort-based probe")
    if hit is None:
        raw = key_limbs_fn(build, build_keys)
        limbs = tuple(l.contiguous() for l in canonical_limbs(raw, nan_unique=False))
        capbits = capbits_for(build.padded_len)
        tbl, converged = _build_insert(limbs, valid_fn() & ~nan_rows(raw), capbits)
        if not converged:
            cache[key] = _DIVERGED
            raise HashTableConvergenceError(
                f"hash-table build did not place every row (capbits={capbits}, "
                f"n={build.padded_len}); caller must fall back to the sort-based probe")
        hit = cache[key] = _TableCache(tbl, limbs, tuple(l.dtype for l in raw), capbits)
    return hit


def _probe_plain(table, build_limbs, probe_limbs, probe_ok, capbits: int):
    """Plain version of K11's probe: walk each probe row's sequence until
    its key or an EMPTY slot.  (build_idx int32 clipped to range, matched)."""
    mask = (1 << capbits) - 1
    slot, stride = _hash_stride(probe_limbs, mask)
    p = probe_ok.shape[0]
    b = max(build_limbs[0].shape[0], 1)
    dev = probe_ok.device
    res = torch.zeros(p, dtype=torch.int64, device=dev)
    hit_any = torch.zeros(p, dtype=torch.bool, device=dev)
    act = torch.nonzero(probe_ok).flatten()
    for _ in range(1 << capbits):
        if act.numel() == 0:
            break
        entry = table[slot[act]].long()
        empty = entry == EMPTY
        rid = torch.clamp(entry, 0, b - 1)
        hit = ~empty
        for bl, pl in zip(build_limbs, probe_limbs):
            hit &= bl[rid] == pl[act]
        res[act[hit]] = rid[hit]
        hit_any[act[hit]] = True
        act = act[~(hit | empty)]
        slot[act] = (slot[act] + stride[act]) & mask
    return torch.clamp(res, 0, b - 1).to(torch.int32), hit_any & probe_ok


def _probe_cuda(table, build_limbs, probe_limbs, probe_ok, capbits: int):
    """Launch K11's probe kernel: one thread per probe row."""
    global PROBE_LAUNCHES
    lib = _lib()
    dev = probe_ok.device
    p = probe_ok.shape[0]
    b = max(build_limbs[0].shape[0], 1)
    probe_limbs = [l.contiguous() for l in probe_limbs]
    for l in probe_limbs:
        if l.device != dev or l.dtype != torch.int32 or l.shape[0] != p:
            raise TypeError(f"pk_probe: unsupported probe limb {l.dtype} "
                            f"{tuple(l.shape)} on {l.device}")
    build_idx = torch.empty(p, dtype=torch.int32, device=dev)
    matched = torch.empty(p, dtype=torch.bool, device=dev)
    native.check(lib.qk_pk_probe(
        native.ptr_array([l.data_ptr() for l in build_limbs]),
        native.ptr_array([l.data_ptr() for l in probe_limbs]), len(probe_limbs),
        probe_ok.contiguous().view(torch.uint8).data_ptr(), p, table.data_ptr(),
        (1 << capbits) - 1, b, build_idx.data_ptr(), matched.view(torch.uint8).data_ptr(),
        native.stream_ptr(dev)), "qk_pk_probe")
    PROBE_LAUNCHES += 1
    return build_idx, matched


def probe(table, build_limbs, probe_limbs, probe_ok, capbits: int):
    """K11's probe over canonical limbs: CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    p, nl = probe_ok.shape[0], len(probe_limbs)
    devprof.on_dispatch(("K11", probe_ok.device.type, p, nl, capbits),
                        lambda: (0.0, float(p * (4 * nl + 1 + 5) + p * 4 + p * 4 * nl),
                                 float(5 * p)))
    if probe_ok.device.type == "cpu":
        return _probe_plain(table, build_limbs, probe_limbs, probe_ok, capbits)
    _require_cuda(probe_ok, "pk_probe")
    return _probe_cuda(table, build_limbs, probe_limbs, probe_ok, capbits)


def pk_probe(table: _TableCache, probe_limbs: Sequence[torch.Tensor],
             probe_ok: torch.Tensor):
    """PK-join probe against a cached build table: (build_idx, matched).
    Probe limbs are coerced to the build's raw limb dtypes first (the sort
    path's discipline), so an int probe key matches a float build key by
    value."""
    coerced = [l.to(dt) for l, dt in zip(probe_limbs, table.raw_dtypes)]
    climbs = canonical_limbs(coerced, nan_unique=False)
    ok = probe_ok & ~nan_rows(coerced)
    return probe(table.tbl, table.limbs, climbs, ok, table.capbits)
