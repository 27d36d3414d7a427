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
``(outs, counts, rep, num)`` with every output indexed by group rank.  Group
ranks follow table-slot order, so group order differs from the reference's
(claim order); no consumer depends on it, and results compare after a sort
on the keys.  A non-converged insert never aliases rows to slot 0:
``hash_groupby`` reads the flag on the host (one scalar read per call, the
price of never answering wrong) and reruns the batch through the sort
group-by (``kernels.sorted_groupby``), as the reference does; the plain
version returns None for such a batch, and the PK build raises
``HashTableConvergenceError``.

Kernel K11, the PK-join build and probe: ``build_table`` inserts a build
batch's key limbs once (K3's insert alone, through ``qk_hash_build``) and
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

import ctypes
from typing import List, Sequence, Tuple

import torch

from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import native, strategy

EMPTY = 2**31 - 1

# launches of the CUDA path (insert + segment kernels count as one)
LAUNCHES = 0
# launches of K11: PK build inserts and probes
BUILD_LAUNCHES = 0
PROBE_LAUNCHES = 0

_OP_CODES = {"sum": 0, "count": 1, "min": 2, "max": 3, "mean": 0}
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
    CUDA tensors launch K3's segment kernel; CPU tensors the plain version."""
    if valid.device.type == "cpu":
        return segment_aggs_plain(ranks, valid, arrays, ops)
    _require_cuda(valid, "segment_aggs")
    n = valid.shape[0]
    ident = torch.arange(n, dtype=torch.int64, device=valid.device)
    return _segment_cuda(ranks.to(torch.int32).contiguous(), ident, valid,
                         tuple(arrays), tuple(ops))


def hash_groupby(limbs: Sequence[torch.Tensor], arrays: Sequence[torch.Tensor],
                 ops: Sequence[str], valid: torch.Tensor):
    """Group by key limbs and aggregate: (outs, counts, rep, num).
    CUDA tensors launch K3; CPU tensors take the plain version.  When the
    insert did not converge, the batch is grouped by the sort group-by
    instead (``groupby`` is then recorded as ``sort``)."""
    from quokka_tpu_torch.ops import kernels  # kernels imports this module

    n = valid.shape[0]
    devprof.on_dispatch(
        ("K3", valid.device.type, n, tuple(str(l.dtype) for l in limbs), tuple(str(a.dtype) for a in arrays)),
        lambda: (0.0, float(devprof.nbytes(*limbs, *arrays, valid) + n * (8 + sum(
            a.element_size() for a in arrays))), float(n * (8 + sum(a.element_size()
                                                                   for a in arrays)))))
    if valid.device.type == "cpu":
        res = hash_groupby_plain(limbs, arrays, ops, valid)
    else:
        _require_cuda(valid, "hash_groupby")
        res = _hash_groupby_cuda(tuple(limbs), tuple(arrays), tuple(ops), valid)
    if res is None:
        strategy.note_used("groupby", "sort")
        return kernels.sorted_groupby(limbs, arrays, ops, valid)
    strategy.note_used("groupby", "hashtable")
    return res


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")


def _lib():
    lib = native.library("hashtable")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        PP, PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.qk_hash_insert.argtypes = [PP, I, P, L, P, ctypes.c_uint, P, P, P]
        lib.qk_hash_insert.restype = I
        lib.qk_segment_aggs.argtypes = [P, P, P, L, P, P, I, PP, PP, PI, PI, P]
        lib.qk_segment_aggs.restype = I
        lib.qk_hash_build.argtypes = [PP, I, P, L, P, ctypes.c_uint, P, P]
        lib.qk_hash_build.restype = I
        lib.qk_pk_probe.argtypes = [PP, PP, I, P, L, P, ctypes.c_uint, L, P, P, P]
        lib.qk_pk_probe.restype = I
        lib.qk_bound = True
    return lib


def _hash_groupby_cuda(limbs, arrays, ops, valid):
    global LAUNCHES
    lib = _lib()
    dev = valid.device
    n = valid.shape[0]
    climbs = [l.contiguous() for l in canonical_limbs(limbs)]
    if len(climbs) > 16:
        raise ValueError("hash_groupby: at most 16 key limbs")
    capbits = capbits_for(n)
    cap = 1 << capbits
    valid_u8 = valid.contiguous().view(torch.uint8)
    table = torch.full((cap,), EMPTY, dtype=torch.int32, device=dev)
    myslot = torch.empty(n, dtype=torch.int32, device=dev)
    failed = torch.zeros(1, dtype=torch.int32, device=dev)
    native.check(lib.qk_hash_insert(
        native.ptr_array([l.data_ptr() for l in climbs]), len(climbs),
        valid_u8.data_ptr(), n, table.data_ptr(), cap - 1, myslot.data_ptr(),
        failed.data_ptr(), native.stream_ptr(dev)), "qk_hash_insert")
    flag = (table != EMPTY).to(torch.int64)
    rank_of_slot = torch.cumsum(flag, 0) - flag
    num = flag.sum().to(torch.int32)
    outs, counts, rep = _segment_cuda(myslot, rank_of_slot, valid, arrays, ops)
    LAUNCHES += 1
    if int(failed.item()):
        return None
    return outs, counts, rep, num


def _segment_cuda(myslot, rank_of_slot, valid, arrays, ops):
    """Launch the segment kernel: row i adds into group
    rank_of_slot[myslot[i]]."""
    lib = _lib()
    dev = valid.device
    n = valid.shape[0]
    if len(ops) > 32:
        raise ValueError("segment aggregates: at most 32 per launch")
    valid_u8 = valid.contiguous().view(torch.uint8)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    rep = torch.full((n,), n - 1, dtype=torch.int32, device=dev)
    ins, outs, codes, dts, kept = [], [], [], [], []
    for arr, op in zip(arrays, ops):
        if op == "first":
            kept.append(None)
            continue
        if op not in _OP_CODES:
            raise ValueError(f"unknown agg {op}")
        if arr.dtype not in _DT_CODES or arr.device != dev or arr.shape[0] != n:
            raise TypeError(f"segment aggregates: unsupported input {arr.dtype} "
                            f"{tuple(arr.shape)} on {arr.device}")
        arr = arr.contiguous()
        if op == "count":
            out = torch.zeros(n, dtype=torch.int32, device=dev)
        elif op in ("min", "max"):
            ident = _max_sentinel(arr.dtype) if op == "min" else _min_sentinel(arr.dtype)
            out = torch.full((n,), ident, dtype=arr.dtype, device=dev)
        else:
            out = torch.zeros(n, dtype=arr.dtype, device=dev)
        ins.append(arr.data_ptr())
        outs.append(out.data_ptr())
        codes.append(_OP_CODES[op])
        dts.append(_DT_CODES[arr.dtype])
        kept.append((arr, out))
    native.check(lib.qk_segment_aggs(
        myslot.data_ptr(), rank_of_slot.data_ptr(), valid_u8.data_ptr(), n,
        counts.data_ptr(), rep.data_ptr(), len(ins), native.ptr_array(ins),
        native.ptr_array(outs), native.int_array(codes), native.int_array(dts),
        native.stream_ptr(dev)), "qk_segment_aggs")
    results = []
    for arr, op, k in zip(arrays, ops, kept):
        if op == "first":
            results.append(arr[rep.long()])
        elif op == "mean":
            s = k[1]
            results.append(s / torch.clamp(counts, min=1).to(s.dtype))
        else:
            results.append(k[1])
    return tuple(results), counts, rep


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
    """Insert-only pass of K3: (table, converged).  The CUDA route reads the
    device flag once: the one host read a build pays."""
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
