"""Relational kernels over DeviceBatch (PyTorch port of ``quokka_tpu/ops/kernels.py``).

Kernels K4, K17, K24 and K26 live here (``csrc/partition.cu``).  K4, hash
partition + split, replaces the reference's ``_partition_ids`` and
``_split_masks`` with one launch.  K17, the compacted split's plan,
replaces ``_partition_plan``: a stable permutation grouping rows by part,
with each part's count and offset; every part is then a window of it
(``_part_window``, a slice and an ``arange < count`` mask, torch ops) and
one row gather.  K26 routes an adapted exchange (``planner/adapt.py``):
hash, then salt or replicate the fat partition, masks and counts, in one
launch.  K24, the mesh's bucketize and exchange (``mesh_bucketize``),
replaces ``quokka_tpu/parallel/mesh.py``'s ``_local_bucketize`` and its
all_to_all for every shard of a one-card mesh at once.  Masking, compaction, sorting and the group-by wrappers are single
torch primitives (nonzero, gather, stable sort) around the hand-written
kernels; group-by goes to the hash table (K3), the default of the
reference's strategy matrix (``ops/strategy``), or to the sort group-by
under ``groupby=sort``.

PERF.md row 10, ``dense_rank`` and ``sorted_groupby``, is torch primitives
(T): stable sorts on integer order keys, a run test, a cumsum and a
scatter back, then K3's segment aggregates over the ranks.  The
many-to-many join plan (``ops/join``) ranks with it, and K3 falls back to
it when its insert does not converge.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

import numpy as np

from quokka_tpu_torch import config
from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import hashtable, native, strategy
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, StrCol, gather_columns, key_limbs
from quokka_tpu_torch.ops.hashtable import _max_sentinel as max_sentinel
from quokka_tpu_torch.ops.hashtable import _min_sentinel as min_sentinel

# launches of the K4, K17, K24 and K26 CUDA kernels
PARTITION_LAUNCHES = 0
PLAN_LAUNCHES = 0
ADAPT_LAUNCHES = 0
MESH_LAUNCHES = 0
# blocking host reads of split counts on the shuffle path (one per
# compacted split; the masked split reads none), the reference's
# ``shuffle.host_syncs``
SHUFFLE_HOST_SYNCS = 0
MAX_PARTS = 64
# rows of one shard each block of K24 owns (csrc/partition.cu QK_MESH_TILE)
_MESH_TILE = 4096
MAX_MESH_LEAVES = 64

# ---------------------------------------------------------------------------
# masking / compaction
# ---------------------------------------------------------------------------


def apply_mask(batch: DeviceBatch, mask: torch.Tensor) -> DeviceBatch:
    v = batch.valid & mask
    return DeviceBatch(batch.columns, v, None, batch.sorted_by).note_count(
        v.sum(dtype=torch.int32))


def compact(batch: DeviceBatch) -> DeviceBatch:
    """Gather valid rows to the front and shrink to the smallest bucket.
    Costs one host read of the live count."""
    n = batch.count_valid()
    padded = config.bucket_size(n)
    if n == batch.padded_len and padded == batch.padded_len:
        return batch
    idx = torch.nonzero(batch.valid).flatten()
    if idx.shape[0] < padded:
        idx = torch.cat([idx, torch.zeros(padded - idx.shape[0], dtype=idx.dtype,
                                          device=idx.device)])
    valid = torch.arange(padded, device=batch.device) < n
    return batch.take(idx, valid, n)


def compact_if_large(batch: DeviceBatch, threshold: int = 1 << 16) -> DeviceBatch:
    if batch.padded_len <= threshold:
        return batch
    return compact(batch)


# ---------------------------------------------------------------------------
# group-by aggregate
# ---------------------------------------------------------------------------

def groupby_limbs(limbs: Sequence[torch.Tensor], arrays: Sequence[torch.Tensor],
                  ops: Sequence[str], valid: torch.Tensor):
    """Group rows by key limbs: the strategy matrix picks the hash table
    (K3, which records the sort group-by when it falls back to it) or the
    sort group-by (row 10)."""
    if strategy.choice("groupby") == "hashtable":
        return hashtable.hash_groupby(tuple(limbs), tuple(arrays), tuple(ops), valid)
    strategy.note_used("groupby", "sort")
    return sorted_groupby(limbs, arrays, ops, valid)


# ---------------------------------------------------------------------------
# dense rank and the sort group-by (PERF.md row 10, T)
# ---------------------------------------------------------------------------


def dense_rank(limbs: Sequence[torch.Tensor], valid: torch.Tensor):
    """Dense 0..k-1 ids (int64) such that two valid rows share an id iff
    their key limbs are equal, and the number of ids (int32 device scalar).
    Invalid rows get an arbitrary id; callers must mask.

    The reference's ``_dense_rank_impl``: one stable sort with invalid rows
    last and the row id as the last key, run starts where any limb differs
    from the row before, a cumsum, and a scatter back to row order.  The
    sort runs on integer order keys (``lexsort_perm``) and the run test on
    the raw limbs with ``!=``, so -0.0 and +0.0 share a rank and every NaN
    starts a run of its own, as in the reference."""
    n = valid.shape[0]
    dev = valid.device
    perm = _sort_perm(limbs, valid)
    valid_s = valid[perm]
    iota = torch.arange(n, device=dev)
    changed = iota == 0
    for limb in limbs:
        ls = limb[perm]
        changed = changed | (ls != torch.roll(ls, 1))
    starts = valid_s & changed
    ranks_s = torch.clamp(torch.cumsum(starts, 0) - 1, min=0)
    num = starts.sum(dtype=torch.int32)
    ranks = torch.empty(n, dtype=torch.int64, device=dev)
    ranks[perm] = ranks_s
    return ranks, num


def sorted_groupby(limbs: Sequence[torch.Tensor], arrays: Sequence[torch.Tensor],
                   ops: Sequence[str], valid: torch.Tensor):
    """Group-by-aggregate by dense rank: (outs, counts, rep, num) with every
    output indexed by rank, which is key order (the reference's contract).
    ``rep`` is each group's smallest row id; ranks with no row hold n - 1."""
    ranks, num = dense_rank(limbs, valid)
    outs, counts, rep = hashtable.segment_aggs(ranks, valid, tuple(arrays), tuple(ops))
    return tuple(outs), counts, rep, num


def groupby_aggregate(
    batch: DeviceBatch,
    keys: Sequence[str],
    aggs: Sequence[Tuple[str, str, Optional[torch.Tensor]]],
) -> DeviceBatch:
    """aggs: (output_name, op, input_array or None for count).  Returns a
    grouped batch padded to the input's length (compact() to shrink)."""
    n = batch.padded_len
    dev = batch.device
    arrays = tuple(
        a if a is not None else torch.zeros(n, dtype=torch.int32, device=dev)
        for (_, _, a) in aggs
    )
    ops = tuple(op for (_, op, _) in aggs)
    if keys:
        limbs = key_limbs(batch, keys)
        outs, counts, rep, num = groupby_limbs(limbs, arrays, ops, batch.valid)
    else:
        ranks = torch.zeros(n, dtype=torch.int32, device=dev)
        num = torch.clamp(batch.valid.sum(dtype=torch.int32), max=1)
        outs, counts, rep = hashtable.segment_aggs(ranks, batch.valid, arrays, ops)
    cols = gather_columns({k: batch.columns[k] for k in keys}, rep)
    for (name, _, _), arr in zip(aggs, outs):
        cols[name] = NumCol(arr, "f" if arr.is_floating_point() else "i")
    group_valid = torch.arange(n, device=dev) < num
    return DeviceBatch(cols, group_valid, None, None).note_count(num)


# ---------------------------------------------------------------------------
# sort / top-k (Queue 2 rows 9 and 15: stable torch sorts)
# ---------------------------------------------------------------------------


def sort_limbs(batch: DeviceBatch, cols: Sequence[str], descending=None) -> List[torch.Tensor]:
    """Limbs whose ascending lexicographic order is the requested column
    order.  Strings map codes to their dictionary rank (a host argsort of
    the dictionary), so string sorts are true lexicographic sorts; nulls
    (code -1) sort first ascending."""
    if descending is None:
        descending = [False] * len(cols)
    limbs: List[torch.Tensor] = []
    for name, desc in zip(cols, descending):
        c = batch.columns[name]
        if isinstance(c, StrCol):
            order = np.argsort(c.dictionary.values.astype(str), kind="stable")
            rank = np.empty(len(order), dtype=np.int32)
            rank[order] = np.arange(len(order), dtype=np.int32)
            rank_t = torch.from_numpy(rank).to(c.codes.device)
            limb = rank_t[torch.clamp(c.codes, min=0).long()]
            limb = torch.where(c.codes < 0, torch.full_like(limb, -1), limb)
            limbs.append(~limb if desc else limb)
            continue
        p = c.data
        if desc:
            # negation reverses float order; bitwise not reverses signed
            # ints without overflow and flips bools
            p = -p if p.is_floating_point() else ~p
        limbs.append(p)
    return limbs


def _order_key(limb: torch.Tensor) -> torch.Tensor:
    """A key whose signed-integer order is the reference sort's order of
    ``limb``: lax.sort compares floats with -0.0 equal to +0.0 and every
    NaN last, which torch's CUDA radix sort of float bits would not give."""
    if limb.dtype == torch.bool:
        return limb.to(torch.int32)
    if not limb.is_floating_point():
        return limb
    x = limb.to(torch.float64)
    x = torch.where(x == 0.0, torch.zeros((), dtype=x.dtype, device=x.device), x)
    x = torch.where(torch.isnan(x), torch.full((), float("nan"), dtype=x.dtype,
                                                device=x.device), x)
    bits = x.view(torch.int64)
    return bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)


def lexsort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by ``keys`` lexicographically (first
    key most significant; ties keep row order): one stable torch sort per
    key, least significant first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(_order_key(k)[perm], stable=True).indices]
    return perm


def _sort_perm(limbs: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """Stable sort permutation: valid rows first, then by the limbs, ties in
    row order (the reference's iota operand)."""
    return lexsort_perm([(~valid).to(torch.int32), *limbs])


def _prefix_mask(valid: torch.Tensor):
    n = valid.sum(dtype=torch.int32)
    return torch.arange(valid.shape[0], device=valid.device) < n, n


def sort_batch(batch: DeviceBatch, by: Sequence[str], descending=None) -> DeviceBatch:
    perm = _sort_perm(sort_limbs(batch, by, descending), batch.valid)
    out = batch.take(perm, batch.valid, batch.nrows)
    # valid rows are now contiguous at the front: derive the mask on device
    out.valid, n = _prefix_mask(batch.valid)
    out.sorted_by = list(by)
    return out.note_count(n)


def head(batch: DeviceBatch, k: int) -> DeviceBatch:
    b = compact(batch)
    n = min(b.count_valid(), k)
    padded = config.bucket_size(n)
    idx = torch.arange(padded, device=b.device)
    return b.take(idx, idx < n, n)


def top_k(batch: DeviceBatch, by: Sequence[str], k: int, descending=None) -> DeviceBatch:
    return head(sort_batch(batch, by, descending), k)


# ---------------------------------------------------------------------------
# whole-batch reductions (PERF.md row 9, T)
# ---------------------------------------------------------------------------


def reduce_array(arr: torch.Tensor, valid: torch.Tensor, op: str) -> torch.Tensor:
    """Masked sum / count / min / max of one array, a 0-d device tensor (the
    reference's ``reduce_array``): invalid rows count as the op's identity,
    so min and max over no live row give the dtype's largest and smallest
    value (``max_sentinel`` / ``min_sentinel``)."""
    if op == "sum":
        return torch.where(valid, arr, torch.zeros((), dtype=arr.dtype, device=arr.device)).sum()
    if op == "count":
        return valid.sum(dtype=torch.int64)
    if op == "min":
        fill = torch.full((), max_sentinel(arr.dtype), dtype=arr.dtype, device=arr.device)
        return torch.where(valid, arr, fill).min()
    if op == "max":
        fill = torch.full((), min_sentinel(arr.dtype), dtype=arr.dtype, device=arr.device)
        return torch.where(valid, arr, fill).max()
    raise ValueError(op)


# ---------------------------------------------------------------------------
# hash partition (shuffle): kernels K4, K17 and K26
# ---------------------------------------------------------------------------

_LIMB_DT = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3,
            torch.bool: 4}
_ADAPT_MODES = {"salt": 1, "replicate": 2}


def _to_i32_like_xla(limb: torch.Tensor) -> torch.Tensor:
    """Float -> int32 by value as XLA converts: truncate, saturate, NaN -> 0."""
    x = torch.nan_to_num(torch.trunc(limb.to(torch.float64)), nan=0.0)
    return torch.clamp(x, -(2**31), 2**31 - 1).to(torch.int32)


def _hash_pids_plain(limbs: Sequence[torch.Tensor], n_parts: int) -> torch.Tensor:
    """The reference's multiply-xorshift hash of the key limbs, mod n_parts;
    uint32 arithmetic is emulated in int64, masked after every multiply."""
    h = torch.zeros(limbs[0].shape[0], dtype=torch.int64, device=limbs[0].device)
    for limb in limbs:
        if limb.is_floating_point():
            limb = _to_i32_like_xla(limb)
        u = limb.to(torch.int64) & 0xFFFFFFFF
        h = (h * 0x9E3779B1 + u) & 0xFFFFFFFF
        h = h ^ (h >> 16)
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h = h ^ (h >> 13)
    return (h % n_parts).to(torch.int32)


def partition_split_plain(limbs: Sequence[torch.Tensor], pids: Optional[torch.Tensor],
                          valid: torch.Tensor, n_parts: int, masks: bool = True):
    """Plain version of K4: (part ids, masks [n_parts, n], counts [n_parts]),
    the last two None when ``masks`` is False."""
    if limbs:
        pids = _hash_pids_plain(limbs, n_parts)
    if not masks:
        return pids, None, None
    parts = torch.arange(n_parts, dtype=torch.int32, device=valid.device)
    m = (pids[None, :] == parts[:, None]) & valid[None, :]
    return pids, m, m.sum(dim=1, dtype=torch.int32)


def _partition_lib():
    lib = native.library("partition")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_partition_split.argtypes = [
            ctypes.POINTER(P), ctypes.POINTER(I), I, P, P, L, I, P, P, P, P]
        lib.qk_partition_split.restype = I
        lib.qk_adapt_split.argtypes = [
            ctypes.POINTER(P), ctypes.POINTER(I), I, P, P, L, I, I, I, P, P, P, P]
        lib.qk_adapt_split.restype = I
        lib.qk_plan_scratch.argtypes = [L, I]
        lib.qk_plan_scratch.restype = L
        lib.qk_partition_plan.argtypes = [P, P, L, I, P, P, P, P, P]
        lib.qk_partition_plan.restype = I
        PP = ctypes.POINTER(P)
        lib.qk_mesh_bucketize.argtypes = [PP, ctypes.POINTER(I), I, P, I, L, PP, PP,
                                          ctypes.POINTER(I), I, P, P, P, I, P]
        lib.qk_mesh_bucketize.restype = I
        lib.qk_bound = True
    return lib


def _split_args(what: str, limbs, pids, dev, n: int, n_parts: int):
    """Checked kernel arguments of K4 / K26: (limbs, the given ids or None)."""
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"n_parts must be in [1, {MAX_PARTS}], got {n_parts}")
    if dev.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {dev}")
    limbs = [l.contiguous() for l in limbs]
    for l in limbs:
        if l.dtype not in _LIMB_DT or l.device != dev or l.shape[0] != n:
            raise TypeError(f"{what}: unsupported limb {l.dtype} "
                            f"{tuple(l.shape)} on {l.device}")
    if len(limbs) > 16:
        raise ValueError(f"{what}: at most 16 key limbs")
    if limbs:
        return limbs, None
    if pids is None:
        raise ValueError(f"{what} needs limbs or part ids")
    if pids.device != dev or pids.shape != (n,):
        raise TypeError(f"{what}: part ids {tuple(pids.shape)} on {pids.device}")
    return limbs, pids.to(torch.int32).contiguous()


def partition_split(limbs: Sequence[torch.Tensor], pids: Optional[torch.Tensor],
                    valid: torch.Tensor, n_parts: int, masks: bool = True):
    """K4: route rows by the hash of ``limbs`` (or by given ``pids`` when
    ``limbs`` is empty) and return (part ids, masks [n_parts, n] bool,
    counts [n_parts] int32); with ``masks`` False only the ids are written.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"n_parts must be in [1, {MAX_PARTS}], got {n_parts}")
    _charge_split("K4", limbs, pids, valid, n_parts, masks)
    if valid.device.type == "cpu":
        return partition_split_plain(limbs, pids, valid, n_parts, masks)
    global PARTITION_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    limbs, pids_in = _split_args("partition_split", limbs, pids, dev, n, n_parts)
    pids_out = pids_in if pids_in is not None else torch.empty(n, dtype=torch.int32, device=dev)
    m = torch.empty((n_parts, n), dtype=torch.bool, device=dev) if masks else None
    counts = torch.zeros(n_parts, dtype=torch.int32, device=dev) if masks else None
    native.check(_partition_lib().qk_partition_split(
        native.ptr_array([l.data_ptr() for l in limbs]),
        native.int_array([_LIMB_DT[l.dtype] for l in limbs]), len(limbs),
        None if pids_in is None else pids_in.data_ptr(),
        valid.contiguous().view(torch.uint8).data_ptr(), n, n_parts,
        None if pids_in is not None else pids_out.data_ptr(),
        None if m is None else m.data_ptr(), None if counts is None else counts.data_ptr(),
        native.stream_ptr(dev)), "qk_partition_split")
    PARTITION_LAUNCHES += 1
    return pids_out, m, counts


def _charge_split(name: str, limbs, pids, valid, n_parts: int, masks: bool) -> None:
    """devprof's charge of one K4 / K26 split: the limbs (or given ids) and
    the mask read, the ids written (K4 keeps given ids), and with ``masks``
    the per-part masks and counts."""
    ref = limbs[0] if limbs else pids
    n = ref.shape[0]
    out = (4 * n if limbs or name == "K26" else 0) + (n * n_parts + 4 * n_parts if masks else 0)
    devprof.on_dispatch(
        (name, ref.device.type, n, tuple(str(l.dtype) for l in limbs), pids is not None, n_parts, masks),
        lambda: (0.0, float(devprof.nbytes(*limbs, pids, valid) + out), float(out)))


def adapt_split_plain(limbs: Sequence[torch.Tensor], pids: Optional[torch.Tensor],
                      valid: Optional[torch.Tensor], n_parts: int, fat: int, mode: str,
                      masks: bool = True):
    """Plain version of K26.  ``salt``: the fat partition's rows re-dealt by
    row position, ``arange(n) % n_parts`` (the reference's ``_salt_pids``),
    and the masks of the salted ids; ``replicate``: part c's mask is
    ``(pid == c | pid == fat) & valid`` (``_replicate_masks``).  Returns
    (ids: salted, or as hashed; masks; counts)."""
    if limbs:
        pids = _hash_pids_plain(limbs, n_parts)
    pids = pids.to(torch.int32)
    n = pids.shape[0]
    parts = torch.arange(n_parts, dtype=torch.int32, device=pids.device)
    if mode == "salt":
        deal = (torch.arange(n, dtype=torch.int64, device=pids.device) % n_parts).to(torch.int32)
        pids = torch.where(pids == fat, deal, pids)
        hit = pids[None, :] == parts[:, None]
    elif mode == "replicate":
        hit = (pids[None, :] == parts[:, None]) | (pids == fat)[None, :]
    else:
        raise ValueError(f"adapt_split: unknown mode {mode!r}")
    if not masks:
        return pids, None, None
    m = hit & valid[None, :]
    return pids, m, m.sum(dim=1, dtype=torch.int32)


def adapt_split(limbs: Sequence[torch.Tensor], pids: Optional[torch.Tensor],
                valid: Optional[torch.Tensor], n_parts: int, fat: int, mode: str,
                masks: bool = True):
    """K26: K4's routing with the fat partition salted or replicated (see
    ``adapt_split_plain``), in one launch.  ``valid`` may be None when
    ``masks`` is False.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if mode not in _ADAPT_MODES:
        raise ValueError(f"adapt_split: unknown mode {mode!r}")
    if not 0 <= fat < n_parts:
        raise ValueError(f"adapt_split: fat partition {fat} outside [0, {n_parts})")
    ref = limbs[0] if limbs else pids
    _charge_split("K26", limbs, pids, valid, n_parts, masks)
    if ref.device.type == "cpu":
        return adapt_split_plain(limbs, pids, valid, n_parts, fat, mode, masks)
    if masks and valid is None:
        raise ValueError("adapt_split: masks need the validity mask")
    global ADAPT_LAUNCHES
    dev = ref.device
    n = ref.shape[0]
    limbs, pids_in = _split_args("adapt_split", limbs, pids, dev, n, n_parts)
    if valid is not None and (valid.device != dev or valid.shape != (n,)):
        raise TypeError(f"adapt_split: validity {tuple(valid.shape)} on {valid.device}")
    pids_out = torch.empty(n, dtype=torch.int32, device=dev)
    m = torch.empty((n_parts, n), dtype=torch.bool, device=dev) if masks else None
    counts = torch.zeros(n_parts, dtype=torch.int32, device=dev) if masks else None
    native.check(_partition_lib().qk_adapt_split(
        native.ptr_array([l.data_ptr() for l in limbs]),
        native.int_array([_LIMB_DT[l.dtype] for l in limbs]), len(limbs),
        None if pids_in is None else pids_in.data_ptr(),
        None if valid is None else valid.contiguous().view(torch.uint8).data_ptr(), n,
        n_parts, fat, _ADAPT_MODES[mode], pids_out.data_ptr(),
        None if m is None else m.data_ptr(), None if counts is None else counts.data_ptr(),
        native.stream_ptr(dev)), "qk_adapt_split")
    ADAPT_LAUNCHES += 1
    return pids_out, m, counts


def partition_plan_plain(pids: torch.Tensor, valid: torch.Tensor, n_parts: int):
    """Plain version of K17: (perm [n] int32, counts [n_parts] int32, offsets
    [n_parts] int32).  perm lists each part's valid rows in row order, part
    by part, then the invalid rows in row order (the reference's
    ``_partition_plan``); an id outside [0, n_parts) counts as invalid, as
    in the kernel."""
    bucket = torch.where(valid & (pids >= 0) & (pids < n_parts), pids.to(torch.int64),
                         torch.full((), n_parts, dtype=torch.int64, device=pids.device))
    perm = torch.cat([torch.nonzero(bucket == b).flatten() for b in range(n_parts + 1)])
    counts = torch.bincount(bucket, minlength=n_parts + 1)[:n_parts].to(torch.int32)
    return perm.to(torch.int32), counts, (torch.cumsum(counts, 0) - counts).to(torch.int32)


def partition_plan(pids: torch.Tensor, valid: torch.Tensor, n_parts: int):
    """K17: the compacted split's plan (see ``partition_plan_plain``).  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"n_parts must be in [1, {MAX_PARTS}], got {n_parts}")
    n = valid.shape[0]
    devprof.on_dispatch(("K17", valid.device.type, n, n_parts),
                        lambda: (0.0, float(9 * n + 8 * n_parts), float(4 * n + 8 * n_parts)))
    if valid.device.type == "cpu":
        return partition_plan_plain(pids, valid, n_parts)
    global PLAN_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    if dev.type != "cuda" or pids.device != dev or pids.shape != (n,):
        raise RuntimeError(f"partition_plan: ids {tuple(pids.shape)} on {pids.device}, "
                           f"validity {tuple(valid.shape)} on {dev}")
    # the converted copies live in locals until the launch has been issued
    pids32 = pids.to(torch.int32).contiguous()
    v8 = valid.contiguous().view(torch.uint8)
    lib = _partition_lib()
    scratch = torch.empty(max(lib.qk_plan_scratch(n, n_parts), 1), dtype=torch.int64, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n_parts, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_parts, dtype=torch.int32, device=dev)
    native.check(lib.qk_partition_plan(
        pids32.data_ptr(), v8.data_ptr(), n, n_parts, scratch.data_ptr(), perm.data_ptr(),
        counts.data_ptr(), offsets.data_ptr(), native.stream_ptr(dev)), "qk_partition_plan")
    PLAN_LAUNCHES += 1
    return perm, counts, offsets


def part_window(perm: torch.Tensor, offset: int, count: int, out_size: int):
    """Row indices and validity of one part's window of the plan's perm (the
    reference's ``_part_window``): ``out_size`` entries from ``offset``,
    clipped to the last row, the first ``count`` of them valid."""
    pos = torch.arange(out_size, dtype=torch.int64, device=perm.device)
    idx = perm[torch.clamp(pos + offset, max=perm.shape[0] - 1)]
    return idx, pos < count


def partition_ids(batch: DeviceBatch, keys: Sequence[str], n_parts: int) -> torch.Tensor:
    """Partition id of every row: the reference's multiply-xorshift hash of
    the key limbs, mod n_parts (bit-identical)."""
    pids, _, _ = partition_split(key_limbs(batch, keys), None, batch.valid, n_parts,
                                 masks=False)
    return pids


def compact_choice(batch: DeviceBatch, n_parts: int) -> bool:
    """Does this split take the compacted mode?  Forced ``shuffle=compacted``:
    past 2^16 padded rows (below that the counts readback costs more than
    it saves); else when n_parts * padded_len also passes
    ``config.SHUFFLE_MASKED_CAP``.  The choice is recorded as having run."""
    big = batch.padded_len > (1 << 16)
    if strategy.choice("shuffle") == "compacted":
        compact = big
    else:
        compact = big and n_parts * batch.padded_len > config.SHUFFLE_MASKED_CAP
    strategy.note_used("shuffle", "compacted" if compact else "masked")
    return compact


def masked_parts(batch: DeviceBatch, masks, counts) -> List[DeviceBatch]:
    return [
        DeviceBatch(batch.columns, masks[p], None, batch.sorted_by).note_count(counts[p])
        for p in range(masks.shape[0])
    ]


def compacted_parts(batch: DeviceBatch, part_ids: torch.Tensor,
                    n_parts: int) -> List[DeviceBatch]:
    """The compacted split: K17's plan, one blocking read of its counts,
    then each part a gather of its window, at one uniform bucket when the
    split is balanced enough (n_parts * uniform <= 2 * bucket(total)), else
    at a bucket of its own (the reference's padded lengths)."""
    global SHUFFLE_HOST_SYNCS
    perm, counts, _offsets = partition_plan(part_ids, batch.valid, n_parts)
    SHUFFLE_HOST_SYNCS += 1
    host_counts = counts.tolist()
    uniform = config.bucket_size(max(host_counts))
    use_uniform = n_parts * uniform <= 2 * config.bucket_size(max(sum(host_counts), 1))
    out, offset = [], 0
    for cnt in host_counts:
        padded = uniform if use_uniform else config.bucket_size(cnt)
        idx, valid = part_window(perm, offset, cnt, padded)
        out.append(batch.take(idx, valid, cnt))
        offset += cnt
    return out


def split_by_partition(batch: DeviceBatch, part_ids: torch.Tensor, n_parts: int,
                       compact: Optional[bool] = None) -> List[DeviceBatch]:
    """Split a batch into n per-partition batches.  Masked (the default):
    every part is a view over the parent's columns with its own validity
    mask and a device live count; no copies, no host sync.  Compacted
    (``compact=True``, or as ``compact_choice`` decides): see
    ``compacted_parts``."""
    if n_parts == 1:
        return [batch]
    if compact is None:
        compact = compact_choice(batch, n_parts)
    if compact:
        return compacted_parts(batch, part_ids, n_parts)
    _, masks, counts = partition_split([], part_ids, batch.valid, n_parts)
    return masked_parts(batch, masks, counts)


def hash_split(batch: DeviceBatch, keys: Sequence[str], n_parts: int) -> List[DeviceBatch]:
    """``split_by_partition(batch, partition_ids(batch, keys, n), n)``: the
    engine's hash-exchange path.  Masked, it is one K4 launch; compacted,
    K4 writes the ids alone and K17 plans the split."""
    if n_parts == 1:
        return [batch]
    limbs = key_limbs(batch, keys)
    if compact_choice(batch, n_parts):
        pids, _, _ = partition_split(limbs, None, batch.valid, n_parts, masks=False)
        return compacted_parts(batch, pids, n_parts)
    _, masks, counts = partition_split(limbs, None, batch.valid, n_parts)
    return masked_parts(batch, masks, counts)


# ---------------------------------------------------------------------------
# the mesh's bucketize and exchange: kernel K24
# ---------------------------------------------------------------------------


def mesh_bucketize_plain(cols: Sequence[torch.Tensor], valid: torch.Tensor,
                         key_idx: Sequence[int], n_parts: int):
    """Plain version of K24: (exchanged columns, exchanged validity).

    ``cols`` and ``valid`` hold a global batch of ``n_parts`` shards of N
    rows each.  A valid row of shard s whose key limbs (``cols[i]`` for i in
    ``key_idx``) hash to d (K4's hash, mod n_parts) lands at row
    ``d * n_parts * N + s * N + pos``, pos its rank among the valid rows of
    shard s bound for d in row order; every other output row is zero.  The
    hash, one stable sort of (shard, bucket) and an index put."""
    total = valid.shape[0]
    n = total // n_parts
    dev = valid.device
    pid = _hash_pids_plain([cols[i] for i in key_idx], n_parts).to(torch.int64)
    bucket = torch.where(valid, pid, torch.full((), n_parts, dtype=torch.int64, device=dev))
    iota = torch.arange(total, dtype=torch.int64, device=dev)
    key = (iota // n) * (n_parts + 1) + bucket
    perm = torch.sort(key, stable=True).indices
    ks = key[perm]
    counts = torch.bincount(key, minlength=n_parts * (n_parts + 1))
    pos = iota - (torch.cumsum(counts, 0) - counts)[ks]
    dst = ks % (n_parts + 1)
    live = dst < n_parts
    out_idx = dst[live] * (n_parts * n) + (ks[live] // (n_parts + 1)) * n + pos[live]
    rows = perm[live]
    out_rows = n_parts * total
    out_valid = torch.zeros(out_rows, dtype=torch.bool, device=dev)
    out_valid[out_idx] = True
    outs = []
    for c in cols:
        o = torch.zeros(out_rows, dtype=c.dtype, device=dev)
        o[out_idx] = c[rows]
        outs.append(o)
    return outs, out_valid


def _mesh_args(cols, valid, key_idx, n_parts: int) -> None:
    """Check K24's arguments (on any device: the plain version takes the
    same ones)."""
    if not 1 <= n_parts <= MAX_PARTS:
        raise ValueError(f"mesh_bucketize: n_parts must be in [1, {MAX_PARTS}], got {n_parts}")
    total = valid.shape[0]
    if valid.dtype != torch.bool or valid.dim() != 1 or total % n_parts or total == 0:
        raise ValueError(f"mesh_bucketize: validity of {total} rows is not {n_parts} shards")
    if not key_idx or len(key_idx) > 16 or len(cols) > MAX_MESH_LEAVES:
        raise ValueError(f"mesh_bucketize: {len(key_idx)} key limbs (1 to 16), {len(cols)} "
                         f"columns (at most {MAX_MESH_LEAVES})")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != total or c.device != valid.device \
                or c.element_size() not in (1, 4, 8):
            raise TypeError(f"mesh_bucketize: unsupported column {c.dtype} "
                            f"{tuple(c.shape)} on {c.device}")
    for i in key_idx:
        if cols[i].dtype not in _LIMB_DT:
            raise TypeError(f"mesh_bucketize: key limb of {cols[i].dtype}")


def mesh_bucketize(cols: Sequence[torch.Tensor], valid: torch.Tensor,
                   key_idx: Sequence[int], n_parts: int):
    """K24: the exchanged layout of ``mesh_bucketize_plain`` in one call
    (three launches: ids and counts, the scan, the stable scatter of every
    column).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    _mesh_args(cols, valid, key_idx, n_parts)
    total = valid.shape[0]
    limbs = [cols[i] for i in key_idx]
    out_w = sum(c.element_size() for c in cols) + 1
    devprof.on_dispatch(
        ("K24", valid.device.type, total, tuple(key_idx), tuple(str(c.dtype) for c in cols),
         n_parts),
        lambda: (0.0, float(devprof.nbytes(*limbs, valid, *cols) + 8 * total
                            + n_parts * total * out_w), float(n_parts * total * out_w)))
    if valid.device.type == "cpu":
        return mesh_bucketize_plain(cols, valid, key_idx, n_parts)
    if valid.device.type != "cuda":
        raise RuntimeError(f"mesh_bucketize: unsupported device {valid.device}")
    global MESH_LAUNCHES
    dev = valid.device
    n = total // n_parts
    cols = [c.contiguous() for c in cols]
    limbs = [cols[i] for i in key_idx]

    def raw(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t

    outs = [torch.empty(n_parts * total, dtype=c.dtype, device=dev) for c in cols]
    out_valid = torch.empty(n_parts * total, dtype=torch.bool, device=dev)
    tiles = -(-n // _MESH_TILE)
    bucket = torch.empty(total, dtype=torch.int32, device=dev)
    hist = torch.empty(n_parts * (n_parts + 1) * tiles, dtype=torch.int32, device=dev)
    native.check(_partition_lib().qk_mesh_bucketize(
        native.ptr_array([raw(l).data_ptr() for l in limbs]),
        native.int_array([_LIMB_DT[l.dtype] for l in limbs]), len(limbs),
        valid.contiguous().view(torch.uint8).data_ptr(), n_parts, n,
        native.ptr_array([raw(c).data_ptr() for c in cols]),
        native.ptr_array([raw(o).data_ptr() for o in outs]),
        native.int_array([c.element_size() for c in cols]), len(cols),
        out_valid.view(torch.uint8).data_ptr(), bucket.data_ptr(), hist.data_ptr(), tiles,
        native.stream_ptr(dev)), "qk_mesh_bucketize")
    MESH_LAUNCHES += 1
    return outs, out_valid
