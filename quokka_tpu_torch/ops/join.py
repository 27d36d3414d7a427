"""Device PK joins (PyTorch port of ``quokka_tpu/ops/join.py``).

``hash_join_pk`` joins a probe batch against a build batch whose keys are
unique.  The output is probe-aligned and mask-based, with no host sync on
the probe path.  Two strategies serve the probe (``ops/strategy`` op
``join_build``):

- ``hashtable``: kernel K11 (``ops/hashtable.build_table`` + ``pk_probe``),
  the GPU default.  A build whose insert did not converge is remembered on
  the batch and takes the sorted probe instead; it never raises.
- ``sort``: kernel K12.  The build's key limbs are sorted once per build
  batch by stable torch sorts (invalid rows last, the row id as the last
  key), and ``csrc/join.cu`` runs a lexicographic lower bound per probe row
  on ``csrc/search.cuh``'s typed search (``pk_probe_sorted``;
  ``_pk_probe_sorted_plain`` beside it).

``build_keys_unique`` answers, once per finalized build, whether the PK path
applies, from the same cached structure the probe will use.

``hash_join_general`` serves a build whose keys repeat, and every left
join.  Its plan is kernel K13p (``_mm_plan``, ``csrc/rank.cu``): one
stable radix sort of the probe and build keys together (``csrc/sort.cuh``:
the valid rows only, on keys packed by their ranges; the invalid rows
behind in row order), then K10's pass over the sorted keys in a plan mode
(the dense rank, the probe ranks, each rank's offset, the valid build rows
in (rank, row) order, which the stable sort already gives, and the invalid
build rows, the sorted order's tail) and a fill launch (the offsets past
the last rank, the match counts and their total); ``_mm_plan_plain`` is its
plain version.  Semi and anti joins stop at the match counts (a probe row matches
when its rank has a build row).
Inner and left joins read the output total on the host once per probe
batch to pick the output bucket, as the reference does, then kernel K13
(``mm_expand``, ``csrc/join.cu``) writes one (probe row, build row) pair
per output row; ``_mm_expand_plain`` is its plain version.

The mesh joins (``parallel/mesh_exec.py``) match by rank within each shard:
``_pk_match`` is the dense rank of the probe and build keys together (row
10) followed by kernel K14 (``pk_match_ranks``, ``csrc/join.cu``): each
rank's least valid build row, gathered by probe rank, in a build pass (one
``atomicMin`` per valid build row into one int32 per rank, zeroed by one
memset) and a probe pass (one gather a row); a probe row matches where its
rank's minimum exists.  ``_pk_match_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import hashtable, kernels, native, strategy
from quokka_tpu_torch.ops.batch import (
    DeviceBatch,
    gather_columns,
    key_limbs,
    null_mask,
    with_nulls,
)

# launches of the K12, K13 and K14 CUDA kernels; K12's launches that took
# the runtime-dispatch kernel (a limb signature csrc/join.cu does not
# compile typed) are also counted apart
SORTED_PROBE_LAUNCHES = 0
SORTED_PROBE_DISPATCH_LAUNCHES = 0
EXPAND_LAUNCHES = 0
PK_MATCH_LAUNCHES = 0
# K13p's plans (its fill launch; its pass is counted as K10's,
# ``kernels.RANK_LAUNCHES``)
MM_PLAN_LAUNCHES = 0
JOIN_HOWS = ("inner", "left", "semi", "anti")
PK_HOWS = ("inner", "semi", "anti")  # the executor sends every left join to the general path

_LIMB_DT = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3,
            torch.bool: 4}


def _nonnull_valid(batch: DeviceBatch, keys) -> torch.Tensor:
    """Rows with any null join key never match (SQL null-join semantics)."""
    v = batch.valid
    for k in keys:
        v = v & ~null_mask(batch.columns[k])
    return v


def _count_true(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def _sort_build_keys(limbs: Sequence[torch.Tensor], valid: torch.Tensor):
    """Sort the build side's key limbs once (invalid/null-key rows last).
    Returns (sorted_limbs, perm int32, n_valid device scalar)."""
    inv = (~valid).to(torch.int32)
    perm = kernels.lexsort_perm([inv, *limbs])
    sorted_limbs = tuple(l[perm].contiguous() for l in limbs)
    return sorted_limbs, perm.to(torch.int32), valid.sum(dtype=torch.int64)


def _lex_lt_eq(a, b):
    """Elementwise lexicographic (a < b, a == b) over limb tuples."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt, eq


def _pk_probe_sorted_plain(sorted_limbs, perm, n_valid, probe_limbs, probe_ok):
    """Plain version of K12: a vectorised lexicographic lower bound, one
    gather per limb per halving.  (build_idx int32, matched)."""
    p = probe_ok.shape[0]
    nb = perm.shape[0]
    dev = probe_ok.device
    lo = torch.zeros(p, dtype=torch.int64, device=dev)
    hi = n_valid.to(torch.int64).expand(p).clone()
    for _ in range(max(1, nb.bit_length()) + 1):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, 0, nb - 1)
        lt, _ = _lex_lt_eq(tuple(l[midc] for l in sorted_limbs), probe_limbs)
        go = lo < hi
        lo = torch.where(go & lt, mid + 1, lo)
        hi = torch.where(go & ~lt, mid, hi)
    pos = torch.clamp(lo, 0, nb - 1)
    _, eq = _lex_lt_eq(tuple(l[pos] for l in sorted_limbs), probe_limbs)
    matched = probe_ok & eq & (lo < n_valid)
    build_idx = torch.clamp(perm[pos].long(), 0, nb - 1).to(torch.int32)
    return build_idx, matched


def _join_lib():
    lib = native.library("join")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        PP, PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.qk_sorted_probe.argtypes = [PP, PP, PI, I, P, P, L, P, L, P, P, PI, P]
        lib.qk_sorted_probe.restype = I
        lib.qk_mm_expand.argtypes = [P, L, P, P, L, P, P, P, L, P, P, P, P, P]
        lib.qk_mm_expand.restype = I
        lib.qk_pk_match.argtypes = [P, P, L, P, P, L, L, P, P, P, P]
        lib.qk_pk_match.restype = I
        lib.qk_bound = True
    return lib


def _pk_probe_sorted_cuda(sorted_limbs, perm, n_valid, probe_limbs, probe_ok):
    global SORTED_PROBE_LAUNCHES, SORTED_PROBE_DISPATCH_LAUNCHES
    lib = _join_lib()
    dev = probe_ok.device
    p = probe_ok.shape[0]
    nb = perm.shape[0]
    if not 1 <= len(sorted_limbs) <= 16:
        raise ValueError("pk_probe_sorted: 1 to 16 key limbs")
    if nb >= 1 << 31 or p >= 1 << 31:
        raise ValueError("pk_probe_sorted: 32-bit positions take fewer than 2^31 build and "
                         "probe rows")
    # the contiguous copies live in locals until the launch has been issued
    sorted_limbs = [s.contiguous() for s in sorted_limbs]
    probe_limbs = [l.contiguous() for l in probe_limbs]
    for s, l in zip(sorted_limbs, probe_limbs):
        if (s.dtype not in _LIMB_DT or l.dtype != s.dtype or s.device != dev
                or l.device != dev or l.shape[0] != p or s.shape[0] != nb):
            raise TypeError(f"pk_probe_sorted: unsupported limbs {s.dtype}/{l.dtype} "
                            f"on {s.device}/{l.device}")
    perm = perm.contiguous()
    ok8 = probe_ok.contiguous().view(torch.uint8)
    n_valid = n_valid.to(device=dev, dtype=torch.int64).reshape(1)
    build_idx = torch.empty(p, dtype=torch.int32, device=dev)
    matched = torch.empty(p, dtype=torch.bool, device=dev)
    typed = ctypes.c_int(0)

    def arg(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t

    native.check(lib.qk_sorted_probe(
        native.ptr_array([arg(s).data_ptr() for s in sorted_limbs]),
        native.ptr_array([arg(l).data_ptr() for l in probe_limbs]),
        native.int_array([_LIMB_DT[s.dtype] for s in sorted_limbs]), len(sorted_limbs),
        perm.data_ptr(), n_valid.data_ptr(), nb, ok8.data_ptr(), p, build_idx.data_ptr(),
        matched.view(torch.uint8).data_ptr(), ctypes.byref(typed), native.stream_ptr(dev)),
        "qk_sorted_probe")
    SORTED_PROBE_LAUNCHES += 1
    if not typed.value:
        SORTED_PROBE_DISPATCH_LAUNCHES += 1
    return build_idx, matched


def pk_probe_sorted(sorted_limbs, perm, n_valid, probe_limbs, probe_ok):
    """K12: probe a presorted build.  Probe limbs must already carry the
    sorted limbs' dtypes.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    p = probe_ok.shape[0]
    devprof.on_dispatch(
        ("K12", probe_ok.device.type, p, perm.shape[0], tuple(str(l.dtype) for l in probe_limbs)),
        lambda: (0.0, float(devprof.nbytes(*probe_limbs, probe_ok, *sorted_limbs) + 9 * p),
                 float(5 * p)))
    if probe_ok.device.type == "cpu":
        return _pk_probe_sorted_plain(sorted_limbs, perm, n_valid, probe_limbs, probe_ok)
    if probe_ok.device.type != "cuda":
        raise RuntimeError(f"pk_probe_sorted: unsupported device {probe_ok.device}")
    return _pk_probe_sorted_cuda(sorted_limbs, perm, n_valid, probe_limbs, probe_ok)


# ---------------------------------------------------------------------------
# the mesh's rank PK match: kernel K14
# ---------------------------------------------------------------------------


def _pk_match_plain(ranks: torch.Tensor, valid: torch.Tensor, p: int):
    """Plain version of K14, the reference's ``_pk_match`` arithmetic after
    its dense rank: over ``ranks`` / ``valid`` of [probe (p rows) | build],
    each rank's least valid build row (a scatter-min, b where it has none)
    and its valid build rows (a bincount), gathered by probe rank.  K14
    computes the same from the minimum alone: a rank has a valid build row
    exactly when its minimum is below b.
    (build_idx int32 clipped to [0, b - 1], matched bool)."""
    n = valid.shape[0]
    b = n - p
    dev = valid.device
    rp, rb = ranks[:p], ranks[p:]
    vp, vb = valid[:p], valid[p:]
    iota_b = torch.arange(b, dtype=torch.int32, device=dev)
    first = torch.full((n,), b, dtype=torch.int32, device=dev).scatter_reduce_(
        0, rb, torch.where(vb, iota_b, torch.full_like(iota_b, b)), "amin")
    cnt = torch.bincount(rb[vb], minlength=n)
    build_idx = torch.clamp(first[rp], 0, b - 1).to(torch.int32)
    return build_idx, vp & (cnt[rp] > 0)


def _pk_match_cuda(ranks: torch.Tensor, valid: torch.Tensor, p: int):
    global PK_MATCH_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    if ranks.device != dev or ranks.shape != (n,):
        raise TypeError(f"pk_match: ranks {tuple(ranks.shape)} on {ranks.device}, "
                        f"validity of {n} rows on {dev}")
    ranks = ranks.to(torch.int64).contiguous()
    v8 = valid.contiguous().view(torch.uint8)
    first = torch.empty(n, dtype=torch.int32, device=dev)  # freed on return
    build_idx = torch.empty(p, dtype=torch.int32, device=dev)
    matched = torch.empty(p, dtype=torch.bool, device=dev)
    native.check(_join_lib().qk_pk_match(
        ranks.data_ptr(), v8.data_ptr(), p, ranks[p:].data_ptr(), v8[p:].data_ptr(),
        n - p, n, first.data_ptr(), build_idx.data_ptr(), matched.view(torch.uint8).data_ptr(),
        native.stream_ptr(dev)), "qk_pk_match")
    PK_MATCH_LAUNCHES += 1
    return build_idx, matched


def pk_match_ranks(ranks: torch.Tensor, valid: torch.Tensor, p: int):
    """K14: (build_idx int32 [p], matched bool [p]) of the first ``p`` rows
    (the probe) against the rest (the build), given every row's dense rank.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    n = valid.shape[0]
    if not 0 <= p < n:
        raise ValueError(f"pk_match: {p} probe rows of {n} leave no build row")
    devprof.on_dispatch(("K14", valid.device.type, p, n - p),
                        lambda: (0.0, float(9 * n + 5 * p), float(5 * p)))
    if valid.device.type == "cpu":
        return _pk_match_plain(ranks, valid, p)
    if valid.device.type != "cuda":
        raise RuntimeError(f"pk_match: unsupported device {valid.device}")
    return _pk_match_cuda(ranks, valid, p)


def _pk_match(limbs: Sequence[torch.Tensor], valid: torch.Tensor, p: int):
    """The reference's ``_pk_match``: dense ranks of the concatenated probe
    and build key limbs (K10), then K14.  A probe row matches when its
    key has a valid build row; build_idx is the least such row."""
    ranks, _ = kernels.dense_rank(limbs, valid)
    return pk_match_ranks(ranks, valid, p)


def _build_sorted_cached(build: DeviceBatch, build_keys: Sequence[str]):
    """Sorted-key view of a build table, cached on the batch object: the
    probe executor joins the same finalized build against every probe
    batch, so the sort is paid once."""
    cache = getattr(build, "_pk_sorted_cache", None)
    if cache is None:
        cache = build._pk_sorted_cache = {}
    key = tuple(build_keys)
    hit = cache.get(key)
    if hit is None:
        limbs = key_limbs(build, build_keys)
        hit = cache[key] = _sort_build_keys(limbs, _nonnull_valid(build, build_keys))
    return hit


def _table_of(build: DeviceBatch, build_keys: Sequence[str]):
    """The build's cached K11 table, or None when its insert diverged."""
    try:
        return hashtable.build_table(build, build_keys, key_limbs,
                                     lambda: _nonnull_valid(build, build_keys))
    except hashtable.HashTableConvergenceError:
        return None


def require_join_how(how: str, hows: Sequence[str] = JOIN_HOWS) -> None:
    if how not in hows:
        raise ValueError(f"join how={how!r}: expected one of {tuple(hows)}")


def hash_join_pk(probe: DeviceBatch, build: DeviceBatch, probe_keys: Sequence[str],
                 build_keys: Sequence[str], how: str = "inner",
                 build_payload: Sequence[str] = ()) -> DeviceBatch:
    """Join where build keys are unique (inner, semi or anti; the executor
    sends every left join to ``hash_join_general``, as the reference does).
    Probe-aligned; the probe path has no host sync.  The cached build pays
    one scalar read per build batch (the hash-table convergence check); a
    diverged build is remembered on the batch and every probe takes the
    sorted path."""
    require_join_how(how, PK_HOWS)
    probe_limbs = key_limbs(probe, probe_keys)
    probe_ok = _nonnull_valid(probe, probe_keys)
    table = None
    if strategy.choice("join_build") == "hashtable":
        table = _table_of(build, build_keys)
    if table is not None:
        assert len(probe_limbs) == len(table.raw_dtypes), "join key column types must match"
        build_idx, matched = hashtable.pk_probe(table, probe_limbs, probe_ok)
        strategy.note_used("join_build", "hashtable")
    else:
        strategy.note_used("join_build", "sort")
        sorted_limbs, perm, n_valid = _build_sorted_cached(build, build_keys)
        assert len(probe_limbs) == len(sorted_limbs), "join key column types must match"
        build_idx, matched = pk_probe_sorted(
            sorted_limbs, perm, n_valid,
            [l.to(s.dtype) for l, s in zip(probe_limbs, sorted_limbs)], probe_ok)
    if how == "semi":
        return kernels.apply_mask(probe, matched)
    if how == "anti":
        return kernels.apply_mask(probe, probe.valid & ~matched)
    cols = dict(probe.columns)
    cols.update(gather_columns({n: build.columns[n] for n in build_payload}, build_idx))
    # the output count stays on the device; consumers read it batches later
    return DeviceBatch(cols, matched, None, probe.sorted_by).note_count(_count_true(matched))


# ---------------------------------------------------------------------------
# many-to-many and left joins: the plan, kernel K13p, and the expand, kernel K13
# ---------------------------------------------------------------------------


def _concat_limbs(probe: DeviceBatch, build: DeviceBatch, probe_keys, build_keys):
    """Probe then build key limbs in one column each (build limbs cast to
    the probe's dtypes), and the rows that may match."""
    lp = key_limbs(probe, probe_keys)
    lb = key_limbs(build, build_keys)
    if len(lp) != len(lb):
        raise ValueError("join key column types must match")
    limbs = [torch.cat([a, b.to(a.dtype)]) for a, b in zip(lp, lb)]
    valid = torch.cat([_nonnull_valid(probe, probe_keys), _nonnull_valid(build, build_keys)])
    return limbs, valid


def _mm_counts_plain(limbs, valid, p: int):
    """Dense ranks of probe+build keys: (build rows per probe row, build
    rows per rank, probe ranks, build ranks)."""
    n = valid.shape[0]
    ranks, _ = kernels.dense_rank(limbs, valid)
    rp, rb = ranks[:p], ranks[p:]
    cnt = torch.zeros(n, dtype=torch.int64, device=valid.device).index_add_(
        0, rb, valid[p:].to(torch.int64))
    match_count = torch.where(valid[:p], cnt[rp], torch.zeros_like(rp))
    return match_count, cnt, rp, rb


def _mm_plan_plain(limbs, valid, p: int):
    """Plain version of K13p, the reference's ``_mm_plan``: (match_count,
    total, offsets, build_pos_sorted, rp).  Build rows are stably sorted by
    rank with invalid rows last; ``offsets[r]`` is where rank r's run
    starts."""
    match_count, cnt, rp, rb = _mm_counts_plain(limbs, valid, p)
    build_pos_sorted = kernels.lexsort_perm([(~valid[p:]).to(torch.int32), rb])
    offsets = torch.cumsum(cnt, 0) - cnt
    return match_count, match_count.sum(), offsets, build_pos_sorted, rp


def _mm_plan_cuda(limbs, valid, p: int, with_bps: bool = True):
    """K13p: the combined radix sort, K10's pass in plan mode and the fill
    (see ``csrc/rank.cu``), from one C call with no host read; without
    ``with_bps`` (semi and anti joins) no build positions are written and
    only match_count is meaningful."""
    global MM_PLAN_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    if not 0 <= p <= n:
        raise ValueError(f"mm_plan: {p} probe rows of {n}")
    v8, cols, dts, ptrs, scratch = kernels.rank_pass_args("mm_plan", limbs, valid)
    rp = torch.empty(p, dtype=torch.int64, device=dev)
    num = torch.empty((), dtype=torch.int32, device=dev)
    offsets = torch.empty(n, dtype=torch.int64, device=dev)
    bps = torch.empty(n - p if with_bps else 0, dtype=torch.int64, device=dev)
    match_count = torch.empty(p, dtype=torch.int64, device=dev)
    nbv = torch.empty(2, dtype=torch.int64, device=dev)  # valid build rows, total
    native.check(kernels._rank_lib().qk_mm_plan(
        v8.data_ptr(), ptrs, dts, len(cols), n, p, int(with_bps), rp.data_ptr(), num.data_ptr(),
        offsets.data_ptr(), bps.data_ptr() if with_bps else None, match_count.data_ptr(),
        nbv.data_ptr(), scratch.data_ptr(), native.stream_ptr(dev)), "qk_mm_plan")
    kernels.SORT_LAUNCHES += 1
    kernels.RANK_LAUNCHES += 1
    MM_PLAN_LAUNCHES += 1
    return match_count, nbv[1], offsets, bps, rp


def _charge_plan(limbs, valid, p: int, with_bps: bool) -> None:
    """devprof's charges of one plan: K10's pass and K13p's fill (the probe
    ranks and validity read, the offsets, match counts and build positions
    written)."""
    kernels.charge_rank(limbs, valid)
    n = valid.shape[0]
    out = 8 * (p + (2 * n - p if with_bps else 0))
    devprof.on_dispatch(
        ("K13p", valid.device.type, n, p, with_bps, tuple(str(l.dtype) for l in limbs)),
        lambda: (0.0, float(9 * p + n + out), float(out)))


def _mm_plan_dispatch(limbs, valid, p: int, with_bps: bool):
    _charge_plan(limbs, valid, p, with_bps)
    if valid.device.type == "cpu":
        if with_bps:
            return _mm_plan_plain(limbs, valid, p)
        return _mm_counts_plain(limbs, valid, p)[0]
    if valid.device.type != "cuda":
        raise RuntimeError(f"mm_plan: unsupported device {valid.device}")
    out = _mm_plan_cuda(limbs, valid, p, with_bps)
    return out if with_bps else out[0]


def _mm_counts(limbs, valid, p: int):
    """Build rows matching each probe row (int64), for semi and anti joins:
    K13p with no build positions on CUDA tensors, the plain counts on CPU
    tensors."""
    return _mm_plan_dispatch(limbs, valid, p, False)


def _mm_plan(limbs, valid, p: int):
    """The reference's ``_mm_plan``: (match_count, total, offsets,
    build_pos_sorted, rp).  CUDA tensors launch K13p (one radix sort, the
    combined one; no sort of the build side); CPU tensors take
    ``_mm_plan_plain``."""
    return _mm_plan_dispatch(limbs, valid, p, True)


def mm_plan_for(limbs, valid, p: int, how: str, probe_valid: torch.Tensor):
    """Many-to-many planning: (match_count, total, offsets,
    build_pos_sorted, rp, unmatched).  A left join gives every live probe
    row without a match one synthetic output row; ``unmatched`` flags, per
    probe row, that its one output row is such a row (the reference's
    ``mm_unmatched`` / ``_is_unmatched_gather``, before the gather), and is
    None for other joins."""
    match_count, total, offsets, build_pos_sorted, rp = _mm_plan(limbs, valid, p)
    unmatched = None
    if how == "left":
        none = match_count == 0
        match_count = torch.where(probe_valid & none, torch.ones_like(match_count),
                                  match_count)
        unmatched = none & (match_count == 1)
        total = match_count.sum()
    return match_count, total, offsets, build_pos_sorted, rp, unmatched


def _mm_expand_plain(cum, offsets, build_pos_sorted, rp, total, out_padded: int,
                     unmatched=None):
    """Plain version of K13, the reference's ``_mm_expand`` arithmetic:
    output row j belongs to the probe row whose inclusive cumsum first
    passes j, and takes that probe row's (j - start)-th build row of its
    rank.  (probe_idx int32, build_idx int32, out_valid, unmatched[probe_idx]
    or None)."""
    p = cum.shape[0]
    b = build_pos_sorted.shape[0]
    j = torch.arange(out_padded, dtype=torch.int64, device=cum.device)
    probe_idx = torch.clamp(torch.searchsorted(cum, j, right=True), 0, p - 1)
    start = torch.where(probe_idx > 0, cum[torch.clamp(probe_idx - 1, min=0)],
                        torch.zeros_like(probe_idx))
    bpos = torch.clamp(offsets[rp[probe_idx]] + (j - start), 0, b - 1)
    build_idx = build_pos_sorted[bpos]
    out_valid = j < total
    unm = None if unmatched is None else unmatched[probe_idx]
    return probe_idx.to(torch.int32), build_idx.to(torch.int32), out_valid, unm


def _mm_expand_cuda(cum, offsets, build_pos_sorted, rp, total, out_padded: int,
                    unmatched=None):
    global EXPAND_LAUNCHES
    lib = _join_lib()
    dev = cum.device
    p, b = cum.shape[0], build_pos_sorted.shape[0]
    ins = [cum, offsets, build_pos_sorted, rp]
    for t in ins:
        if t.device != dev or t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError(f"mm_expand: inputs must be contiguous int64 on {dev}, got "
                            f"{t.dtype} on {t.device}")
    if rp.shape[0] != p or p < 1 or b < 1:
        raise ValueError(f"mm_expand: {p} probe rows, {rp.shape[0]} ranks, {b} build rows")
    total = total.to(device=dev, dtype=torch.int64).reshape(1)
    probe_idx = torch.empty(out_padded, dtype=torch.int32, device=dev)
    build_idx = torch.empty(out_padded, dtype=torch.int32, device=dev)
    out_valid = torch.empty(out_padded, dtype=torch.bool, device=dev)
    unm_in = unm_out = None
    if unmatched is not None:
        if unmatched.device != dev or unmatched.shape[0] != p:
            raise TypeError("mm_expand: unmatched flags must be one per probe row")
        unm_in = unmatched.contiguous().view(torch.uint8)
        unm_out = torch.empty(out_padded, dtype=torch.bool, device=dev)
    native.check(lib.qk_mm_expand(
        cum.data_ptr(), p, offsets.data_ptr(), build_pos_sorted.data_ptr(), b,
        rp.data_ptr(), total.data_ptr(), None if unm_in is None else unm_in.data_ptr(),
        out_padded, probe_idx.data_ptr(), build_idx.data_ptr(),
        out_valid.view(torch.uint8).data_ptr(),
        None if unm_out is None else unm_out.view(torch.uint8).data_ptr(),
        native.stream_ptr(dev)), "qk_mm_expand")
    EXPAND_LAUNCHES += 1
    return probe_idx, build_idx, out_valid, unm_out


def mm_expand(match_count, offsets, build_pos_sorted, rp, total, out_padded: int,
              unmatched=None):
    """K13: (probe_idx, build_idx, out_valid, unmatched per output row or
    None) for ``out_padded`` output rows.  The inclusive cumsum of
    ``match_count`` is a torch primitive; CUDA tensors then launch the
    kernel, CPU tensors take the plain version."""
    cum = torch.cumsum(match_count, 0)
    args = (cum, offsets, build_pos_sorted, rp, total, out_padded, unmatched)
    out = out_padded * (9 + (1 if unmatched is not None else 0))
    devprof.on_dispatch(
        ("K13", cum.device.type, cum.shape[0], offsets.shape[0], build_pos_sorted.shape[0], out_padded,
         unmatched is not None),
        lambda: (0.0, float(devprof.nbytes(cum, offsets, build_pos_sorted, rp, unmatched) + out),
                 float(out)))
    if cum.device.type == "cpu":
        return _mm_expand_plain(*args)
    if cum.device.type != "cuda":
        raise RuntimeError(f"mm_expand: unsupported device {cum.device}")
    return _mm_expand_cuda(*args)


def hash_join_general(probe: DeviceBatch, build: DeviceBatch, probe_keys: Sequence[str],
                      build_keys: Sequence[str], how: str = "inner",
                      build_payload: Sequence[str] = ()) -> DeviceBatch:
    """Many-to-many (and every left) join.  Semi and anti joins stay
    probe-aligned with no host sync; inner and left joins read the output
    total once per probe batch to pick the output bucket.  A left join's
    unmatched rows carry null build payloads (``with_nulls``)."""
    require_join_how(how)
    p = probe.padded_len
    limbs, valid = _concat_limbs(probe, build, probe_keys, build_keys)
    if how in ("semi", "anti"):
        matched = _mm_counts(limbs, valid, p) > 0
        return kernels.apply_mask(probe, matched if how == "semi" else probe.valid & ~matched)
    match_count, total, offsets, build_pos_sorted, rp, unmatched = mm_plan_for(
        limbs, valid, p, how, probe.valid)
    ntotal = int(total)
    probe_idx, build_idx, out_valid, unm = mm_expand(
        match_count, offsets, build_pos_sorted, rp, total, config.bucket_size(ntotal),
        unmatched)
    cols = gather_columns(probe.columns, probe_idx)
    for name, taken in gather_columns(
            {n: build.columns[n] for n in build_payload}, build_idx).items():
        cols[name] = taken if unm is None else with_nulls(taken, unm)
    return DeviceBatch(cols, out_valid, ntotal, None)


def _distinct_from_table(tbl: torch.Tensor, ok: torch.Tensor):
    """(# placed keys, # insertable rows) from a converged hash table."""
    return (tbl != hashtable.EMPTY).sum(), ok.sum()


def _sorted_has_dup(sorted_limbs, n_valid):
    """Any adjacent equal key pair within the valid prefix of a build sort."""
    n = sorted_limbs[0].shape[0]
    eq = torch.ones(n, dtype=torch.bool, device=sorted_limbs[0].device)
    for limb in sorted_limbs:
        eq = eq & (limb == torch.roll(limb, 1))
    iota = torch.arange(n, device=eq.device)
    return (eq & (iota >= 1) & (iota < n_valid)).any(), n_valid


def build_keys_unique(build: DeviceBatch, build_keys: Sequence[str]) -> bool:
    """Host-synced check whether the build side is PK-unique (decides the
    fast path); called once per finalized build table.  Answered from the
    same cached structure the probe will use: placed slots equal insertable
    rows in the hash table, or no adjacent equal pair in the build sort.
    All null keys collapse into one key for this check, so uniqueness also
    requires at most one null/NaN-key row."""
    if strategy.choice("join_build") == "hashtable":
        table = _table_of(build, build_keys)
        if table is not None:
            nvalid = build.count_valid()
            raw = key_limbs(build, build_keys)
            ok = _nonnull_valid(build, build_keys) & ~hashtable.nan_rows(raw)
            distinct, n_ok = _distinct_from_table(table.tbl, ok)
            distinct, n_ok = int(distinct), int(n_ok)
            return distinct == n_ok and nvalid - n_ok <= 1
    return _sorted_build_unique(build, build_keys)


def _sorted_build_unique(build: DeviceBatch, build_keys: Sequence[str]) -> bool:
    """``build_keys_unique``'s sorted answer, which the mesh's rank-based
    joins call directly (they build no hash table): no adjacent equal pair
    in the build's key sort, and at most one null/NaN-key row."""
    sorted_limbs, _perm, n_ok_dev = _build_sorted_cached(build, build_keys)
    dup, n_ok = _sorted_has_dup(sorted_limbs, n_ok_dev)
    return (not bool(dup)) and build.count_valid() - int(n_ok) <= 1
