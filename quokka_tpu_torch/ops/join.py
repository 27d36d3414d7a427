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
  (``pk_probe_sorted``; ``_pk_probe_sorted_plain`` beside it).

``build_keys_unique`` answers, once per finalized build, whether the PK path
applies, from the same cached structure the probe will use.  The
many-to-many and left joins (``hash_join_general``) are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from quokka_tpu_torch.ops import hashtable, kernels, native, strategy
from quokka_tpu_torch.ops.batch import DeviceBatch, gather_columns, key_limbs, null_mask

# launches of the K12 CUDA kernel
SORTED_PROBE_LAUNCHES = 0

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
        lib.qk_sorted_probe.argtypes = [PP, PP, PI, I, P, P, L, P, L, P, P, P]
        lib.qk_sorted_probe.restype = I
        lib.qk_bound = True
    return lib


def _pk_probe_sorted_cuda(sorted_limbs, perm, n_valid, probe_limbs, probe_ok):
    global SORTED_PROBE_LAUNCHES
    lib = _join_lib()
    dev = probe_ok.device
    p = probe_ok.shape[0]
    nb = perm.shape[0]
    if not 1 <= len(sorted_limbs) <= 16:
        raise ValueError("pk_probe_sorted: 1 to 16 key limbs")
    probe_limbs = [l.contiguous() for l in probe_limbs]
    for s, l in zip(sorted_limbs, probe_limbs):
        if (s.dtype not in _LIMB_DT or l.dtype != s.dtype or s.device != dev
                or l.device != dev or l.shape[0] != p or s.shape[0] != nb):
            raise TypeError(f"pk_probe_sorted: unsupported limbs {s.dtype}/{l.dtype} "
                            f"on {s.device}/{l.device}")
    n_valid = n_valid.to(device=dev, dtype=torch.int64).reshape(1)
    build_idx = torch.empty(p, dtype=torch.int32, device=dev)
    matched = torch.empty(p, dtype=torch.bool, device=dev)

    def arg(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t

    native.check(lib.qk_sorted_probe(
        native.ptr_array([arg(s).data_ptr() for s in sorted_limbs]),
        native.ptr_array([arg(l).data_ptr() for l in probe_limbs]),
        native.int_array([_LIMB_DT[s.dtype] for s in sorted_limbs]), len(sorted_limbs),
        perm.contiguous().data_ptr(), n_valid.data_ptr(), nb,
        probe_ok.contiguous().view(torch.uint8).data_ptr(), p, build_idx.data_ptr(),
        matched.view(torch.uint8).data_ptr(), native.stream_ptr(dev)), "qk_sorted_probe")
    SORTED_PROBE_LAUNCHES += 1
    return build_idx, matched


def pk_probe_sorted(sorted_limbs, perm, n_valid, probe_limbs, probe_ok):
    """K12: probe a presorted build.  Probe limbs must already carry the
    sorted limbs' dtypes.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if probe_ok.device.type == "cpu":
        return _pk_probe_sorted_plain(sorted_limbs, perm, n_valid, probe_limbs, probe_ok)
    if probe_ok.device.type != "cuda":
        raise RuntimeError(f"pk_probe_sorted: unsupported device {probe_ok.device}")
    return _pk_probe_sorted_cuda(sorted_limbs, perm, n_valid, probe_limbs, probe_ok)


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


def require_pk_how(how: str) -> None:
    if how not in ("inner", "semi", "anti"):
        raise NotImplementedError(
            f"join how={how!r} needs hash_join_general (many-to-many and left "
            "joins), which is not in quokka_tpu_torch yet: ROADMAP Queue 1 item 3")


def hash_join_pk(probe: DeviceBatch, build: DeviceBatch, probe_keys: Sequence[str],
                 build_keys: Sequence[str], how: str = "inner",
                 build_payload: Sequence[str] = ()) -> DeviceBatch:
    """Join where build keys are unique.  Probe-aligned; the probe path has
    no host sync.  The cached build pays one scalar read per build batch
    (the hash-table convergence check); a diverged build is remembered on
    the batch and every probe takes the sorted path."""
    require_pk_how(how)
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


def hash_join_general(probe, build, probe_keys, build_keys, how="inner",
                      build_payload=()):
    """Many-to-many and left joins: not ported yet."""
    raise NotImplementedError(
        "hash_join_general (many-to-many and left joins) is not in quokka_tpu_torch "
        "yet: ROADMAP Queue 1 item 3")


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
    nvalid = build.count_valid()
    if strategy.choice("join_build") == "hashtable":
        table = _table_of(build, build_keys)
        if table is not None:
            raw = key_limbs(build, build_keys)
            ok = _nonnull_valid(build, build_keys) & ~hashtable.nan_rows(raw)
            distinct, n_ok = _distinct_from_table(table.tbl, ok)
            distinct, n_ok = int(distinct), int(n_ok)
            return distinct == n_ok and nvalid - n_ok <= 1
    sorted_limbs, _perm, n_ok_dev = _build_sorted_cached(build, build_keys)
    dup, n_ok = _sorted_has_dup(sorted_limbs, n_ok_dev)
    return (not bool(dup)) and nvalid - int(n_ok) <= 1
