"""The radix sort under K10 and K13p (``csrc/sort.cuh``), modelled in torch
by ``kernels.pack_keys_plain`` / ``kernels.packed_sort_perm_plain`` (each
limb's range over the valid rows, the packed key words, the valid-first
compaction, one stable sort an 8-bit digit, least significant first),
against ``kernels.sort_perm_plain`` and the reference (quokka_tpu, JAX x64
on the CPU), on identical inputs made from a numpy seed.

All comparisons are exact, index for index: the model's permutation equals
``sort_perm_plain``'s (its valid prefix is ``_sort_perm``'s and the
reference's ``lax.sort``'s, the invalid rows follow in row order); the
dense ranks and many-to-many plans built on it the way K10's and K13p's
pass builds them (run starts where the sorted key words differ or a float
limb is NaN) equal the reference's ``_dense_rank_impl`` and ``_mm_plan``.
tests/test_torch_cuda.py holds the card's sort to the same plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from jax import lax

from quokka_tpu.ops import join as ref_join
from quokka_tpu.ops import kernels as ref_kernels
from quokka_tpu_torch.ops import join, kernels

from torch_port_util import fresh_aot  # noqa: F401

I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def _case(case):
    """(limbs, valid, probe rows) as numpy."""
    r = np.random.default_rng(sum(map(ord, case)))
    n = {"n_1": 1, "n_4097": 4097}.get(case, 3000)
    valid = r.random(n) < 0.85
    i64 = lambda lo, hi: r.integers(lo, hi, n, dtype=np.int64, endpoint=True)
    if case == "int64_full_range":
        x = i64(I64_MIN, I64_MAX)
        x[:4] = [I64_MIN, I64_MAX, I64_MIN, I64_MAX]
        valid[:4] = True
        x[4::7] = x[5::7][: len(x[4::7])]  # repeated keys
        limbs = [x]
    elif case == "two_int64_over_one_word":
        limbs = [i64(-(2**40), 2**40), i64(-(2**33), 2**33)]
        limbs[0][::3] = 17
    elif case == "two_int32_hash_limbs":
        h = r.integers(-(2**31), 2**31, n // 4 + 1).astype(np.int32)
        g = r.integers(-(2**31), 2**31, n // 4 + 1).astype(np.int32)
        pick = r.integers(0, n // 4 + 1, n)
        limbs = [h[pick], g[pick]]
    elif case == "bool_limbs":
        limbs = [r.random(n) < 0.5, r.random(n) < 0.2]
    elif case == "float64_neg_zero_nan":
        f = r.integers(-3, 3, n).astype(np.float64)
        u = r.random(n)
        f[u < 0.1] = np.nan
        f[(u >= 0.1) & (u < 0.3)] = -0.0
        f[(u >= 0.3) & (u < 0.35)] = np.inf
        limbs = [f, f.astype(np.float32)]
    elif case == "all_invalid":
        valid[:] = False
        limbs = [i64(0, 50)]
    elif case == "no_valid_build_row":
        valid[n // 3:] = False
        limbs = [i64(0, 50)]
    else:  # n_1, n_4097
        limbs = [i64(-5, 300), i64(0, 2)]
    return limbs, valid, n // 3


CASES = ["int64_full_range", "two_int64_over_one_word", "two_int32_hash_limbs", "bool_limbs",
         "float64_neg_zero_nan", "all_invalid", "no_valid_build_row", "n_1", "n_4097"]


def _torch(limbs, valid):
    return [torch.from_numpy(np.asarray(l)) for l in limbs], torch.from_numpy(valid)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).reshape(-1), np.asarray(want).reshape(-1),
                                  err_msg=what)


def _sorted_words(limbs, valid, perm):
    """The packed key words at each valid sorted position, as the digit
    passes leave them (int64 bits, [words, n_valid])."""
    ids, words, _ = kernels.pack_keys_plain(limbs, valid)
    nv = ids.shape[0]
    at = torch.empty(valid.shape[0], dtype=torch.long)
    at[ids] = torch.arange(nv)
    if not words:
        return torch.zeros((0, nv), dtype=torch.int64)
    return torch.stack(words)[:, at[perm[:nv]]]


def _rank_pass(limbs, valid, perm):
    """K10's pass on the sorted keys: (sorted-order run starts, ranks in row
    order, num)."""
    n, nv = valid.shape[0], int(valid.sum())
    words = _sorted_words(limbs, valid, perm)
    changed = torch.zeros(nv, dtype=torch.bool)
    if nv:
        changed[0] = True
        changed[1:] |= (words[:, 1:] != words[:, :-1]).any(0)
        for l in limbs:
            if l.is_floating_point():
                changed |= torch.isnan(l[perm[:nv]])
    starts = torch.cat([changed, torch.zeros(n - nv, dtype=torch.bool)])
    ranks_s = torch.clamp(torch.cumsum(starts, 0) - 1, min=0)
    ranks = torch.empty(n, dtype=torch.int64)
    ranks[perm] = ranks_s
    return starts, ranks, starts.sum(dtype=torch.int32)


def _plan_pass(limbs, valid, perm, p):
    """K13p's pass and fill on the sorted keys: (match_count, total,
    offsets, build_pos_sorted, rp), the build positions read off the sorted
    order (valid build rows by position, then the invalid tail)."""
    n, nv = valid.shape[0], int(valid.sum())
    starts, ranks, num = _rank_pass(limbs, valid, perm)
    is_build = (perm >= p) & (torch.arange(n) < nv)
    before = torch.cumsum(is_build, 0) - is_build.long()  # valid build rows before
    nb = int(is_build.sum())
    offsets = torch.full((n,), nb, dtype=torch.int64)
    offsets[: int(num)] = before[starts]
    tail = perm[nv:]
    bps = torch.cat([perm[is_build], tail[tail >= p]]) - p
    rp = ranks[:p]
    nxt = torch.where(rp + 1 < int(num), offsets[torch.clamp(rp + 1, max=n - 1)],
                      torch.full_like(rp, nb))
    match_count = torch.where(valid[:p], nxt - offsets[rp], torch.zeros_like(rp))
    return match_count, match_count.sum(), offsets, bps, rp


@pytest.mark.parametrize("case", CASES)
def test_packed_sort_matches_plain_and_reference(case, fresh_aot):
    limbs, valid, _ = _case(case)
    tl, tv = _torch(limbs, valid)
    got = kernels.packed_sort_perm_plain(tl, tv)
    _eq(got, kernels.sort_perm_plain(tl, tv), "sort_perm_plain")
    nv = int(valid.sum())
    _eq(got[:nv], kernels._sort_perm(tl, tv)[:nv], "_sort_perm's valid prefix")
    _eq(got[nv:], np.flatnonzero(~valid), "the invalid rows in row order")
    iota = jnp.arange(valid.shape[0], dtype=jnp.int32)
    ref = lax.sort([jnp.asarray((~valid).astype(np.int32)), *map(jnp.asarray, limbs), iota],
                   num_keys=1 + len(limbs))[-1]
    _eq(got[:nv], np.asarray(ref)[:nv], "the reference's lax.sort, valid prefix")


@pytest.mark.parametrize("case", CASES)
def test_packed_key_widths(case):
    """Each limb takes the bits of its range over the valid rows: the words
    are as many as those bits need, never more than the dtypes' widths."""
    limbs, valid, _ = _case(case)
    tl, tv = _torch(limbs, valid)
    ids, words, bits = kernels.pack_keys_plain(tl, tv)
    _eq(ids, np.flatnonzero(valid), "valid rows in row order")
    want = 0
    for l in tl:
        o = kernels._packed_order_key(l)[tv]
        want += (int(o.max()) - int(o.min())).bit_length() if o.numel() else 0
    assert bits == want and len(words) == (bits + 63) // 64
    widths = {torch.int64: 64, torch.float64: 64, torch.int32: 32, torch.float32: 32,
              torch.bool: 1}
    assert len(words) <= (sum(widths[l.dtype] for l in tl) + 63) // 64
    if case == "int64_full_range":
        assert bits == 64  # r = 2^64 itself needs 65 bits: the width is its max - min's
    if case == "two_int64_over_one_word":
        assert len(words) == 2
    if case == "two_int32_hash_limbs":
        assert len(words) == 1


@pytest.mark.parametrize("case", CASES)
def test_ranks_on_packed_sort_match_reference(case, fresh_aot):
    limbs, valid, _ = _case(case)
    tl, tv = _torch(limbs, valid)
    _, ranks, num = _rank_pass(tl, tv, kernels.packed_sort_perm_plain(tl, tv))
    r_ranks, r_num = ref_kernels.dense_rank([jnp.asarray(x) for x in limbs], jnp.asarray(valid))
    assert int(num) == int(r_num)
    _eq(ranks, r_ranks, "ranks")


@pytest.mark.parametrize("case", CASES)
def test_plan_on_packed_sort_matches_reference(case, fresh_aot):
    limbs, valid, p = _case(case)
    tl, tv = _torch(limbs, valid)
    got = _plan_pass(tl, tv, kernels.packed_sort_perm_plain(tl, tv), p)
    want = ref_join._mm_plan(tuple(jnp.asarray(x) for x in limbs), jnp.asarray(valid), p)
    for name, g, w in zip(("match_count", "total", "offsets", "build_pos_sorted", "rp"),
                          got, want):
        _eq(g, w, name)
    # and the port's plain plan, which the card's K13p is held to
    for name, g, w in zip(("match_count", "total", "offsets", "build_pos_sorted", "rp"),
                          got, join._mm_plan_plain(tl, tv, p)):
        _eq(g, w, f"plain {name}")


def test_sort_perm_on_cpu_is_the_plain_version():
    limbs, valid, _ = _case("float64_neg_zero_nan")
    tl, tv = _torch(limbs, valid)
    before = kernels.SORT_LAUNCHES
    _eq(kernels.sort_perm(tl, tv), kernels.sort_perm_plain(tl, tv), "sort_perm")
    assert kernels.SORT_LAUNCHES == before


_DTYPES = [np.int64, np.int32, np.float64, np.float32, np.bool_]


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1),
       n=st.sampled_from([1, 2, 31, 256, 257, 1000]),
       dtypes=st.lists(st.sampled_from(range(len(_DTYPES))), min_size=0, max_size=4),
       spans=st.lists(st.sampled_from([0, 1, 3, 255, 256, 2**20, 2**40, None]), min_size=4,
                      max_size=4),
       density=st.sampled_from([0.0, 0.5, 0.97, 1.0]))
def test_packed_sort_on_drawn_limbs(seed, n, dtypes, spans, density):
    """Drawn limbs (dtypes, ranges up to the full int64 one, specials for
    floats): the model's permutation equals sort_perm_plain's and ranks and
    plans built on it equal the port's plain versions, which the reference
    tests above hold to the reference."""
    r = np.random.default_rng(seed)
    limbs = []
    for dt, span in zip((_DTYPES[i] for i in dtypes), spans):
        if dt == np.bool_:
            limbs.append(r.random(n) < 0.5)
        elif dt in (np.float64, np.float32):
            x = r.integers(-3, 4, n).astype(dt) * (1.0 if span is None else max(span, 1))
            u = r.random(n)
            x[u < 0.1] = np.nan
            x[(u >= 0.1) & (u < 0.2)] = -0.0
            limbs.append(x)
        else:
            info = np.iinfo(dt)
            lo = int(info.min) if span is None else int(r.integers(-1000, 1000))
            hi = int(info.max) if span is None else min(lo + span, int(info.max))
            limbs.append(r.integers(lo, hi, n, dtype=dt, endpoint=True))
    valid = r.random(n) < density
    tl, tv = _torch(limbs, valid)
    perm = kernels.packed_sort_perm_plain(tl, tv)
    _eq(perm, kernels.sort_perm_plain(tl, tv), "sort_perm_plain")
    _, ranks, num = _rank_pass(tl, tv, perm)
    want, want_num = kernels.dense_rank_plain(tl, tv)
    _eq(ranks, want, "ranks")
    assert int(num) == int(want_num)
    p = n // 2
    for name, g, w in zip(("match_count", "total", "offsets", "build_pos_sorted", "rp"),
                          _plan_pass(tl, tv, perm, p), join._mm_plan_plain(tl, tv, p)):
        _eq(g, w, name)
