"""The plain versions of K10 (``kernels.dense_rank_plain``) and K13p
(``join._mm_plan_plain``, ``join._mm_counts_plain``, and ``join.mm_plan_for``
around them) against the reference (quokka_tpu, JAX x64 on the CPU):
``_dense_rank_impl``, ``_mm_plan`` and ``mm_plan_for``, on identical inputs
made from a numpy seed.  The port runs the plain versions here (the tensors
lie on the CPU); tests/test_torch_cuda.py holds the kernels against them on
a card.

Every output is compared index for index, exactly: the ranks (invalid rows
included) and their count; the match counts, the total, the offsets of all
n ranks (those at or past num hold the valid build rows), the build rows in
(rank, row) order followed by the invalid build rows in row order, and the
probe ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quokka_tpu.ops import join as ref_join
from quokka_tpu.ops import kernels as ref_kernels
from quokka_tpu_torch.ops import join, kernels

from torch_port_util import fresh_aot  # noqa: F401

CASES = ["spread", "invalid_build_tail", "all_invalid", "no_valid_build_row",
         "one_key_every_build_row", "two_limbs", "float64_neg_zero_nan", "no_probe_match"]


def _case(case):
    """(limbs, valid, probe rows) as numpy: p probe rows then b build rows."""
    r = np.random.default_rng(len(case) * 7 + 3)
    p, b = 700, 2300
    n = p + b
    keys = r.integers(0, 300, n).astype(np.int64)
    valid = r.random(n) < 0.9
    limbs = [keys]
    if case == "invalid_build_tail":
        valid[p:] = r.random(b) < 0.5  # many invalid build rows, in row order
    elif case == "all_invalid":
        valid[:] = False
    elif case == "no_valid_build_row":
        valid[p:] = False
    elif case == "one_key_every_build_row":
        keys[p:] = 42
        keys[: p // 2] = 42
    elif case == "two_limbs":
        limbs = [keys % 40, (keys // 40).astype(np.int32)]
    elif case == "float64_neg_zero_nan":
        f = r.integers(-3, 3, n).astype(np.float64)
        f[r.random(n) < 0.2] = -0.0
        f[r.random(n) < 0.05] = np.nan
        limbs = [f]
    elif case == "no_probe_match":
        keys[:p] += 10_000
    return limbs, valid, p


def _both(limbs, valid):
    return ([jnp.asarray(x) for x in limbs], jnp.asarray(valid),
            [torch.from_numpy(x) for x in limbs], torch.from_numpy(valid))


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).reshape(-1), np.asarray(want).reshape(-1),
                                  err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_dense_rank_plain_matches_reference(case, fresh_aot):
    limbs, valid, _ = _case(case)
    rl, rv, tl, tv = _both(limbs, valid)
    r_ranks, r_num = ref_kernels.dense_rank(rl, rv)
    ranks, num = kernels.dense_rank_plain(tl, tv)
    assert ranks.dtype == torch.int64 and num.dtype == torch.int32
    assert int(num) == int(r_num)
    _eq(ranks.numpy(), r_ranks, "ranks")


@pytest.mark.parametrize("case", CASES)
def test_mm_plan_plain_matches_reference(case, fresh_aot):
    limbs, valid, p = _case(case)
    rl, rv, tl, tv = _both(limbs, valid)
    want = ref_join._mm_plan(tuple(rl), rv, p)
    got = join._mm_plan_plain(tl, tv, p)
    for name, g, w in zip(("match_count", "total", "offsets", "build_pos_sorted", "rp"),
                          got, want):
        _eq(g.numpy(), w, name)
    n_build_valid = int(valid[p:].sum())
    off, num = got[2].numpy(), int(kernels.dense_rank_plain(tl, tv)[1])
    assert (off[num:] == n_build_valid).all()
    # the tail: the invalid build rows, in row order
    np.testing.assert_array_equal(got[3].numpy()[n_build_valid:], np.flatnonzero(~valid[p:]))
    # the same entry points as the kernel's callers
    _eq(join._mm_plan(tl, tv, p)[3].numpy(), want[3], "dispatch")
    _eq(join._mm_counts(tl, tv, p).numpy(), want[0], "counts")
    _eq(join._mm_counts_plain(tl, tv, p)[0].numpy(), want[0], "counts plain")


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("case", ["spread", "invalid_build_tail", "one_key_every_build_row",
                                  "two_limbs"])
def test_mm_plan_for_matches_reference(case, how, fresh_aot):
    limbs, valid, p = _case(case)
    rl, rv, tl, tv = _both(limbs, valid)
    pv = np.random.default_rng(5).random(p) < 0.95
    want = ref_join.mm_plan_for(rl, rv, p, how, probe_valid=jnp.asarray(pv))
    got = join.mm_plan_for(tl, tv, p, how, torch.from_numpy(pv))
    for name, g, w in zip(("match_count", "total", "offsets", "build_pos_sorted", "rp"),
                          got, want):
        _eq(g.numpy(), w, name)
    assert (got[5] is None) == (how != "left")
