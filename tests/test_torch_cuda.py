"""The port's hand-written kernels (K1-K6, K8, K10, K11-K14, K13p, K16-K24, K26) against
their plain torch versions, on a card.  Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False.

This file imports neither JAX nor pyarrow/pandas, so it also runs on a
machine with only torch and a card (tests/conftest.py imports JAX, hence
``--noconftest`` there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: masks, ids, counts and integer sums exact; float sums rtol
1e-9 (atomics and block partials sum in another order); K3 compares after
a sort on the keys.  The time-series kernels (indices, flags, min / max)
compare bit for bit.  K21's scores agree within 1e-5 at d = 768 (float32
dot products summed in another order; 1e-6 at d <= 7, exact at d = 1),
and its row handles are equal but where a score lies within twice that of
the query's k-th (all rows invalid: bit for bit); K22's float64 sums agree
within rtol 1e-9, and two runs give the same bits.  K17's plan
and K26's routing are exact index for index; K6's counts, integer sums and
smallest rows are exact and its float64 sums within rtol 1e-9.  K23's
decoded leaves equal the plain version's and the shipped input bit for bit.
K24's exchanged columns and validity, and K14's build rows and matches,
are exact.  K10's ranks and K13p's plan equal the plain versions bit for
bit, and the radix sort under them equals ``kernels.sort_perm_plain``
index for index.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quokka_tpu_torch import config, sqlparse
from quokka_tpu_torch.executors import ts_execs
from quokka_tpu_torch.ops import asof, bridge, fuse, hashtable, join, kernels, linalg, stagefuse
from quokka_tpu_torch.ops import pack, vector
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, StrCol, StringDict, VecCol
from quokka_tpu_torch.ops.expr_compile import plan_aggregation

pytestmark = pytest.mark.cuda

PREDICATES = [
    "d <= date '1998-12-01' - interval '90' day",
    "g between 0.05 and 7.5 and i < 24",
    "not (f > 0.5) or i is null",
    "case when i > 0 then g else f end > 1",
    "i in (1, 2, 3, 40) and not b",
    "s = 'ab' and d >= date '1995-01-01'",
    "f = 0 or g / i > 0.1",
    "i * 2 + 1 >= 7 and g * (1 - f) < 3",
]
AGGS = ("sum(g) as sg, count(*) as n, count(g) as ng, avg(f) as af, "
        "sum(g * (1 - f) * (1 + g)) as sx, sum(i) as si")
OPS = ("sum", "count", "min", "max", "mean", "first")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("not torch.cuda.is_available()")
    return torch.device("cuda")


def host_table(n: int, seed: int) -> bridge.HostTable:
    """Strings (with nulls), ints (with nulls), floats (NaN, -0.0), dates
    (with NaT) and bools, as numpy."""
    r = np.random.default_rng(seed)
    s = np.array(["ab", "cd", "ef", "gh"], dtype=object)[r.integers(0, 4, n)]
    s[r.random(n) < 0.08] = None
    f = r.normal(size=n).round(3)
    f[r.random(n) < 0.05] = -0.0
    f[r.random(n) < 0.05] = np.nan
    g = r.uniform(0, 10, n).round(2)
    g[r.random(n) < 0.08] = np.nan
    d = r.integers(9000, 10500, n).astype("datetime64[D]")
    d[r.random(n) < 0.08] = np.datetime64("NaT")
    return bridge.HostTable(
        {"s": s, "t": np.array(["x", "y"], dtype=object)[r.integers(0, 2, n)],
         "i": r.integers(-50, 50, n), "f": f, "g": g, "d": d, "b": r.random(n) < 0.5},
        validity={"i": r.random(n) >= 0.08})


def test_k1_kernel_matches_plain(cuda_device):
    b = bridge.host_to_device(host_table(5000, seed=2), cuda_device)
    for sql in PREDICATES:
        e, kern, inputs = fuse.FusedPredicate(sqlparse.parse_expression(sql)).prepare(b)
        m_k, c_k = fuse.predicate_launch(kern, list(inputs.values()), b.valid)
        m_p, c_p = fuse.predicate_plain(e, inputs, b.valid)
        assert torch.equal(m_k, m_p) and int(c_k) == int(c_p), sql


def test_k2_kernel_matches_plain(cuda_device):
    b = bridge.host_to_device(host_table(5000, seed=4), cuda_device)
    plan = plan_aggregation(sqlparse.parse_select_list(AGGS))
    call = fuse.FusedPartialAgg(["s", "t"], plan).prepare_small(b)
    (sk, rk), (sp, rp) = call.launch(), call.plain()
    assert torch.equal(rk, rp)
    for a, c in zip(sk, sp):
        if a.is_floating_point():
            assert torch.allclose(a, c, rtol=1e-9, atol=1e-12)
        else:
            assert torch.equal(a, c)


# K2's bucket core reads plain columns in place (float64, float32, int64,
# int32; nulls add 0); only the expression inputs go through the pre-pass
K2_AGGS = ("sum(f) as sf, sum(x32) as sx, sum(i) as si, sum(j32) as sj, count(*) as n, "
           "avg(g) as ag, sum(g * (1 - f)) as se")
K2_COLUMNS = "sum(f) as sf, sum(x32) as sx, sum(i) as si, sum(j32) as sj, count(*) as n"
K2_CASES = ["17 buckets", "129 buckets", "columns 17 buckets", "columns 129 buckets",
            "all invalid"]


def _k2_batch(dev, n: int, seed: int, invalid: bool = False):
    """host_table's columns, a key "q" of 3 values (with "t": Q1's 16
    groups), a key "k" of 100 values and nulls (128 groups), a float32
    column "x32" with NaN and an int32 column "j32" with its null sentinel."""
    from quokka_tpu_torch.ops.batch import NULL_I32, DeviceBatch, NumCol

    r = np.random.default_rng(seed)
    ht = host_table(n, seed)
    k = np.array([f"sym{j:03d}" for j in range(100)], dtype=object)[r.integers(0, 100, n)]
    k[r.random(n) < 0.05] = None
    q = np.array(["A", "N", "R"], dtype=object)[r.integers(0, 3, n)]
    ht = bridge.HostTable({**ht.columns, "k": k, "q": q}, validity=ht.validity)
    b = bridge.host_to_device(ht, dev)
    x32 = r.normal(size=n).astype(np.float32)
    x32[r.random(n) < 0.05] = np.nan
    j32 = r.integers(-1000, 1000, n).astype(np.int32)
    j32[r.random(n) < 0.05] = NULL_I32
    pad = b.padded_len
    cols = {**b.columns,
            "x32": NumCol(bridge.pad_tail(torch.from_numpy(x32).to(dev), pad), "f"),
            "j32": NumCol(bridge.pad_tail(torch.from_numpy(j32).to(dev), pad), "i")}
    return DeviceBatch(cols, torch.zeros_like(b.valid) if invalid else b.valid)


def _k2_agree(got, want):
    (sk, rk), (sp, rp) = got, want
    assert rk.dtype == rp.dtype and torch.equal(rk, rp)
    assert len(sk) == len(sp)
    for a, c in zip(sk, sp):
        assert a.dtype == c.dtype and a.shape == c.shape
        if a.is_floating_point():
            assert torch.allclose(a, c, rtol=1e-9, atol=1e-12, equal_nan=True)
        else:
            assert torch.equal(a, c)


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_bucket_core_matches_plain(cuda_device, case):
    """K2 on the bucket core against its plain version at 17 and 129 buckets
    (Q1's and the tick paths' shapes), with float32 and int32 plain
    columns: a plan of plain columns and count(*) launches no pre-pass;
    every row invalid; and the same bits in a second launch."""
    wide = "129" in case or case == "all invalid"
    b = _k2_batch(cuda_device, 70_001, seed=len(case), invalid=case == "all invalid")
    plan = plan_aggregation(sqlparse.parse_select_list(
        K2_COLUMNS if case.startswith("columns") else K2_AGGS))
    call = fuse.FusedPartialAgg(["k"] if wide else ["q", "t"], plan).prepare_small(b)
    assert call.n_groups + 1 == (129 if wide else 17)
    assert (call.kern.pre is None) == case.startswith("columns")
    launches, pre = fuse.SMALL_AGG_LAUNCHES, fuse.SMALL_PRE_LAUNCHES
    got = call.launch()
    assert fuse.SMALL_AGG_LAUNCHES == launches + 1
    assert fuse.SMALL_PRE_LAUNCHES == pre + (call.kern.pre is not None)
    _k2_agree(got, call.plain())
    again = call.launch()
    for a, c in zip(got[0] + [got[1]], again[0] + [again[1]]):
        assert torch.equal(_bits(a), _bits(c))
    if case == "all invalid":
        assert bool((got[1] == b.padded_len).all())


def test_k2_strided_inputs_match_plain(cuda_device):
    """Plain columns, a key's codes and the mask taken from wider tensors:
    their contiguous copies live through the launch (two freed copies of
    one size would share a block)."""
    b = _k2_batch(cuda_device, 50_000, seed=7)
    plan = plan_aggregation(sqlparse.parse_select_list(K2_COLUMNS))
    call = fuse.FusedPartialAgg(["s", "t"], plan).prepare_small(b)

    call = dataclasses.replace(call, inputs={k: _strided(t) for k, t in call.inputs.items()},
                               codes=[_strided(c) for c in call.codes],
                               valid=_strided(call.valid))
    assert not any(t.is_contiguous() for t in (*call.inputs.values(), *call.codes, call.valid))
    _k2_agree(call.launch(), call.plain())


@pytest.mark.parametrize("n", [1 << 10, 1 << 16])
def test_k3_kernel_matches_plain(cuda_device, n):
    r = np.random.default_rng(n)
    key = torch.from_numpy(r.integers(-(2**40), 2**40, 500)[r.integers(0, 500, n)])
    val = r.normal(size=n)
    val[r.random(n) < 0.03] = np.nan
    lb = [key.to(cuda_device)]
    ar = [torch.from_numpy(val).to(cuda_device) for _ in OPS]
    va = torch.from_numpy(r.random(n) < 0.85).to(cuda_device)
    ko, kc, kr, kn = hashtable.hash_groupby(lb, ar, OPS, va)
    po, pc, pr, pn = hashtable.hash_groupby_plain(lb, ar, OPS, va)
    assert int(kn) == int(pn)
    g = int(kn)
    ki = torch.argsort(lb[0][kr[:g].long()])
    pi = torch.argsort(lb[0][pr[:g].long()])
    assert torch.equal(lb[0][kr[:g].long()][ki], lb[0][pr[:g].long()][pi])
    assert torch.equal(kc[:g][ki], pc[:g][pi])
    for a, c in zip(ko, po):
        assert torch.allclose(a[:g][ki], c[:g][pi], rtol=1e-9, atol=1e-12, equal_nan=True)


K3_CASES = ["float64_nan_zero", "int32_codes", "three_mixed", "all_invalid", "one_row",
            "one_group", "distinct_2e16", "low_bits"]


def _k3_case(case, dev):
    """Key columns, aggregate inputs, ops and validity of a K3 case: float64
    keys with NaN, -0.0 and +0.0; int32 dictionary codes; three key columns
    of mixed types; every row invalid; one row; one group; 2^16 distinct
    keys; int64 keys that agree in their low 32 bits."""
    r = np.random.default_rng(len(case))
    n = {"one_row": 1, "distinct_2e16": 1 << 16}.get(case, 5000)
    valid = r.random(n) < 0.85
    if case == "float64_nan_zero":
        keys = [r.choice([0.0, -0.0, 1.5, np.nan, -2.25], n)]
    elif case == "int32_codes":
        keys = [r.integers(0, 25, n).astype(np.int32)]
    elif case == "three_mixed":
        keys = [r.integers(0, 3, n).astype(np.int32),
                r.choice([0.0, -0.0, 0.5, np.nan], n).astype(np.float32),
                r.integers(-3, 3, n) << 40]
    elif case == "all_invalid":
        keys = [r.integers(0, 9, n)]
        valid[:] = False
    elif case == "one_row":
        keys = [np.array([3])]
        valid[:] = True
    elif case == "one_group":
        keys = [np.zeros(n, dtype=np.int64)]
    elif case == "distinct_2e16":
        keys = [r.permutation(n).astype(np.int64)]
    else:
        keys = [(r.permutation(n).astype(np.int64) << 32) | 99]
    vals = r.normal(size=n)
    vals[r.random(n) < 0.03] = np.nan
    ints = r.integers(-1000, 1000, n)
    lb = [torch.from_numpy(np.ascontiguousarray(k)).to(dev) for k in keys]
    ar = [torch.from_numpy(v).to(dev) for v in [vals] * len(OPS) + [ints] * len(OPS)]
    return lb, ar, OPS + OPS, torch.from_numpy(valid).to(dev)


def _k3_agree(got, want):
    """K3 against its plain version: groups matched by their smallest row
    (which also names a NaN key's group), float outputs within rtol 1e-9,
    the rest exact; past the group count every output holds its identity."""
    ko, kc, kr, kn = got
    po, pc, pr, pn = want
    g = int(kn)
    assert g == int(pn)
    ki, pi = torch.argsort(kr[:g]), torch.argsort(pr[:g])
    assert torch.equal(kr[:g][ki], pr[:g][pi]) and torch.equal(kc[:g][ki], pc[:g][pi])
    assert torch.equal(kr[g:], pr[g:]) and torch.equal(kc[g:], pc[g:])
    for a, c in zip(ko, po):
        assert a.dtype == c.dtype and a.shape == c.shape
        if a.is_floating_point():
            assert torch.allclose(a[:g][ki], c[:g][pi], rtol=1e-9, atol=1e-12, equal_nan=True)
            assert torch.allclose(a[g:], c[g:], rtol=0, atol=0, equal_nan=True)
        else:
            assert torch.equal(a[:g][ki], c[:g][pi]) and torch.equal(a[g:], c[g:])


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_typed_keys_match_plain(cuda_device, case):
    lb, ar, ops, va = _k3_case(case, cuda_device)
    _k3_agree(hashtable.hash_groupby(lb, ar, ops, va),
              hashtable.hash_groupby_plain(lb, ar, ops, va))


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_never_syncs_and_never_fails(cuda_device, case):
    """At capbits_for(n) a K3 call makes no host read (the sync debug mode
    raises on one), and the insert's flag stays 0."""
    lb, ar, ops, va = _k3_case(case, cuda_device)
    hashtable.hash_groupby(lb, ar, ops, va)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hashtable._hash_groupby_cuda(tuple(lb), tuple(ar), tuple(ops), va,
                                           hashtable.capbits_for(va.shape[0]))
        hashtable.hash_groupby(lb, ar, ops, va)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(got[4]) == 0


@pytest.mark.parametrize("ranks", ["int64", "int32", "keyless"])
def test_k3_segment_pass_over_given_ranks(cuda_device, ranks):
    """segment_aggs (the sort group-by's and the keyless aggregates') against
    its plain version."""
    r = np.random.default_rng(5)
    n = 1 << 14
    rk = torch.from_numpy(r.integers(0, 300, n)).to(cuda_device)
    rk = {"int64": rk, "int32": rk.to(torch.int32),
          "keyless": torch.zeros(n, dtype=torch.int32, device=cuda_device)}[ranks]
    vals = r.normal(size=n)
    vals[r.random(n) < 0.03] = np.nan
    ar = [torch.from_numpy(vals).to(cuda_device)] * len(OPS)
    va = torch.from_numpy(r.random(n) < 0.9).to(cuda_device)
    ko, kc, kr = hashtable.segment_aggs(rk, va, ar, OPS)
    po, pc, pr = hashtable.segment_aggs_plain(rk, va, ar, OPS)
    assert torch.equal(kc, pc) and torch.equal(kr, pr)
    for a, c in zip(ko, po):
        assert a.dtype == c.dtype and torch.allclose(a, c, rtol=1e-9, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("entry", ["hash_groupby", "segment_aggs"])
def test_k3_strided_inputs_match_plain(cuda_device, entry):
    """Strided inputs: a key column and two aggregate columns of one size
    taken from wider tensors (their contiguous copies must each live through
    the launch: two freed copies of one size would share a block), and a
    strided validity mask."""
    r = np.random.default_rng(11)
    n = 20_000
    wide = torch.from_numpy(r.normal(size=(n, 3))).to(cuda_device)
    ints = torch.from_numpy(r.integers(-50, 50, (n, 2))).to(cuda_device)
    keys = torch.from_numpy(r.integers(0, 40, (n, 2))).to(cuda_device)[:, 1]
    va = torch.from_numpy(r.random((n, 2)) < 0.9).to(cuda_device)[:, 0]
    ar = [wide[:, 0], wide[:, 2], ints[:, 1], wide[:, 1]]
    ops = ["sum", "max", "sum", "mean"]
    assert not any(t.is_contiguous() for t in (keys, va, *ar))
    if entry == "hash_groupby":
        _k3_agree(hashtable.hash_groupby([keys], ar, ops, va),
                  hashtable.hash_groupby_plain([keys], ar, ops, va))
        return
    ko, kc, kr = hashtable.segment_aggs(keys, va, ar, ops)
    po, pc, pr = hashtable.segment_aggs_plain(keys, va, ar, ops)
    assert torch.equal(kc, pc) and torch.equal(kr, pr)
    for a, c in zip(ko, po):
        assert a.dtype == c.dtype and torch.allclose(a, c, rtol=1e-9, atol=1e-12, equal_nan=True)


def test_k4_kernel_matches_plain(cuda_device):
    b = bridge.host_to_device(host_table(5000, seed=6), cuda_device)
    big = torch.from_numpy(np.random.default_rng(1).uniform(-4e9, 4e9, b.padded_len))
    limbs = [b.columns["i"].data, b.columns["f"].data, b.columns["b"].data,
             b.columns["d"].data, big.to(cuda_device)]
    limbs += list(b.columns["s"].hash_limbs())
    for n_parts in (2, 5, 64):
        a = kernels.partition_split(limbs, None, b.valid, n_parts)
        c = kernels.partition_split_plain(limbs, None, b.valid, n_parts)
        assert all(torch.equal(x, y) for x, y in zip(a, c)), n_parts


K5_AGGS = ("sum(g * (1 - f)) as sx, count(*) as n, count(g) as ng, min(i) as mi, "
           "max(g) as mg, avg(f + i) as af")


def test_k5_kernel_matches_plain(cuda_device):
    b = bridge.host_to_device(host_table(5000, seed=8), cuda_device)
    plan = plan_aggregation(sqlparse.parse_select_list(K5_AGGS))
    call = fuse.FusedPartialAgg(["i", "d"], plan).prepare_general(b)
    for a, c in zip(call.launch(), call.plain()):
        assert a.dtype == c.dtype
        if a.is_floating_point():
            assert torch.allclose(a, c, rtol=1e-12, atol=0, equal_nan=True)
        else:
            assert torch.equal(a, c)


def _unique_keys(kind, n, r):
    """Unique build key limbs (numpy) of one kind."""
    if kind == "int64":
        return [r.permutation(4 * n)[:n].astype(np.int64) * (1 << 33) - (1 << 40)]
    if kind == "int32":
        return [r.permutation(4 * n)[:n].astype(np.int32) * 3 - (1 << 20)]
    if kind == "composite":
        flat = r.permutation(40 * n)[:n]
        return [(flat // 40).astype(np.int64), (flat % 40).astype(np.int32) - 20]
    if kind == "int32x2":  # a string key's two hash limbs
        flat = r.permutation(40 * n)[:n]
        return [(flat % 7 * 1000003 - 5).astype(np.int32), (flat // 7 - 9).astype(np.int32)]
    v = r.permutation(np.arange(-2 * n, 2 * n))[:n].astype(np.float64) / 8
    v[v == 0.0] = -0.0
    v[r.random(n) < 0.05] = np.nan
    return [v.astype(np.float32)] if kind == "float32" else [v]


def _probe_of(build, p, r, kind=None):
    other = _unique_keys(kind or ("float64" if build[0].dtype == np.float64 else
                                  ("composite" if len(build) == 2 else "int64")),
                         len(build[0]), np.random.default_rng(99))
    pick = r.integers(0, len(build[0]), p)
    hit = r.random(p) < 0.6
    probe = [np.where(hit, b[pick], o[pick]).astype(b.dtype) for b, o in zip(build, other)]
    if probe[0].dtype.kind == "f":
        probe[0] = np.where(probe[0] == 0.0, 0.0, probe[0])  # +0.0 meets -0.0
    return probe


@pytest.mark.parametrize("kind", ["int64", "composite", "float64"])
def test_k11_kernel_matches_plain(cuda_device, kind):
    """The kernel-built table probed by the kernel gives the plain-built
    table's (build_idx, matched); keys that collide in the hash included."""
    r = np.random.default_rng(len(kind))
    nb, p = 1 << 15, 1 << 18
    build = [torch.from_numpy(x).to(cuda_device) for x in _unique_keys(kind, nb, r)]
    probe = [torch.from_numpy(x).to(cuda_device) for x in _probe_of(
        [x.cpu().numpy() for x in build], p, r)]
    ok = torch.from_numpy(r.random(nb) < 0.9).to(cuda_device)
    pok = torch.from_numpy(r.random(p) < 0.95).to(cuda_device)
    limbs = hashtable.canonical_limbs(build, nan_unique=False)
    bok = ok & ~hashtable.nan_rows(build)
    capbits = hashtable.capbits_for(nb)
    t_kernel, conv_k = hashtable._build_insert(tuple(l.contiguous() for l in limbs), bok, capbits)
    _, t_plain, conv_p = hashtable._insert_plain(limbs, bok, capbits)
    assert conv_k and conv_p
    coerced = [x.to(b.dtype) for x, b in zip(probe, build)]
    climbs = hashtable.canonical_limbs(coerced, nan_unique=False)
    qok = pok & ~hashtable.nan_rows(coerced)
    ik, mk = hashtable._probe_cuda(t_kernel, limbs, climbs, qok, capbits)
    ip, mp = hashtable._probe_plain(t_plain, limbs, climbs, qok, capbits)
    assert torch.equal(mk, mp)
    assert torch.equal(ik[mk], ip[mp])
    assert 0 < int(mk.sum()) < p


# K12's limb signatures: csrc/join.cu compiles int64, float64, int32 and two
# int32 limbs typed; (int64, int32) and float32 take the dispatch kernel
K12_TYPED = {"int64": True, "composite": False, "float64": True, "int32": True,
             "int32x2": True, "float32": False}


@pytest.mark.parametrize("kind", list(K12_TYPED))
def test_k12_kernel_matches_plain(cuda_device, kind):
    """The sorted probe kernel against its plain version: -0.0 against
    +0.0, NaN (never matches), int64, int32, two int32 and composite keys,
    and float32 keys through the runtime-dispatch kernel, whose launches
    are counted apart."""
    r = np.random.default_rng(10 + len(kind))
    nb, p = 1 << 15, 1 << 18
    build = [torch.from_numpy(x).to(cuda_device) for x in _unique_keys(kind, nb, r)]
    probe = [torch.from_numpy(x).to(cuda_device) for x in _probe_of(
        [x.cpu().numpy() for x in build], p, r, kind)]
    ok = torch.from_numpy(r.random(nb) < 0.9).to(cuda_device)
    pok = torch.from_numpy(r.random(p) < 0.95).to(cuda_device)
    sorted_limbs, perm, nv = join._sort_build_keys(build, ok)
    launches, dispatched = join.SORTED_PROBE_LAUNCHES, join.SORTED_PROBE_DISPATCH_LAUNCHES
    ik, mk = join._pk_probe_sorted_cuda(sorted_limbs, perm, nv, probe, pok)
    assert join.SORTED_PROBE_LAUNCHES == launches + 1
    assert join.SORTED_PROBE_DISPATCH_LAUNCHES == dispatched + (0 if K12_TYPED[kind] else 1)
    ip, mp = join._pk_probe_sorted_plain(sorted_limbs, perm, nv, probe, pok)
    assert torch.equal(mk, mp)
    assert torch.equal(ik[mk], ip[mp])
    assert 0 < int(mk.sum()) < p


def _strided(t: torch.Tensor) -> torch.Tensor:
    """t's values in a view that is not contiguous."""
    return torch.stack([t, t], 1)[:, 1]


def test_k12_strided_inputs_match_plain(cuda_device):
    """The sorted build's limbs and perm, the probe's limbs and its ok mask
    taken from wider tensors: their contiguous copies live through the
    launch."""
    r = np.random.default_rng(12)
    nb, p = 1 << 15, 1 << 18
    build = [torch.from_numpy(x).to(cuda_device) for x in _unique_keys("composite", nb, r)]
    probe = [torch.from_numpy(x).to(cuda_device) for x in _probe_of(
        [x.cpu().numpy() for x in build], p, r, "composite")]
    ok = torch.from_numpy(r.random(nb) < 0.9).to(cuda_device)
    pok = torch.from_numpy(r.random(p) < 0.95).to(cuda_device)
    sorted_limbs, perm, nv = join._sort_build_keys(build, ok)
    want = join._pk_probe_sorted_plain(sorted_limbs, perm, nv, probe, pok)
    args = ([_strided(l) for l in sorted_limbs], _strided(perm), nv,
            [_strided(l) for l in probe], _strided(pok))
    assert not any(t.is_contiguous() for t in (*args[0], args[1], *args[3], args[4]))
    ik, mk = join._pk_probe_sorted_cuda(*args)
    assert torch.equal(mk, want[1])
    assert torch.equal(ik[mk], want[0][want[1]])


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("skew", [False, True], ids=["spread", "hot_key"])
def test_k13_kernel_matches_plain(cuda_device, how, skew):
    """The many-to-many expand against its plain version at every output
    row, the padding rows included; with one probe key that matches 10^4
    build rows."""
    r = np.random.default_rng(40 + skew)
    p, b = 1 << 16, 1 << 18
    bk = r.integers(0, 1 << 15, b).astype(np.int64)
    pk = r.integers(0, 1 << 16, p).astype(np.int64)
    if skew:
        bk[:10_000] = 12345
        pk[:50] = 12345
    limbs = [torch.from_numpy(np.concatenate([pk, bk])).to(cuda_device)]
    valid = torch.from_numpy(np.concatenate([r.random(p) < 0.95, r.random(b) < 0.95]))
    valid = valid.to(cuda_device)
    pv = torch.ones(p, dtype=torch.bool, device=cuda_device)
    mc, total, off, bps, rp, unm = join.mm_plan_for(limbs, valid, p, how, pv)
    out = 1 << int(np.ceil(np.log2(int(total) + 1000)))
    cum = torch.cumsum(mc, 0)
    k = join._mm_expand_cuda(cum, off, bps, rp, total, out, unm)
    q = join._mm_expand_plain(cum, off, bps, rp, total, out, unm)
    for a, c in zip(k[:3], q[:3]):
        assert torch.equal(a, c)
    if how == "left":
        assert torch.equal(k[3], q[3]) and 0 < int(k[3][k[2]].sum())
    assert int(k[2].sum()) == int(total)


STAGES = [
    [("filter", "g > 2 and s = 'ab'"),
     ("map", [("h", "g * (1 - f)"), ("y", "extract(year from d)")])],
    [("map", [("g", "g + i"), ("m", "extract(month from d)")]),
     ("filter", "g < 20 or t = 'x'"), ("project", ["g", "m", "s"])],
    [("filter", "not (f > 0.5) or i is null"),
     ("map", [("day", "extract(day from d)"), ("c", "case when b then 1 else 0 end")])],
]


@pytest.mark.parametrize("stage", range(len(STAGES)))
def test_k16_kernel_matches_plain(cuda_device, stage):
    """The in-stage elementwise kernel against its plain version, on dates
    from 0001 to 9999 (before 1970 too) with nulls."""
    t = host_table(1 << 16, seed=50 + stage)
    r = np.random.default_rng(stage)
    d = r.integers(-719162, 2932896, 1 << 16).astype("datetime64[D]")
    d[r.random(1 << 16) < 0.05] = np.datetime64("NaT")
    t.columns["d"] = d
    b = bridge.host_to_device(t, cuda_device)
    steps = []
    for kind, payload in STAGES[stage]:
        if kind == "filter":
            steps.append((kind, sqlparse.parse_expression(payload)))
        elif kind == "map":
            steps.append((kind, [(n, sqlparse.parse_expression(e)) for n, e in payload]))
        else:
            steps.append((kind, payload))
    call, _ = stagefuse.FusedElementwise(steps).prepare(b)
    mk, ck, ok = call.launch()
    mp, cp, op = call.plain()
    assert torch.equal(mk, mp) and int(ck) == int(cp)
    for a, c in zip(ok, op):
        assert a.dtype == c.dtype
        assert torch.equal(a, c) or torch.allclose(a, c, rtol=0, atol=0, equal_nan=True)


def test_k3_nonconvergence_falls_back_on_the_card(cuda_device, monkeypatch):
    """K3's insert on a 4-slot table cannot converge: the group-by reruns
    through the sort group-by and matches it."""
    r = np.random.default_rng(3)
    n = 4096
    lb = [torch.from_numpy(r.integers(0, 300, n)).to(cuda_device)]
    ar = [torch.from_numpy(r.normal(size=n)).to(cuda_device) for _ in OPS]
    va = torch.from_numpy(r.random(n) < 0.9).to(cuda_device)
    want = kernels.sorted_groupby(lb, ar, OPS, va)
    monkeypatch.setattr(hashtable, "capbits_for", lambda n: 2)
    got = hashtable.hash_groupby(lb, ar, OPS, va)
    g = int(want[3])
    assert int(got[3]) == g
    assert torch.equal(got[1][:g], want[1][:g]) and torch.equal(got[2][:g], want[2][:g])
    for a, c in zip(got[0], want[0]):
        assert torch.allclose(a[:g], c[:g], rtol=1e-9, atol=1e-12, equal_nan=True)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


K18_CASES = ["spread", "one_key", "ties", "empty_quotes", "own_key", "unstaged_runs",
             "no_key", "float64_times", "int32_times", "float32_times", "dispatch"]


@pytest.mark.parametrize("case", K18_CASES)
@pytest.mark.parametrize("upper", [True, False], ids=["backward", "forward"])
def test_k18_kernel_matches_plain(cuda_device, case, upper):
    """The two-level probe against the full-range plain search, both outputs
    on every row: every quote its own key, a run table past the 16 KiB
    shared-memory stage, no key limb, float64 times with NaN and -0.0,
    int32 and float32 times, and a float32 key through the runtime-dispatch
    kernel, whose launches are counted apart."""
    r = np.random.default_rng(18)
    nq, p = 1 << 18, 1 << 16
    n_keys = {"one_key": 1, "own_key": nq, "unstaged_runs": 20_000}.get(case, 50)
    t_hi = 1000 if case == "ties" else 10**8

    def ops(n, quotes):
        if case == "own_key" and quotes:
            k = r.permutation(n).astype(np.int32)
        else:
            k = r.integers(0, n_keys, n).astype(np.int32)
        keys = [k.astype(np.float32) / 4] if case == "dispatch" else [k, k * 31 - 7]
        t = np.sort(r.integers(0, t_hi, n))
        if case == "float64_times":
            t = (t - t_hi // 2) / 1e6
            t[r.random(n) < 0.05] = np.nan
            t[r.random(n) < 0.05] = 0.0
            t[t == 0] = np.where(r.random(int((t == 0).sum())) < 0.5, -0.0, 0.0)
        elif case == "int32_times":
            t = (t - t_hi // 2).astype(np.int32)
        elif case == "float32_times":
            t = (t / 1e3).astype(np.float32)
        return [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                for x in ([] if case == "no_key" else keys) + [t]]

    qvalid = torch.from_numpy(r.random(nq) < (0.0 if case == "empty_quotes" else 0.9))
    so, perm, nv = asof._ss_sort_quotes(ops(nq, True), qvalid.to(cuda_device))
    nkey = len(so) - 1
    runs = asof._ss_key_runs(so, nv, nkey)
    n_runs = runs.bounds.shape[0] - 1
    if case == "unstaged_runs":
        assert n_runs * 8 + (n_runs + 1) * 4 > 16384  # past the shared-memory stage
    po = ops(p, False)
    pv = torch.from_numpy(r.random(p) < 0.9).to(cuda_device)
    launches, dispatched = asof.ASOF_PROBE_LAUNCHES, asof.ASOF_PROBE_DISPATCH_LAUNCHES
    got = asof._asof_probe_cuda(so, perm, nv, po, pv, upper, nkey, runs)
    assert asof.ASOF_PROBE_LAUNCHES == launches + 1
    assert asof.ASOF_PROBE_DISPATCH_LAUNCHES == dispatched + (case == "dispatch")
    want = asof._asof_probe_plain(so, perm, nv, po, pv, upper, nkey)
    _equal(got, want)
    if case != "empty_quotes":
        assert int(want[1].sum()) > 0


@pytest.mark.parametrize("upper", [True, False], ids=["backward", "forward"])
def test_k18_strided_inputs_match_plain(cuda_device, upper):
    """The run table's bounds, the sorted times, perm, the probe's limbs
    and its mask taken from wider tensors: the four contiguous copies the
    wrapper makes live through the launch."""
    r = np.random.default_rng(180)
    nq, p = 1 << 17, 1 << 15

    def ops(n):
        k = r.integers(0, 50, n).astype(np.int32)
        t = np.sort(r.integers(0, 10**8, n))
        return [torch.from_numpy(x).to(cuda_device) for x in (k, k * 31 - 7, t)]

    qvalid = torch.from_numpy(r.random(nq) < 0.9).to(cuda_device)
    so, perm, nv = asof._ss_sort_quotes(ops(nq), qvalid)
    runs = asof._ss_key_runs(so, nv, 2)
    po = ops(p)
    pv = torch.from_numpy(r.random(p) < 0.9).to(cuda_device)
    want = asof._asof_probe_plain(so, perm, nv, po, pv, upper, 2)
    so_s = list(so[:2]) + [_strided(so[2])]
    runs_s = runs._replace(bounds=_strided(runs.bounds))
    args = (so_s, _strided(perm), nv, [_strided(o) for o in po], _strided(pv))
    assert not any(t.is_contiguous() for t in (so_s[2], args[1], *args[3], args[4],
                                               runs_s.bounds))
    _equal(asof._asof_probe_cuda(*args, upper, 2, runs_s), want)
    assert int(want[1].sum()) > 0


K19_ROWS = [0, 1000, 1 << 20, (1 << 22) + 3, 5_242_880]


@pytest.mark.parametrize("n", K19_ROWS)
@pytest.mark.parametrize("density", [0.0, 1e-3, 1.0])
def test_k19_kernel_matches_plain(cuda_device, n, density):
    """K19's general form at row counts that are and are not a multiple of
    its 4096-row tile (the as-of sort strategy's 5,242,880 rows among
    them), with no start, sparse starts and a start on every row."""
    r = np.random.default_rng(n)
    v = torch.from_numpy(r.integers(-(2**31), 2**31 - 1, n).astype(np.int32)).to(cuda_device)
    st = torch.from_numpy(r.random(n) < density).to(cuda_device)
    _equal([asof._seg_fill_forward_cuda(v, st)], [asof._seg_fill_forward_plain(v, st)])


@pytest.mark.parametrize("n", K19_ROWS)
@pytest.mark.parametrize("density", [0.0, 1e-3, 1.0])
def test_k19_segment_bounds_match_plain(cuda_device, n, density):
    """K19 both ways: each row's segment start (forwards) and end
    (backwards) against K19's plain scan and row 20's flip and cummin."""
    r = np.random.default_rng(n + 1)
    fl = torch.from_numpy(r.random(n) < density).to(cuda_device)
    launches = asof.SEGMENT_BOUNDS_LAUNCHES
    _equal(asof._segment_bounds_cuda(fl), asof._segment_bounds_plain(fl))
    assert asof.SEGMENT_BOUNDS_LAUNCHES == launches + 1


def test_k19_strided_inputs_match_plain(cuda_device):
    """Values and starts taken from wider tensors, and starts that begin
    one byte into their storage (no 16-byte loads): the contiguous copies
    live through the launch."""
    r = np.random.default_rng(19)
    n = (1 << 20) + 5
    v = _strided(torch.from_numpy(r.integers(-50, 50, n).astype(np.int32)).to(cuda_device))
    st = _strided(torch.from_numpy(r.random(n) < 1e-3).to(cuda_device))
    assert not v.is_contiguous() and not st.is_contiguous()
    _equal([asof._seg_fill_forward_cuda(v, st)], [asof._seg_fill_forward_plain(v, st)])
    fl = torch.from_numpy(r.random(n + 1) < 1e-3).to(cuda_device)[1:]
    _equal([asof._seg_fill_forward_cuda(v.contiguous(), fl)],
           [asof._seg_fill_forward_plain(v, fl)])


def test_k19_segment_bounds_strided_inputs_match_plain(cuda_device):
    r = np.random.default_rng(191)
    n = (1 << 20) + 5
    fl = _strided(torch.from_numpy(r.random(n) < 1e-3).to(cuda_device))
    assert not fl.is_contiguous()
    _equal(asof._segment_bounds_cuda(fl), asof._segment_bounds_plain(fl))
    off = torch.from_numpy(r.random(n + 1) < 0.3).to(cuda_device)[1:]
    _equal(asof._segment_bounds_cuda(off), asof._segment_bounds_plain(off))


@pytest.mark.parametrize("n_keys", [1, 100])
@pytest.mark.parametrize("size", [0, 10_000, 10**9])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float64])
def test_k20_kernels_match_plain(cuda_device, n_keys, size, dtype):
    r = np.random.default_rng(n_keys + size)
    n = 1 << 19
    key = np.sort(r.integers(0, n_keys, n))
    t = r.integers(0, 10**7, n)
    o = np.lexsort((t, key))
    t = torch.from_numpy(t[o]).to(cuda_device).to(dtype)
    key = torch.from_numpy(key[o]).to(cuda_device)
    io = torch.arange(n, dtype=torch.int32, device=cuda_device)
    fl = (key != torch.roll(key, 1)) | (io == 0)
    ss, se = asof._segment_bounds_cuda(fl)
    lr = ts_execs._window_bounds_cuda(t, ss, se, size)
    _equal(lr, ts_execs._window_bounds_plain(t, ss, se, size))
    x = torch.from_numpy(r.uniform(10, 500, n).round(3)).to(cuda_device)
    for op in ("min", "max"):
        _equal([ts_execs._range_minmax_cuda(x, *lr, op)],
               [ts_execs._range_minmax_plain(x, *lr, op)])


def _k20a_case(r, case, dtype, dev):
    """(times, segment starts, segment ends) of K20a's cases: rows sorted by
    (key, time) in 100 keys, runs of equal timestamps, one segment holding
    every row, that segment padded with zero times (out of order: every row
    takes the reference's searches), the sorted rows padded to 2^23 with a
    segment of their own, float64 times with NaN last in each key, and no
    row."""
    n = 1 << 19
    key = np.sort(r.integers(0, 100, n))
    t = r.integers(1, 10**7, n)
    if case == "equal_timestamps":
        t = t // 1000 * 1000
    if case in ("one_segment", "one_segment_padded"):
        key[:] = 0
    if case == "empty":
        key, t = key[:0], t[:0]
    o = np.lexsort((t, key))
    key, t = key[o], t[o].astype(np.float64 if dtype == torch.float64 else np.int64)
    if case == "nan_last":
        t = t.astype(np.float64)
        for k in np.unique(key)[::7]:
            t[np.flatnonzero(key == k)[-3:]] = np.nan
    pad = {"one_segment_padded": n + 300_000, "rows_2_23": 1 << 23}.get(case)
    if pad is not None:
        key = np.r_[key, np.full(pad - n, 0 if case == "one_segment_padded" else 100)]
        t = np.r_[t, np.zeros(pad - n, dtype=t.dtype)]
    key, t = torch.from_numpy(key).to(dev), torch.from_numpy(t).to(dev)
    io = torch.arange(key.shape[0], dtype=torch.int32, device=dev)
    fl = (key != torch.roll(key, 1)) | (io == 0)
    return (t, *asof._segment_bounds_cuda(fl))


K20A_CASES = ["sorted", "equal_timestamps", "one_segment", "one_segment_padded", "rows_2_23",
              "nan_last", "empty"]


@pytest.mark.parametrize("case,dtype", [(c, d) for c in K20A_CASES
                                        for d in (torch.int64, torch.float64)
                                        if c != "nan_last" or d == torch.float64])
@pytest.mark.parametrize("size", [0, 10_000, 2.5])
def test_k20a_cases_match_plain(cuda_device, case, dtype, size):
    """K20a against the reference's 32-step searches on every row, int64
    and float64 times (NaN times float64 only), a fractional size (float64
    targets)."""
    r = np.random.default_rng(K20A_CASES.index(case) * 10 + int(size))
    t, ss, se = _k20a_case(r, case, dtype, cuda_device)
    launches = ts_execs.WINDOW_BOUNDS_LAUNCHES
    _equal(ts_execs._window_bounds_cuda(t, ss, se, size),
           ts_execs._window_bounds_plain(t, ss, se, size))
    assert ts_execs.WINDOW_BOUNDS_LAUNCHES == launches + 1


def test_k20a_strided_inputs_match_plain(cuda_device):
    """Times and both segment bounds taken from wider tensors: their
    contiguous copies live through the launch."""
    r = np.random.default_rng(201)
    t, ss, se = _k20a_case(r, "sorted", torch.int64, cuda_device)
    args = (_strided(t), _strided(ss), _strided(se))
    assert not any(a.is_contiguous() for a in args)
    _equal(ts_execs._window_bounds_cuda(*args, 10_000),
           ts_execs._window_bounds_plain(t, ss, se, 10_000))


def _equal_nan(a, b):
    """Value equality, NaN equal to NaN."""
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
    assert torch.equal(a, b)


def _k20b_x(r, n, dtype):
    if dtype.is_floating_point:
        x = r.normal(size=n).round(3)
        x[r.random(n) < 0.01] = np.nan
        return torch.from_numpy(x).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(r.integers(info.min, info.max, n, endpoint=True)).to(dtype)


K20B_CASES = ["random", "degenerate", "wider_than_a_tile", "whole", "ragged", "out_of_range"]


@pytest.mark.parametrize("case", K20B_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.int64, torch.int32])
def test_k20b_ranges_match_plain(cuda_device, case, dtype):
    """K20b on arbitrary ranges: random and degenerate (left > right) ones,
    monotone windows of 700-3000 rows (wider than a 256-row tile), one
    window over every row, a row count that is no multiple of the tile, and
    bounds outside [0, n), with NaN in float inputs."""
    r = np.random.default_rng(len(case) + dtype.itemsize)
    n = (1 << 18) + 77 if case == "ragged" else 1 << 18
    iota = np.arange(n)
    if case == "random":
        left = r.integers(0, n, n)
        right = np.minimum(left + r.integers(0, 3, n) ** r.integers(0, 12, n), n - 1)
    elif case == "degenerate":
        left, right = r.integers(0, n, n), r.integers(0, n, n)
    elif case == "wider_than_a_tile":
        left = np.maximum.accumulate(np.maximum(iota - r.choice([700, 3000], n), 0))
        right = iota
    elif case == "whole":
        left, right = np.zeros(n, dtype=np.int64), np.full(n, n - 1)
    elif case == "ragged":
        left, right = np.maximum.accumulate(np.maximum(iota - r.integers(0, 9, n), 0)), iota
    else:
        left = r.integers(-n, 2 * n, n)
        right = left + r.integers(-50, 5000, n)
    x = _k20b_x(r, n, dtype).to(cuda_device)
    lr = [torch.from_numpy(a.astype(np.int32)).to(cuda_device) for a in (left, right)]
    launches = ts_execs.RANGE_MINMAX_LAUNCHES
    for op in ("min", "max"):
        _equal_nan(ts_execs._range_minmax_cuda(x, *lr, op),
                   ts_execs._range_minmax_plain(x, *lr, op))
    assert ts_execs.RANGE_MINMAX_LAUNCHES == launches + 2


def test_k20b_strided_inputs_match_plain(cuda_device):
    """x and both bounds taken from wider tensors: their contiguous copies
    live through the launch."""
    r = np.random.default_rng(21)
    n = 1 << 17
    x = torch.from_numpy(r.normal(size=(n, 2))).to(cuda_device)[:, 1]
    iota = np.arange(n)
    left = np.maximum.accumulate(np.maximum(iota - r.integers(0, 40, n), 0))
    lr = torch.from_numpy(np.stack([left, iota, left], 1).astype(np.int32)).to(cuda_device)
    assert not any(t.is_contiguous() for t in (x, lr[:, 0], lr[:, 1]))
    for op in ("min", "max"):
        _equal_nan(ts_execs._range_minmax_cuda(x, lr[:, 0], lr[:, 1], op),
                   ts_execs._range_minmax_plain(x, lr[:, 0], lr[:, 1], op))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.int64, torch.int32])
def test_k20b_over_k20a_bounds(cuda_device, dtype):
    """K20b over the windows K20a gives on sorted key segments."""
    r = np.random.default_rng(20)
    n = 1 << 19
    key = np.sort(r.integers(0, 100, n))
    t = np.sort(r.integers(0, 10**7, n))
    o = np.lexsort((t, key))
    t = torch.from_numpy(t[o]).to(cuda_device)
    key = torch.from_numpy(key[o]).to(cuda_device)
    io = torch.arange(n, dtype=torch.int32, device=cuda_device)
    fl = (key != torch.roll(key, 1)) | (io == 0)
    ss, se = asof._segment_bounds_cuda(fl)
    lr = ts_execs._window_bounds_cuda(t, ss, se, 20_000)
    x = _k20b_x(r, n, dtype).to(cuda_device)
    for op in ("min", "max"):
        _equal_nan(ts_execs._range_minmax_cuda(x, *lr, op),
                   ts_execs._range_minmax_plain(x, *lr, op))


def _topk_agree(got, exp, tol):
    """K21 results agree: scores within ``tol`` slot by slot (NaN where NaN),
    and a handle on one side only scores within 2 ``tol`` of its side's k-th."""
    gs, gh = (t.cpu() for t in got)
    es, eh = (t.cpu() for t in exp)
    assert torch.equal(torch.isnan(gs), torch.isnan(es))
    live = ~torch.isnan(gs)
    assert torch.allclose(gs[live], es[live], rtol=0, atol=tol)
    for qi in range(gs.shape[0]):
        a, b = set(gh[qi].tolist()), set(eh[qi].tolist())
        for h in a ^ b:
            s_, h_ = (gs, gh) if h in a else (es, eh)
            j = int((h_[qi] == h).nonzero()[0, 0])
            assert abs(float(s_[qi, j]) - float(s_[qi, -1])) <= 2 * tol, (qi, h)


def _k21_inputs(device, n, d, nq, seed):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, d))
    v[r.random(n) < 0.01] = 0.0  # null rows: zero vectors
    if n > 40:
        v[7] = v[33]  # an exact tie
        v[20, 0] = np.nan
    q = vector.normalize_queries(r.normal(size=(nq, d)))
    valid = r.random(n) < 0.95
    return (torch.from_numpy(q).to(device), torch.from_numpy(v).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("d", [1, 7, 768])
def test_k21_kernel_matches_plain(cuda_device, k, d):
    nq = 256
    state = vector.empty_state(nq, k, cuda_device)
    plain = state
    tol = 1e-5 if d > 7 else 1e-6
    for b, n in enumerate([1 << 16, 3000]):
        q, v, valid = _k21_inputs(cuda_device, n, d, nq, seed=k * 1000 + d + b)
        state = vector.sims_topk_cuda(q, v, valid, k, *state, b)
        plain = vector.sims_topk_plain(q, v, valid, k, *plain, b)
        torch.cuda.synchronize()
        if d == 1:  # one product per score: bit for bit (NaN slots included)
            assert torch.equal(state[0].view(torch.int32), plain[0].view(torch.int32))
            assert torch.equal(state[1], plain[1])
        else:
            _topk_agree(state, plain, tol)
        plain = state  # the next batch merges into the same state on both sides


def test_k21_kernel_fewer_rows_than_k(cuda_device):
    q, v, valid = _k21_inputs(cuda_device, 50, 9, 70, seed=5)
    state = vector.empty_state(70, 100, cuda_device)
    got = vector.sims_topk_cuda(q, v, valid, 100, *state, 3)
    exp = vector.sims_topk_plain(q, v, valid, 100, *state, 3)
    _topk_agree(got, exp, 1e-6)
    assert int((got[1][0] >= 0).sum()) == 50  # 50 rows fill 50 of the 100 slots


def test_k21_raises_above_its_k_cap(cuda_device):
    q, v, valid = _k21_inputs(cuda_device, 300, 4, 2, seed=6)
    k = vector.MAX_K + 1
    with pytest.raises(NotImplementedError, match="The rest of the vector tier"):
        vector.sims_topk(q, v, valid, k, *vector.empty_state(2, k, cuda_device), 0)


def test_k21_takes_float64_vectors_only(cuda_device):
    q, v, valid = _k21_inputs(cuda_device, 300, 4, 2, seed=7)
    with pytest.raises(TypeError, match="float64 vectors"):
        vector.sims_topk(q, v.to(torch.float32), valid, 3, *vector.empty_state(2, 3, cuda_device),
                         0)


@pytest.mark.parametrize("nq", [1, 4, 130])
def test_k21_query_counts(cuda_device, nq):
    # one query, the ann path's four, and a count that is not a multiple of
    # the kernel's 128-query tile
    q, v, valid = _k21_inputs(cuda_device, 20000, 100, nq, seed=nq)
    state = vector.empty_state(nq, 10, cuda_device)
    got = vector.sims_topk_cuda(q, v, valid, 10, *state, 0)
    exp = vector.sims_topk_plain(q, v, valid, 10, *state, 0)
    torch.cuda.synchronize()
    _topk_agree(got, exp, 1e-5)


@pytest.mark.parametrize("d", [100, 17])
def test_k21_at_its_k_cap(cuda_device, d):
    # k = MAX_K (the lists fill most of shared memory), at depths that are
    # not multiples of the 16-deep padding; two batches merged
    k, nq = vector.MAX_K, 130
    state = plain = vector.empty_state(nq, k, cuda_device)
    for b, n in enumerate([20000, 300]):
        q, v, valid = _k21_inputs(cuda_device, n, d, nq, seed=d + b)
        state = vector.sims_topk_cuda(q, v, valid, k, *state, b)
        plain = vector.sims_topk_plain(q, v, valid, k, *plain, b)
        torch.cuda.synchronize()
        _topk_agree(state, plain, 1e-5)
        plain = state


def test_k21_all_rows_invalid(cuda_device):
    # every row scores -inf and still takes a slot, the lower rows first
    q, v, valid = _k21_inputs(cuda_device, 3000, 17, 40, seed=9)
    valid = torch.zeros_like(valid)
    state = vector.empty_state(40, 10, cuda_device)
    got = vector.sims_topk_cuda(q, v, valid, 10, *state, 2)
    exp = vector.sims_topk_plain(q, v, valid, 10, *state, 2)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
    assert torch.equal(got[1], exp[1])
    assert bool((got[0] == float("-inf")).all())


def _k22_columns(device, d, n, seed):
    """d columns of every type with NaN and invalid rows; the last column a
    slice at an odd element offset (an unaligned start)."""
    r = np.random.default_rng(seed)
    cols = []
    for j in range(d):
        m = n + 1 if j == d - 1 else n
        kind = j % 5
        if kind == 0:
            x = r.normal(size=m) * 100
            x[r.random(m) < 0.001] = np.nan
            c = torch.from_numpy(x)
        elif kind == 1:
            c = torch.from_numpy(r.integers(-10**6, 10**6, m))
        elif kind == 2:
            c = torch.from_numpy(r.integers(0, 50, m).astype(np.int32))
        elif kind == 3:
            c = torch.from_numpy(r.random(m) < 0.3)
        else:
            c = torch.from_numpy(r.normal(size=m).astype(np.float32))
        c = c.to(device)
        cols.append(c[1:] if j == d - 1 else c)
    return cols, torch.from_numpy(r.random(n) < 0.9).to(device)


@pytest.mark.parametrize("d", list(range(1, 10)))
def test_k22_register_path_matches_plain(cuda_device, d):
    # every templated width (1-8) and the first on the shared-memory path (9)
    cols, valid = _k22_columns(cuda_device, d, (1 << 18) + 3, seed=50 + d)
    g, s = linalg.gramian_cuda(cols, valid)
    gp, sp = linalg.gramian_plain(cols, valid)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(g), torch.isnan(gp))
    assert torch.allclose(g, gp, rtol=1e-9, atol=0, equal_nan=True)
    assert torch.allclose(s, sp, rtol=1e-9, atol=0, equal_nan=True)


@pytest.mark.parametrize("d", [4, 17])
def test_k22_same_bits_every_run(cuda_device, d):
    cols, valid = _k22_columns(cuda_device, d, 1 << 20, seed=70 + d)
    first = [t.clone() for t in linalg.gramian_cuda(cols, valid)]
    again = linalg.gramian_cuda(cols, valid)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("d", [1, 4, 17, 64, 100])
def test_k22_kernel_matches_plain(cuda_device, d):
    r = np.random.default_rng(d)
    n = (1 << 18) + 5
    cols = []
    for j in range(d):
        kind = j % 4
        if kind == 0:
            x = r.normal(size=n) * 100
            x[r.random(n) < 0.001] = np.nan
            cols.append(torch.from_numpy(x))
        elif kind == 1:
            cols.append(torch.from_numpy(r.integers(-10**6, 10**6, n)))
        elif kind == 2:
            cols.append(torch.from_numpy(r.integers(0, 50, n).astype(np.int32)))
        else:
            cols.append(torch.from_numpy(r.random(n) < 0.3))
    cols = [c.to(cuda_device) for c in cols]
    valid = torch.from_numpy(r.random(n) < 0.9).to(cuda_device)
    g, s = linalg.gramian_cuda(cols, valid)
    gp, sp = linalg.gramian_plain(cols, valid)
    torch.cuda.synchronize()
    assert torch.allclose(g, gp, rtol=1e-9, atol=0, equal_nan=True)
    assert torch.allclose(s, sp, rtol=1e-9, atol=0, equal_nan=True)
    assert torch.equal(torch.isnan(g), torch.isnan(gp))


@pytest.mark.parametrize("case", ["mixed", "empty_parts", "all_invalid", "wide"])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 7, 64])
def test_k17_kernel_matches_plain(cuda_device, n_parts, case):
    r = np.random.default_rng(n_parts)
    n = (1 << 21) + 77 if case == "wide" else 70_001
    pids = r.integers(0, n_parts, n).astype(np.int32)
    if case == "empty_parts":
        pids = np.where(r.random(n) < 0.5, 0, n_parts - 1).astype(np.int32)
    valid = np.zeros(n, dtype=bool) if case == "all_invalid" else r.random(n) < 0.8
    p, v = torch.from_numpy(pids).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    got = kernels.partition_plan(p, v, n_parts)
    exp = kernels.partition_plan_plain(p, v, n_parts)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", ["rows_2^24_plus_3", "out_of_range_ids", "misaligned"])
@pytest.mark.parametrize("n_parts", [1, 2, 64])
def test_k17_large_and_out_of_range_match_plain(cuda_device, n_parts, case):
    """2^24 + 3 rows (4097 tiles of look-back); ids below 0 and at or past
    n_parts, which K17 files with the invalid rows; ids and validity that
    start one element past an aligned address (no 16-byte loads)."""
    r = np.random.default_rng(1700 + n_parts)
    n = (1 << 24) + 3 if case == "rows_2^24_plus_3" else 300_001
    lo, hi = (-3, n_parts + 3) if case == "out_of_range_ids" else (0, n_parts)
    pids = torch.from_numpy(r.integers(lo, hi, n + 1).astype(np.int32)).to(cuda_device)
    valid = torch.from_numpy(r.random(n + 1) < 0.8).to(cuda_device)
    p, v = (pids[1:], valid[1:]) if case == "misaligned" else (pids[:n], valid[:n])
    got = kernels.partition_plan(p, v, n_parts)
    exp = kernels.partition_plan_plain(p, v, n_parts)
    torch.cuda.synchronize()
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_k17_strided_inputs_match_plain(cuda_device, dtype):
    """Part ids and validity taken from wider tensors (int64 ids also cast
    to int32): the wrapper's converted copies live through the launch."""
    r = np.random.default_rng(17)
    n, n_parts = 300_001, 7
    pids = torch.from_numpy(r.integers(0, n_parts, n)).to(cuda_device, dtype)
    valid = torch.from_numpy(r.random(n) < 0.8).to(cuda_device)
    want = kernels.partition_plan_plain(pids, valid, n_parts)
    ps, vs = _strided(pids), _strided(valid)
    assert not ps.is_contiguous() and not vs.is_contiguous()
    got = kernels.partition_plan(ps, vs, n_parts)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mode", ["salt", "replicate"])
@pytest.mark.parametrize("n_parts", [2, 3, 7, 64])
def test_k26_kernel_matches_plain(cuda_device, n_parts, mode):
    b = bridge.host_to_device(host_table(50_000, seed=26), cuda_device)
    limbs = [b.columns["i"].data, b.columns["f"].data, *b.columns["s"].hash_limbs()]
    fat = n_parts - 1
    for args in ((limbs, None), ([], kernels.partition_ids(b, ["i"], n_parts))):
        for masks in (True, False):
            got = kernels.adapt_split(*args, b.valid, n_parts, fat, mode, masks)
            exp = kernels.adapt_split_plain(*args, b.valid, n_parts, fat, mode, masks)
            torch.cuda.synchronize()
            for x, y in zip(got, exp):
                assert (x is None and y is None) or torch.equal(x, y), (n_parts, mode, masks)


@pytest.mark.parametrize("keys,n", [(["s", "t"], 5000), (["s"], (1 << 20) + 3),
                                    (["t", "s"], 300)])
def test_k6_kernel_matches_plain(cuda_device, keys, n):
    b = bridge.host_to_device(host_table(n, seed=6 + n), cuda_device)
    dims = [1 << int(np.ceil(np.log2(len(b.columns[k].dictionary.values) + 1))) for k in keys]
    strides = tuple(int(np.prod(dims[i + 1:])) for i in range(len(keys)))
    codes = [b.columns[k].codes for k in keys]
    fcols = [b.columns["f"].data, b.columns["g"].data, b.columns["f"].data * 3]
    icols = [b.columns["i"].data, b.columns["d"].data.to(torch.int64)]
    g_n = int(np.prod(dims))
    fs, is_, cnt, rep = fuse.onehot_agg_cuda(fcols, icols, codes, strides, g_n, b.valid)
    pf, pi, pc, pr = fuse.onehot_agg_plain(fcols, icols, codes, strides, g_n, b.valid)
    torch.cuda.synchronize()
    assert torch.equal(cnt, pc) and torch.equal(rep, pr) and torch.equal(is_, pi)
    assert torch.allclose(fs, pf, rtol=1e-9, atol=1e-9, equal_nan=True)
    assert torch.equal(torch.isnan(fs), torch.isnan(pf))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern (floats as same-width integers)."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    if t.is_floating_point():
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32)
    return t


def _k23_batches(case: str, n: int, seed: int):
    """Sequences of leaf lists under one signature (padded to n rows)."""
    r = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, np.nan, 0.01, 0.02, 0.05, 0.07, 0.1])

    def q1(k):
        return [pack.ValidCount(n, n - k), r.integers(1, 51, n), r.choice(pool, n),
                r.choice(pool, n).astype(np.float32), r.integers(0, 3, n).astype(np.int32),
                r.integers(8000, 10600, n).astype(np.int32), r.random(n) < 0.5,
                r.normal(size=n)]

    if case == "q1":
        return [q1(0), q1(7)]
    if case == "uint16 codes":
        # the first batch's sample decides for a dictionary (at most 200
        # distinct values); the second grows its table past 256 entries
        wide = np.round(r.uniform(0, 1000, 257), 2)
        return [[pack.ValidCount(n, n), r.choice(wide[:150], n),
                 r.choice(wide[:150], n).astype(np.float32)],
                [pack.ValidCount(n, n), r.choice(wide, n), r.choice(wide, n).astype(np.float32)]]
    if case == "widen then degrade":
        few = r.choice(pool, n)
        mid = r.choice(np.round(r.uniform(0, 1, 300), 3), n)
        return [[pack.ValidCount(n, n), r.integers(0, 200, n), few],
                [pack.ValidCount(n, n), r.integers(-5000, 5000, n), mid],
                [pack.ValidCount(n, n), r.integers(-2**40, 2**40, n), r.normal(size=n)],
                [pack.ValidCount(n, n), r.integers(0, 200, n), few]]
    if case == "all pass":
        return [[pack.ValidCount(n, n - 1), r.integers(-2**40, 2**40, n), r.normal(size=n),
                 r.integers(0, 9, 100), r.normal(size=(n, 3))]]
    if case == "empty":
        return [[pack.ValidCount(n, 0), np.zeros(n, dtype=np.int64), np.zeros(n),
                 np.zeros(n, dtype=bool)]]
    raise ValueError(case)


@pytest.mark.parametrize("case,n", [("q1", 1 << 20), ("uint16 codes", 1 << 16),
                                    ("widen then degrade", 1 << 14), ("all pass", 1 << 13),
                                    ("empty", 256), ("q1", 4096)])
def test_k23_kernel_matches_plain(cuda_device, case, n):
    pack._PLANS.clear()
    for leaves in _k23_batches(case, n, seed=23):
        wires, layout = pack._encode(leaves)
        st = pack.stage(layout, wires, cuda_device)
        got = [t.clone() for t in pack.decode_launch(st)]
        exp = pack.decode_plain(layout, st.wires)
        torch.cuda.synchronize()
        for leaf, g, e in zip(leaves, got, exp):
            assert g.dtype == e.dtype and g.shape == e.shape, (case, layout)
            assert torch.equal(_bits(g), _bits(e)), (case, layout)
            if isinstance(leaf, pack.ValidCount):
                want = torch.arange(leaf.padded) < leaf.nrows
            else:
                want = torch.from_numpy(np.ascontiguousarray(leaf))
            assert torch.equal(_bits(g.cpu()), _bits(want)), (case, layout)


def test_k23_lands_batches_as_the_cpu_does(cuda_device):
    pack._PLANS.clear()
    before = pack.LAUNCHES
    for n in (5000, 70_000):
        t = host_table(n, seed=n)
        cuda_cols = bridge.device_to_host(bridge.host_to_device(t, cuda_device))
        cpu_cols = bridge.device_to_host(bridge.host_to_device(t, "cpu"))
        for name, a in cpu_cols.items():
            b = cuda_cols[name]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype.kind in "fM":  # bit for bit: NaN and NaT too
                assert (a.view(np.int64) == b.view(np.int64)).all(), name
            else:
                assert (a == b).all(), name
    assert pack.LAUNCHES == before + 2


def _bits(t):
    """A tensor's raw bits, so NaN and -0.0 compare."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32) \
        if t.is_floating_point() else t


@pytest.mark.parametrize("case", ["mixed", "all_invalid", "one_bucket", "float_limbs",
                                  "wide"])
@pytest.mark.parametrize("n_parts", [1, 2, 8, 64])
def test_k24_kernel_matches_plain(cuda_device, n_parts, case):
    r = np.random.default_rng(24 + n_parts)
    n = (1 << 17) if case == "wide" else 4096 + 512
    total = n_parts * n
    k0 = r.integers(-5, 1000, total).astype(np.int32)
    k1 = r.integers(-2**40, 2**40, total)
    valid = np.zeros(total, dtype=bool) if case == "all_invalid" else r.random(total) < 0.8
    if case == "one_bucket":
        k0[:] = 3
        k1[:] = 11
    cols = [k0, k1, r.normal(size=total), r.normal(size=total).astype(np.float32),
            r.random(total) < 0.5, r.integers(0, 255, total).astype(np.uint8)]
    if case == "float_limbs":
        cols[2] = r.choice(np.array([0.0, -0.0, np.nan, 2.5, -3.7, 1e12, -1e12]), total)
    key_idx = (0, 2) if case == "float_limbs" else (0, 1)
    t = [torch.from_numpy(c).to(cuda_device) for c in cols]
    v = torch.from_numpy(valid).to(cuda_device)
    got, gv = kernels.mesh_bucketize(t, v, key_idx, n_parts)
    exp, ev = kernels.mesh_bucketize_plain(t, v, key_idx, n_parts)
    torch.cuda.synchronize()
    assert torch.equal(gv, ev)
    for a, b in zip(got, exp):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("case", ["unique", "duplicates", "no_matches", "all_invalid",
                                  "invalid_build_ranks", "duplicates_beside_invalid"])
def test_k14_kernel_matches_plain(cuda_device, case):
    """Unique, duplicate and unmatched build keys, every row invalid; ranks
    whose build rows are all invalid (their probe rows must not match); and
    duplicate valid build rows beside invalid ones of the same key (the
    least valid row is the match, not the least row)."""
    r = np.random.default_rng(14)
    p, b = 70_001, 30_017
    keys = r.integers(0, 50_000, p + b)
    if case in ("unique", "invalid_build_ranks"):
        keys[p:] = r.permutation(60_000)[:b]
    elif case == "no_matches":
        keys[p:] = r.integers(100_000, 200_000, b)
    elif case == "duplicates_beside_invalid":
        keys[p:] = r.integers(0, 5_000, b)
    valid = np.zeros(p + b, dtype=bool) if case == "all_invalid" else r.random(p + b) < 0.9
    if case == "invalid_build_ranks":
        valid[p:][keys[p:] % 3 == 0] = False
    elif case == "duplicates_beside_invalid":
        valid[p:] = r.random(b) < 0.5
    limbs = [torch.from_numpy(keys).to(cuda_device)]
    v = torch.from_numpy(valid).to(cuda_device)
    ranks, _ = kernels.dense_rank(limbs, v)
    got = join.pk_match_ranks(ranks, v, p)
    exp = join._pk_match_plain(ranks, v, p)
    torch.cuda.synchronize()
    for a, e in zip(got, exp):
        assert a.dtype == e.dtype and torch.equal(a, e)
    if case == "invalid_build_ranks":
        # probe rows whose key has only invalid build rows exist, and none matches
        pk, bk = keys[:p], keys[p:]
        dead = np.isin(pk, bk[keys[p:] % 3 == 0]) & valid[:p]
        assert dead.any() and not got[1].cpu().numpy()[dead].any()
    if case == "duplicates_beside_invalid":
        assert int(got[1].sum()) > 0


# K8, the compact-concat: each case is a list of parts, (rows, live share)
K8_CASES = {
    "lengths_not_multiples_of_4096": [(5000, 0.7), (256, 0.5), (12_289, 0.9), (70_001, 0.3)],
    "one_part_of_2^24_rows": [(1 << 24, 0.6), (4096, 0.5)],
    "more_columns_than_the_cap": [(30_000, 0.6), (70_000, 0.4)],
    "mixed_dtypes_across_parts": [(30_000, 0.6), (70_000, 0.4), (5, 1.0)],
    "strided_sources": [(30_000, 0.6), (70_000, 0.4)],
    "empty_and_all_invalid_parts": [(0, 0.5), (3000, 0.0), (90_000, 0.6), (4096, 0.0)],
    "one_live_row": [(4096, 0.0), (70_000, 0.0)],
    "fully_live_total_a_bucket": [(1 << 15, 1.0), (1 << 15, 1.0)],
    "forty_parts_some_empty": [((i * 997) % 6000 if i % 7 else 0, 0.6) for i in range(40)],
}


def _k8_part(r, m, dens, case, i, dev):
    """One part: int64, float64 with NaN, int32, date, timestamp (ms), bool,
    float32, a string column (null code -1, its own dictionary order) and a
    3-wide and a 2-wide vector column; the 2^24-row part keeps three."""
    valid = torch.from_numpy(r.random(m) < dens)
    f = r.normal(size=m)
    f[r.random(m) < 0.1] = np.nan
    cols = {"i": NumCol(torch.from_numpy(r.integers(-10**12, 10**12, m)), "i"),
            "f": NumCol(torch.from_numpy(f), "f"),
            "b": NumCol(torch.from_numpy(r.random(m) < 0.5), "b")}
    if case != "one_part_of_2^24_rows":
        cols.update(
            n=NumCol(torch.from_numpy(r.integers(-100, 100, m).astype(np.int32)), "i"),
            d=NumCol(torch.from_numpy(r.integers(0, 20_000, m).astype(np.int32)), "d"),
            t=NumCol(torch.from_numpy(r.integers(0, 10**13, m)), "t", "ms"),
            h=NumCol(torch.from_numpy(r.normal(size=m).astype(np.float32)), "f"),
            s=StrCol(torch.from_numpy(r.integers(-1, 3, m).astype(np.int32)),
                     StringDict(np.array(["x", "y", "z"], dtype=object)[r.permutation(3)])),
            v=VecCol(torch.from_numpy(r.normal(size=(m, 3)))),
            w=VecCol(torch.from_numpy(r.normal(size=(m, 2)))))
    if case == "more_columns_than_the_cap":
        for j in range(bridge.CONCAT_MAX_COLUMNS + 3):
            cols[f"x{j}"] = NumCol(torch.from_numpy(r.integers(0, 1000, m).astype(np.int16)), "i")
    if case == "mixed_dtypes_across_parts" and i == 0:
        cols["i"] = NumCol(cols["i"].data.to(torch.int32), "i")
        cols["h"] = NumCol(cols["h"].data.double(), "f")
    cols = {k: (StrCol(c.codes.to(dev), c.dictionary) if isinstance(c, StrCol)
                else VecCol(c.data.to(dev)) if isinstance(c, VecCol)
                else NumCol(c.data.to(dev), c.kind, c.unit)) for k, c in cols.items()}
    if case == "strided_sources":
        cols["i"] = NumCol(_strided(cols["i"].data), "i")
        cols["v"] = VecCol(torch.stack([cols["v"].data] * 2, 0)[1])  # contiguous, but a view
        valid = _strided(valid.to(dev))
    if case == "one_live_row" and i == 1:
        valid[54_321] = True
    valid = valid.to(dev)
    return DeviceBatch(cols, valid, int(valid.sum()))


def _same_batch(a, b) -> bool:
    """Bit for bit: nrows, validity, column order, kinds, units, dtypes and
    every padded row (floats compared as their bits)."""
    def bits(t):
        return t.view({8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[
            t.element_size()]) if t.is_floating_point() else t

    if a.nrows != b.nrows or not torch.equal(a.valid, b.valid) or list(a.columns) != list(b.columns):
        return False
    for name, x in a.columns.items():
        y = b.columns[name]
        tx, ty = (x.codes, y.codes) if isinstance(x, StrCol) else (x.data, y.data)
        if type(x) is not type(y) or tx.dtype != ty.dtype or tx.shape != ty.shape:
            return False
        if isinstance(x, NumCol) and (x.kind, x.unit) != (y.kind, y.unit):
            return False
        if isinstance(x, StrCol) and list(x.dictionary.values) != list(y.dictionary.values):
            return False
        if not torch.equal(bits(tx), bits(ty)):
            return False
    return True


@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_kernel_matches_plain(cuda_device, case):
    """K8 through ``concat_batches`` against its plain version on the same
    remapped parts, bit for bit, in one launch a ``CONCAT_MAX_COLUMNS``
    columns; the tail past the live rows is zero."""
    r = np.random.default_rng(8)
    parts = [_k8_part(r, m, dens, case, i, cuda_device)
             for i, (m, dens) in enumerate(K8_CASES[case])]
    per_col, dicts = bridge._concat_parts(parts)
    total = sum(b.nrows for b in parts)
    padded = config.bucket_size(total)
    before = bridge.CONCAT_LAUNCHES
    got = bridge.concat_batches(parts)
    launches = bridge.CONCAT_LAUNCHES - before
    want = bridge.compact_concat_plain(parts, per_col, dicts, total, padded)
    torch.cuda.synchronize()
    assert launches == -(-len(per_col) // bridge.CONCAT_MAX_COLUMNS)
    assert _same_batch(got, want)
    if case == "fully_live_total_a_bucket":
        assert total == padded
    for c in got.columns.values():
        t = c.codes if isinstance(c, StrCol) else c.data
        assert not t[total:].view(torch.uint8).any()


def test_k8_same_bits_every_run(cuda_device):
    r = np.random.default_rng(88)
    parts = [_k8_part(r, m, 0.5, "lengths_not_multiples_of_4096", i, cuda_device)
             for i, m in enumerate((70_001, 3, 129_000))]
    a, b = bridge.concat_batches(parts), bridge.concat_batches(parts)
    torch.cuda.synchronize()
    assert _same_batch(a, b)


def _k10_case(r, case, dev):
    """(limbs, valid, probe rows) of one K10 / K13p case."""
    n = {"rows_2^21_plus_2^16": (1 << 21) + (1 << 16), "rows_100003": 100_003}.get(case, 70_001)
    valid = r.random(n) < 0.9
    keys = r.integers(0, max(n // 8, 1), n).astype(np.int64)
    p = n // 3
    if case == "float64_neg_zero_nan":
        f = r.integers(-4, 4, n).astype(np.float64)
        u = r.random(n)
        f[u < 0.1] = np.nan
        f[(u >= 0.1) & (u < 0.3)] = -0.0
        limbs = [torch.from_numpy(f)]
    elif case == "two_int64_limbs":
        limbs = [torch.from_numpy(keys), torch.from_numpy(r.integers(0, 4, n).astype(np.int64))]
    elif case == "int32_float32_bool":
        limbs = [torch.from_numpy((keys % 97).astype(np.int32)),
                 torch.from_numpy(r.integers(0, 3, n).astype(np.float32)),
                 torch.from_numpy(r.random(n) < 0.5)]
    elif case == "all_invalid":
        valid[:] = False
        limbs = [torch.from_numpy(keys)]
    elif case == "no_valid_build_row":
        valid[p:] = False
        limbs = [torch.from_numpy(keys)]
    elif case == "one_key_x_10^4_build_rows":
        keys[p:p + 10_000] = -1
        keys[:100] = -1
        limbs = [torch.from_numpy(keys)]
    else:
        limbs = [torch.from_numpy(keys)]
    return [l.to(dev) for l in limbs], torch.from_numpy(valid).to(dev), p


K10_CASES = ["rows_2^21_plus_2^16", "rows_100003", "float64_neg_zero_nan", "two_int64_limbs",
             "int32_float32_bool", "all_invalid", "no_valid_build_row",
             "one_key_x_10^4_build_rows"]


def _same_bits(got, want):
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x.reshape(-1), y.reshape(-1))


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_kernel_matches_plain(cuda_device, case):
    """K10's ranks and num against the plain dense rank, bit for bit, invalid
    rows included; one launch a call."""
    limbs, valid, _ = _k10_case(np.random.default_rng(10), case, cuda_device)
    before = (kernels.RANK_LAUNCHES, kernels.SORT_LAUNCHES)
    got = kernels.dense_rank(limbs, valid)
    assert (kernels.RANK_LAUNCHES, kernels.SORT_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _same_bits(got, kernels.dense_rank_plain(limbs, valid))


@pytest.mark.parametrize("case", K10_CASES)
def test_k13p_plan_matches_plain(cuda_device, case):
    """K13p's match counts, total, offsets (every rank), build positions
    (the invalid tail included) and probe ranks against the plain plan, bit
    for bit, with one sort a plan; the counts-only mode gives the same match
    counts."""
    limbs, valid, p = _k10_case(np.random.default_rng(13), case, cuda_device)
    sorts = []
    real, real_sort = kernels.lexsort_perm, torch.sort

    def counted(keys):
        sorts.append(len(keys))
        return real(keys)

    def counted_sort(*a, **k):
        sorts.append("torch.sort")
        return real_sort(*a, **k)

    kernels.lexsort_perm, torch.sort = counted, counted_sort
    try:
        before = (kernels.RANK_LAUNCHES, join.MM_PLAN_LAUNCHES, kernels.SORT_LAUNCHES)
        got = join._mm_plan(limbs, valid, p)
        counts = join._mm_counts(limbs, valid, p)
    finally:
        kernels.lexsort_perm, torch.sort = real, real_sort
    assert (kernels.RANK_LAUNCHES, join.MM_PLAN_LAUNCHES, kernels.SORT_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    assert sorts == []
    want = join._mm_plan_plain(limbs, valid, p)
    _same_bits(got, want)
    _same_bits((counts,), want[:1])


def test_k10_k13p_strided_inputs_match_plain(cuda_device):
    """Strided limbs and validity: the wrappers' contiguous copies live until
    their launches."""
    r = np.random.default_rng(1013)
    n = 200_003
    wide = torch.from_numpy(r.integers(0, 5000, (n, 2)).astype(np.int64)).to(cuda_device)
    vwide = torch.from_numpy(r.random((n, 2)) < 0.8).to(cuda_device)
    limbs, valid, p = [wide[:, 0], wide[:, 1]], vwide[:, 1], n // 5
    _same_bits(kernels.dense_rank(limbs, valid), kernels.dense_rank_plain(limbs, valid))
    _same_bits(join._mm_plan(limbs, valid, p), join._mm_plan_plain(limbs, valid, p))
    _same_bits((join._mm_counts(limbs, valid, p),), join._mm_plan_plain(limbs, valid, p)[:1])


def test_k10_same_bits_every_run(cuda_device):
    limbs, valid, p = _k10_case(np.random.default_rng(110), "two_int64_limbs", cuda_device)
    _same_bits(kernels.dense_rank(limbs, valid), kernels.dense_rank(limbs, valid))
    _same_bits(join._mm_plan(limbs, valid, p), join._mm_plan(limbs, valid, p))


def _sort_case(r, case, dev):
    """(limbs, valid) of one case of the radix sort under K10 and K13p."""
    n = {"n_1": 1, "n_4097": 4097, "rows_2^24_plus_3": (1 << 24) + 3}.get(case, 50_003)
    valid = r.random(n) < 0.85
    i64 = lambda lo, hi: r.integers(lo, hi, n, dtype=np.int64, endpoint=True)
    if case == "int64_full_range":
        x = i64(-(2**63), 2**63 - 1)
        x[:2] = [-(2**63), 2**63 - 1]
        valid[:2] = True
        limbs = [x]
    elif case == "two_int64_over_one_word":
        limbs = [i64(-(2**40), 2**40), i64(0, 2**30)]
    elif case == "two_int32_hash_limbs":
        limbs = [r.integers(-(2**31), 2**31, n).astype(np.int32),
                 r.integers(-(2**31), 2**31, n).astype(np.int32)]
    elif case == "bool_limbs":
        limbs = [r.random(n) < 0.5, r.random(n) < 0.3, i64(0, 3)]
    elif case == "float64_neg_zero_nan":
        f = r.integers(-4, 4, n).astype(np.float64)
        u = r.random(n)
        f[u < 0.1] = np.nan
        f[(u >= 0.1) & (u < 0.3)] = -0.0
        limbs = [f, f.astype(np.float32)]
    elif case == "all_invalid":
        valid[:] = False
        limbs = [i64(0, 100)]
    elif case == "one_key":
        limbs = [np.full(n, 7, dtype=np.int64)]
    else:
        limbs = [i64(0, 6_000_000), i64(1, 10_000)]  # TPC-H's order and supplier keys
    return [torch.from_numpy(np.asarray(l)).to(dev) for l in limbs], torch.from_numpy(valid).to(dev)


SORT_CASES = ["int64_full_range", "two_int64_over_one_word", "two_int32_hash_limbs", "bool_limbs",
              "float64_neg_zero_nan", "all_invalid", "one_key", "n_1", "n_4097",
              "rows_2^24_plus_3"]


@pytest.mark.parametrize("case", SORT_CASES)
def test_radix_sort_matches_plain(cuda_device, case):
    """The radix sort's permutation against its plain version, index for
    index: the valid prefix is _sort_perm's, the invalid rows follow in row
    order; one launch a call, and K10 and K13p on it bit for bit."""
    limbs, valid = _sort_case(np.random.default_rng(17), case, cuda_device)
    before = kernels.SORT_LAUNCHES
    got = kernels.sort_perm(limbs, valid)
    assert kernels.SORT_LAUNCHES == before + 1
    want = kernels.sort_perm_plain(limbs, valid)
    _same_bits((got,), (want,))
    nv = int(valid.sum())
    _same_bits((got[:nv],), (kernels._sort_perm(limbs, valid)[:nv],))
    if valid.shape[0] < 1 << 20:
        p = valid.shape[0] // 3
        _same_bits(kernels.dense_rank(limbs, valid), kernels.dense_rank_plain(limbs, valid))
        _same_bits(join._mm_plan(limbs, valid, p), join._mm_plan_plain(limbs, valid, p))


def test_radix_sort_strided_inputs_match_plain(cuda_device):
    """Strided limbs and validity: the contiguous copies live until the launch."""
    r = np.random.default_rng(1017)
    n = 120_007
    wide = torch.from_numpy(r.integers(-(2**40), 2**40, (n, 2)).astype(np.int64)).to(cuda_device)
    vwide = torch.from_numpy(r.random((n, 3)) < 0.7).to(cuda_device)
    limbs, valid = [wide[:, 1], wide[:, 0]], vwide[:, 2]
    _same_bits((kernels.sort_perm(limbs, valid),), (kernels.sort_perm_plain(limbs, valid),))


def test_radix_sort_same_bits_every_run(cuda_device):
    limbs, valid = _sort_case(np.random.default_rng(217), "two_int64_over_one_word", cuda_device)
    first = kernels.sort_perm(limbs, valid)
    for _ in range(3):
        _same_bits((kernels.sort_perm(limbs, valid),), (first,))
