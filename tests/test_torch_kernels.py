"""The PyTorch port's kernel modules against the reference (quokka_tpu, JAX
x64 on the CPU), on identical inputs made from a numpy seed.

K1 fused predicate, K2 small-key partial aggregate, K3 hash group-by, K4
hash partition + split.  Here the port runs each kernel's plain torch
version (the tensors lie on the CPU); tests/test_torch_cuda.py holds the
hand-written kernels against those plain versions on a card.

Tolerances: masks, keys, counts and integer sums exact; float sums rtol
1e-9 (another summation order); K3 compares after a sort on the keys,
since its group order is claim order.
"""

import ast

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from quokka_tpu import sqlparse as ref_sqlparse
from quokka_tpu.ops import fuse as ref_fuse
from quokka_tpu.ops import hashtable as ref_hashtable
from quokka_tpu.ops import kernels as ref_kernels
from quokka_tpu.ops.expr_compile import plan_aggregation as ref_plan
from quokka_tpu_torch import sqlparse
from quokka_tpu_torch.ops import fuse, hashtable, kernels
from quokka_tpu_torch.ops.expr_compile import plan_aggregation

from torch_port_util import fresh_aot, mixed_table, port_batch, ref_batch_of  # noqa: F401


# ---------------------------------------------------------------------------
# K1: fused predicate
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("sql", PREDICATES)
@pytest.mark.parametrize("n", [0, 700, 3000])
def test_k1_predicate_matches_reference(sql, n, fresh_aot):
    t = mixed_table(n, seed=n + len(sql))
    ref_b = ref_batch_of(t)
    b = port_batch(ref_b)
    ref_out = ref_fuse.FusedPredicate(ref_sqlparse.parse_expression(sql))(ref_b)
    pred = fuse.FusedPredicate(sqlparse.parse_expression(sql))
    before = fuse.FALLBACKS
    out = pred(b)
    assert fuse.FALLBACKS == before, "predicate left the generator's subset"
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref_out.valid))
    assert out.count_valid() == ref_out.count_valid()
    # the generated kernel is well-formed Python (Triton parses it the same way)
    _, kern, _ = pred.prepare(b)
    ast.parse(kern.src)


def test_k1_outside_subset_takes_the_unfused_path():
    t = mixed_table(500, seed=3)
    b = port_batch(ref_batch_of(t))
    pred = fuse.FusedPredicate(sqlparse.parse_expression("extract(year from d) = 1995"))
    before = fuse.FALLBACKS
    out = pred(b)
    assert fuse.FALLBACKS == before + 1
    years = pd.to_datetime(t.column("d").to_pandas()).dt.year.to_numpy()
    assert out.count_valid() == int((years == 1995).sum())


# ---------------------------------------------------------------------------
# K2: small-key partial aggregate
# ---------------------------------------------------------------------------

AGGS = ("sum(g) as sg, count(*) as n, count(g) as ng, avg(f) as af, "
        "sum(g * (1 - f) * (1 + g)) as sx, sum(i) as si")


def _with_wide_key(t, seed: int, nulls: bool):
    """t with a string column "k" of 100 dictionary values (and nulls)."""
    r = np.random.default_rng(seed)
    syms = np.array([f"sym{j:03d}" for j in range(100)], dtype=object)
    vals = syms[r.integers(0, 100, t.num_rows)]
    if nulls:
        vals[r.random(t.num_rows) < 0.05] = None
    return t.append_column("k", pa.array(vals.tolist(), type=pa.string()))


@pytest.mark.parametrize("n,nulls,wide", [(0, False, False), (900, False, False),
                                          (4000, True, False), (5000, True, True)],
                         ids=["0-False", "900-False", "4000-True", "5000-True-129buckets"])
def test_k2_small_agg_matches_reference_and_pandas(n, nulls, wide, fresh_aot):
    """Q1-shaped keys (4 x 2 values, 17 buckets) and, in the last case, one
    key of 100 values (128 groups and the dump bucket, the tick paths'
    shape): the reference's CPU strategy row is hashtable, so it runs
    ``_build_small_scatter``."""
    t = mixed_table(n, seed=11 + n, nulls=nulls)
    keys = ["s", "t"]
    if wide:
        t = _with_wide_key(t, seed=n, nulls=nulls)
        keys = ["k"]
    ref_b = ref_batch_of(t)
    ref_out = ref_fuse.FusedPartialAgg(keys, ref_plan(ref_sqlparse.parse_select_list(AGGS)))(ref_b)
    plan = plan_aggregation(sqlparse.parse_select_list(AGGS))
    agg = fuse.FusedPartialAgg(keys, plan)
    b = port_batch(ref_b)
    call = agg.prepare_small(b)
    assert call is not None, "dictionary keys of at most 256 buckets take the small-key path"
    if wide:
        assert call.n_groups + 1 == 129  # 100 values and a null slot, to 128, and the dump
    out = agg(b)
    num = out.count_valid()
    assert num == ref_out.count_valid()
    assert out.padded_len == ref_out.padded_len == 256
    # same bucket scheme: rows line up index for index
    for k in keys:
        rc = ref_out.columns[k]
        assert _decode(out.columns[k], num) == _decode(rc, num)
    for pname, _op, _tmp in plan.partials:
        got = out.columns[pname].data.numpy()[:num]
        exp = np.asarray(ref_out.columns[pname].data)[:num]
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, exp)
    # and the pandas oracle, on the partial columns that map to plain sums
    df = t.to_pandas()
    g = df.groupby(keys, dropna=False)
    ora = pd.DataFrame({"n": g.size(), "sg": g.g.sum(), "ng": g.g.count(),
                        "si": g.i.sum()}).reset_index()
    names = {plan.finals[i][0]: plan.finals[i][1] for i in range(len(plan.finals))}
    got_df = pd.DataFrame({k: _decode(out.columns[k], num) for k in keys})
    for col in ("n", "sg", "ng", "si"):
        got_df[col] = out.columns[names[col].name].data.numpy()[:num]
    got_df = got_df.sort_values(keys, na_position="first").reset_index(drop=True)
    ora = ora.sort_values(keys, na_position="first").reset_index(drop=True)
    assert len(got_df) == len(ora)
    for col in ("n", "ng", "si"):
        np.testing.assert_array_equal(got_df[col].to_numpy(), ora[col].to_numpy())
    np.testing.assert_allclose(got_df.sg.to_numpy(), ora.sg.to_numpy(), rtol=1e-9)


def _decode(strcol, num):
    """The first num rows of a string column of either package as values
    (code -1 is null)."""
    codes = np.asarray(strcol.codes)[:num]
    vals = strcol.dictionary.values
    return [vals[c] if c >= 0 else None for c in codes]


def test_k2_kernel_source_is_wellformed():
    """K2's plan: plain columns go to the bucket core as they lie; the
    Q1-shaped plan generates one well-formed pre-pass whose outputs are only
    its expression inputs, reading only the columns they name; a plan of
    plain columns and count(*) generates none."""
    t = mixed_table(300, seed=5)
    b = port_batch(ref_batch_of(t))
    plan = plan_aggregation(sqlparse.parse_select_list(AGGS))
    call = fuse.FusedPartialAgg(["s", "t"], plan).prepare_small(b)
    kern = call.kern
    tree = ast.parse(kern.pre.src)
    assert [f.name for f in tree.body] == ["qk_small_pre"]
    exprs = [tmp for _, op, tmp in plan.partials
             if op != "count" and fuse._plain_column(call.pre_exprs[tmp], call.inputs) is None]
    assert exprs and kern.pre_outs == list(dict.fromkeys(exprs))
    stores = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
              and ast.unparse(n.func) == "tl.store"]
    assert len(stores) == len(kern.pre_outs)
    needed = set().union(*(call.pre_exprs[tmp].required_columns() for tmp in exprs))
    assert set(kern.pre_inputs) == needed & set(call.inputs)
    # every partial has a slot: a count, or a float / int column of the core
    assert len(kern.slots) == len(plan.partials)
    assert {s[0] for s in kern.slots} == {"c", "f", "i"}
    plain = [fuse._plain_column(call.pre_exprs[tmp], call.inputs) for _, op, tmp in plan.partials
             if op != "count"]
    tag, wrap = fuse._AGG_TAG, fuse._AGG_WRAP
    # sum(g), count(g) (avg(f)'s too) and sum(i) read their columns in place
    assert ("g", tag[torch.float64] | wrap["__nn0"]) in plain
    assert ("g", tag[torch.float64] | wrap["__nncount"]) in plain
    assert ("i", tag[torch.int64] | wrap["__nn0"]) in plain

    only = plan_aggregation(sqlparse.parse_select_list(
        "sum(g) as sg, sum(i) as si, count(*) as n"))
    call = fuse.FusedPartialAgg(["s", "t"], only).prepare_small(b)
    assert call.kern.pre is None and call.kern.pre_outs == []
    assert [src for src, _ in call.kern.cols] == [("col", "g"), ("col", "i")]


# ---------------------------------------------------------------------------
# K3: hash group-by
# ---------------------------------------------------------------------------

OPS = ("sum", "count", "min", "max", "mean", "first")


def _k3_inputs(n, seed, key_kind):
    r = np.random.default_rng(seed)
    valid = r.random(n) < 0.85
    if key_kind == "int64":
        keys = [r.integers(-(2**40), 2**40, 40)[r.integers(0, 40, n)]]
        keys[0][r.random(n) < 0.05] = -(2**63)  # null sentinel groups as a key
    elif key_kind == "float64":
        k = r.integers(-5, 5, n).astype(np.float64)
        k[r.random(n) < 0.1] = -0.0
        k[r.random(n) < 0.05] = np.nan  # each NaN row is its own group
        keys = [k]
    else:  # two string keys as hash limbs, as Q1 groups
        hi = r.integers(-(2**31), 2**31, 6).astype(np.int32)
        lo = r.integers(-(2**31), 2**31, 6).astype(np.int32)
        pick = r.integers(0, 6, n)
        keys = [hi[pick], lo[pick], (pick % 2).astype(np.int32)]
    fv = r.normal(size=n)
    fv[r.random(n) < 0.03] = np.nan
    iv = r.integers(-1000, 1000, n)
    return keys, [fv, iv], valid


@pytest.mark.parametrize("key_kind", ["int64", "float64", "strings"])
@pytest.mark.parametrize("value", [0, 1], ids=["float64", "int64"])
def test_k3_hash_groupby_matches_reference(key_kind, value, fresh_aot):
    n = 2048
    keys, vals, valid = _k3_inputs(n, seed=7 + value, key_kind=key_kind)
    arr = vals[value]
    ops = OPS if value == 0 else ("sum", "count", "min", "max", "first")
    r_outs, r_counts, r_rep, r_num = ref_hashtable.hash_groupby(
        tuple(jnp.asarray(k) for k in keys), tuple(jnp.asarray(arr) for _ in ops), ops,
        jnp.asarray(valid))
    p_outs, p_counts, p_rep, p_num = hashtable.hash_groupby(
        [torch.from_numpy(k) for k in keys], [torch.from_numpy(arr) for _ in ops], ops,
        torch.from_numpy(valid))
    num = int(r_num)
    assert int(p_num) == num

    def table(outs, counts, rep):
        rep = np.asarray(rep)[:num]
        cols = {f"k{j}": k[rep] for j, k in enumerate(keys)}
        cols["count"] = np.asarray(counts)[:num]
        for op, o in zip(ops, outs):
            cols[op] = np.asarray(o)[:num]
        df = pd.DataFrame(cols)
        # a NaN key's group is identified by its representative row
        df["rep"] = rep
        return df.sort_values([*(f"k{j}" for j in range(len(keys))), "rep"]).reset_index(drop=True)

    ref, got = table(r_outs, r_counts, r_rep), table(p_outs, p_counts, p_rep)
    for col in ref.columns:
        if ref[col].dtype.kind == "f":
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-9, atol=1e-12)
        else:
            np.testing.assert_array_equal(got[col].to_numpy(), ref[col].to_numpy())


def _adversarial_keys(case, n, r):
    if case == "all_nan":
        return [np.full(n, np.nan)]
    if case == "all_equal":
        return [np.full(n, 7, dtype=np.int64)]
    if case == "all_distinct":
        return [r.permutation(n).astype(np.int64)]
    # keys that agree in their low 32 bits: they differ only in the high word
    return [(r.permutation(n).astype(np.int64) << 32) | 12345]


@pytest.mark.parametrize("case", ["all_nan", "all_equal", "all_distinct", "low_bits"])
def test_k3_plain_insert_converges_at_its_capacity(case, fresh_aot):
    """At capbits_for(n) (cap >= 2n) the insert places every live row: the
    plain version never answers None on adversarial keys (every row NaN,
    one key, every key distinct, 2^12 keys sharing their low 32 bits), and
    its groups match the reference's hash_groupby."""
    n = 1 << 12
    r = np.random.default_rng(len(case))
    keys = _adversarial_keys(case, n, r)
    valid = r.random(n) < 0.9
    vals = r.normal(size=n)
    ops = ("sum", "count", "min", "first")
    got = hashtable.hash_groupby_plain([torch.from_numpy(k) for k in keys],
                                       [torch.from_numpy(vals) for _ in ops], ops,
                                       torch.from_numpy(valid))
    assert got is not None
    r_outs, r_counts, r_rep, r_num = ref_hashtable.hash_groupby(
        tuple(jnp.asarray(k) for k in keys), tuple(jnp.asarray(vals) for _ in ops), ops,
        jnp.asarray(valid))
    p_outs, p_counts, p_rep, p_num = got
    num = int(r_num)
    assert int(p_num) == num
    # every group is identified by its representative row (NaN keys too)
    ro = np.argsort(np.asarray(r_rep)[:num])
    po = np.argsort(p_rep.numpy()[:num])
    np.testing.assert_array_equal(p_rep.numpy()[:num][po], np.asarray(r_rep)[:num][ro])
    np.testing.assert_array_equal(p_counts.numpy()[:num][po], np.asarray(r_counts)[:num][ro])
    for op, a, b in zip(ops, p_outs, r_outs):
        a, b = a.numpy()[:num][po], np.asarray(b)[:num][ro]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=op)
        else:
            np.testing.assert_array_equal(a, b, err_msg=op)


def test_k3_nonconvergence_raises(monkeypatch):
    """An insert whose probe walk cannot place every row raises; it never
    aliases rows to slot 0.  The group-by itself now falls back to the sort
    group-by (test_k3_nonconvergence_falls_back_to_the_sort_groupby): K3's
    plain version answers None, and the insert that raises is the PK
    build's, on which the join relies to take the sorted probe."""
    monkeypatch.setattr(hashtable, "capbits_for", lambda n: 1)  # 2 slots
    limbs = [torch.arange(8, dtype=torch.int64)]
    ok = torch.ones(8, dtype=torch.bool)
    assert hashtable.hash_groupby_plain(limbs, [torch.ones(8)], ["sum"], ok) is None

    class _B:
        padded_len = 8

    with pytest.raises(hashtable.HashTableConvergenceError):
        hashtable.build_table(_B(), ["k"], lambda b, k: limbs, lambda: ok)


# ---------------------------------------------------------------------------
# K4: hash partition + split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keys", [["s", "t"], ["i"], ["f"], ["d", "b"], ["g", "s"]])
@pytest.mark.parametrize("n_parts", [2, 3, 7])
def test_k4_partition_ids_bit_identical(keys, n_parts, fresh_aot):
    t = mixed_table(1500, seed=n_parts)
    big = np.random.default_rng(1).uniform(-4e9, 4e9, 1500)  # saturating casts
    t = t.append_column("h", pa.array(big))
    if "f" in keys:
        keys = keys + ["h"]
    ref_b = ref_batch_of(t)
    b = port_batch(ref_b)
    ref_ids = np.asarray(ref_kernels.partition_ids(ref_b, keys, n_parts))
    ids = kernels.partition_ids(b, keys, n_parts)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    ref_parts = ref_kernels.split_by_partition(ref_b, jnp.asarray(ref_ids), n_parts,
                                               compact=False)
    for parts in (kernels.split_by_partition(b, ids, n_parts),
                  kernels.hash_split(b, keys, n_parts)):
        assert len(parts) == n_parts
        for p, rp in zip(parts, ref_parts):
            np.testing.assert_array_equal(p.valid.numpy(), np.asarray(rp.valid))
            assert p.count_valid() == rp.count_valid()


# ---------------------------------------------------------------------------
# K5: general partial aggregate (pre-expressions, then K3)
# ---------------------------------------------------------------------------

K5_AGGS = ("sum(g * (1 - f)) as sx, count(*) as n, count(g) as ng, min(i) as mi, "
           "max(g) as mg, avg(f + i) as af")


@pytest.mark.parametrize("keys", [[], ["i"], ["i", "d"], ["i", "d", "s"]],
                         ids=["no-key", "1-key", "2-keys", "3-keys"])
@pytest.mark.parametrize("n", [0, 2500])
def test_k5_general_partial_agg_matches_reference(keys, n, fresh_aot):
    t = mixed_table(n, seed=31 + n + len(keys))
    ref_b = ref_batch_of(t)
    ref_out = ref_fuse.FusedPartialAgg(keys, ref_plan(ref_sqlparse.parse_select_list(K5_AGGS)))(
        ref_b)
    plan = plan_aggregation(sqlparse.parse_select_list(K5_AGGS))
    agg = fuse.FusedPartialAgg(keys, plan)
    b = port_batch(ref_b)
    assert agg.prepare_small(b) is None, "int/date keys take the general path"
    out = agg(b)
    num = out.count_valid()
    assert num == ref_out.count_valid()

    def table(batch, cols):
        rows = {}
        for k in keys:
            c = batch.columns[k]
            rows[k] = (["<null>" if v is None else v for v in _decode(c, num)]
                       if hasattr(c, "codes") else np.asarray(c.data)[:num])
        for p, _op, _tmp in plan.partials:
            rows[p] = np.asarray(cols[p].data)[:num]
        df = pd.DataFrame(rows)
        return df.sort_values(keys).reset_index(drop=True) if keys else df

    got, ref = table(out, out.columns), table(ref_out, ref_out.columns)
    for c in ref.columns:
        if ref[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), ref[c].to_numpy(), rtol=1e-9,
                                       atol=1e-12)
        elif c in keys and isinstance(ref_b.columns[c], type(ref_b.columns["s"])):
            assert list(got[c]) == list(ref[c])
        else:
            np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy())


def test_k5_kernel_source_is_wellformed():
    t = mixed_table(300, seed=5)
    b = port_batch(ref_batch_of(t))
    plan = plan_aggregation(sqlparse.parse_select_list(K5_AGGS))
    call = fuse.FusedPartialAgg(["i", "d"], plan).prepare_general(b)
    tree = ast.parse(call.kern.src)
    assert [f.name for f in tree.body] == ["qk_pre_agg"]
    assert len(call.outs) == len({tmp for _, _, tmp in plan.partials if tmp is not None})
    # the plain version's dtypes are the kernel's output dtypes
    assert [x.dtype for x in call.plain()] == call.out_dtypes


# ---------------------------------------------------------------------------
# sort / top-k (rows 9 and 15: torch sorts)
# ---------------------------------------------------------------------------


def _ties_table(n, seed):
    """Few distinct values per column: many ties, nulls, -0.0 and NaN."""
    r = np.random.default_rng(seed)
    f = r.integers(-3, 3, n).astype(np.float64)
    f[r.random(n) < 0.1] = -0.0
    f[r.random(n) < 0.08] = np.nan
    s = np.array(["pear", "apple", "fig", "kiwi"], dtype=object)[r.integers(0, 4, n)]
    s[r.random(n) < 0.08] = None
    i = r.integers(-5, 5, n)
    return pa.table({
        "f": pa.array(f), "s": pa.array(s.tolist(), type=pa.string()),
        "i": pa.array([None if m else v for v, m in zip(i.tolist(), r.random(n) < 0.08)],
                      type=pa.int64()),
        "d": pa.array(r.integers(9000, 9004, n).astype(np.int32)).cast(pa.date32()),
        "row": pa.array(np.arange(n)),
    })


SORTS = [(["f"], [False]), (["f"], [True]), (["s", "i"], [False, True]),
         (["i", "s", "f"], [True, False, False]), (["d", "f"], [False, True])]


@pytest.mark.parametrize("by,desc", SORTS)
def test_sort_batch_and_top_k_match_reference(by, desc, fresh_aot):
    t = _ties_table(1500, seed=len(by) + sum(desc))
    ref_b = ref_batch_of(t)
    b = port_batch(ref_b)
    ref_s = ref_kernels.sort_batch(ref_b, by, desc)
    got_s = kernels.sort_batch(b, by, desc)
    n = got_s.count_valid()
    assert n == ref_s.count_valid() == 1500
    # a stable sort: the row ids come out in the same order, ties included
    np.testing.assert_array_equal(got_s.columns["row"].data.numpy()[:n],
                                  np.asarray(ref_s.columns["row"].data)[:n])
    ref_k = ref_kernels.top_k(ref_b, by, 37, desc)
    got_k = kernels.top_k(b, by, 37, desc)
    assert got_k.count_valid() == ref_k.count_valid() == 37
    np.testing.assert_array_equal(got_k.columns["row"].data.numpy()[:37],
                                  np.asarray(ref_k.columns["row"].data)[:37])
    assert _decode(got_k.columns["s"], 37) == _decode(ref_k.columns["s"], 37)


# ---------------------------------------------------------------------------
# row 10: dense rank and the sort group-by; K3's fallback to it
# ---------------------------------------------------------------------------


def _rank_limbs(kind, n, r):
    """Key limbs (numpy) with many repeats, of one kind."""
    if kind == "int64":
        return [r.integers(-(2**40), 2**40, 50)[r.integers(0, 50, n)]]
    if kind == "composite":
        return [r.integers(-3, 3, n).astype(np.int64), r.integers(0, 4, n).astype(np.int32)]
    if kind == "date":
        return [r.integers(-400, 400, n).astype(np.int32)]
    k = r.integers(-4, 4, n).astype(np.float64)
    k[r.random(n) < 0.1] = -0.0  # one rank with +0.0
    k[r.random(n) < 0.05] = np.nan  # every NaN row a rank of its own
    return [k]


@pytest.mark.parametrize("kind", ["int64", "composite", "date", "float64"])
def test_dense_rank_matches_reference(kind, fresh_aot):
    """Ranks row for row and the rank count, invalid rows included."""
    r = np.random.default_rng(len(kind))
    n = 3000
    limbs = _rank_limbs(kind, n, r)
    valid = r.random(n) < 0.9
    r_ranks, r_num = ref_kernels.dense_rank([jnp.asarray(x) for x in limbs], jnp.asarray(valid))
    ranks, num = kernels.dense_rank([torch.from_numpy(x) for x in limbs],
                                    torch.from_numpy(valid))
    assert int(num) == int(r_num) > 1
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(r_ranks))


@pytest.mark.parametrize("kind", ["int64", "composite", "float64"])
def test_sorted_groupby_matches_reference(kind, fresh_aot):
    """Outputs indexed by rank, which is key order in both packages."""
    r = np.random.default_rng(20 + len(kind))
    n = 2500
    limbs = _rank_limbs(kind, n, r)
    valid = r.random(n) < 0.9
    fv = r.normal(size=n)
    fv[r.random(n) < 0.03] = np.nan
    iv = r.integers(-1000, 1000, n)
    arrays = (fv, iv, fv, iv, fv, fv)
    ops = ("sum", "sum", "count", "min", "max", "mean")
    r_outs, r_counts, r_rep, r_num = ref_kernels.sorted_groupby(
        tuple(jnp.asarray(x) for x in limbs), tuple(jnp.asarray(a) for a in arrays), ops,
        jnp.asarray(valid))
    outs, counts, rep, num = kernels.sorted_groupby(
        [torch.from_numpy(x) for x in limbs], [torch.from_numpy(a) for a in arrays], ops,
        torch.from_numpy(valid))
    g = int(r_num)
    assert int(num) == g > 1
    np.testing.assert_array_equal(counts.numpy()[:g], np.asarray(r_counts)[:g])
    np.testing.assert_array_equal(rep.numpy()[:g], np.asarray(r_rep)[:g])
    for op, a, b in zip(ops, outs, r_outs):
        a, b = a.numpy()[:g], np.asarray(b)[:g]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=op)
        else:
            np.testing.assert_array_equal(a, b, err_msg=op)


def test_k3_nonconvergence_falls_back_to_the_sort_groupby(monkeypatch, fresh_aot):
    """A non-converged insert reruns the batch through the sort group-by and
    records it, as the reference's hash_groupby does: the reference's
    result under the same 2-slot table."""
    from quokka_tpu.ops import strategy as ref_strategy
    from quokka_tpu_torch.ops import strategy

    keys, vals, valid = _k3_inputs(600, seed=3, key_kind="int64")
    ops = ("sum", "count", "min", "first")
    monkeypatch.setattr(hashtable, "capbits_for", lambda n: 1)
    monkeypatch.setattr(ref_hashtable, "capbits_for", lambda n: 1)
    ref_strategy.reset_used()
    strategy.reset_used()
    r_outs, r_counts, r_rep, r_num = ref_hashtable.hash_groupby(
        tuple(jnp.asarray(k) for k in keys), tuple(jnp.asarray(vals[0]) for _ in ops), ops,
        jnp.asarray(valid))
    outs, counts, rep, num = hashtable.hash_groupby(
        [torch.from_numpy(k) for k in keys], [torch.from_numpy(vals[0]) for _ in ops], ops,
        torch.from_numpy(valid))
    assert strategy.used_snapshot()["groupby"] == "sort"
    assert ref_strategy.used_snapshot()["groupby"] == "sort"
    g = int(r_num)
    assert int(num) == g > 1
    np.testing.assert_array_equal(rep.numpy()[:g], np.asarray(r_rep)[:g])
    np.testing.assert_array_equal(counts.numpy()[:g], np.asarray(r_counts)[:g])
    for a, b in zip(outs, r_outs):
        np.testing.assert_allclose(a.numpy()[:g], np.asarray(b)[:g], rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# K16: in-stage filter / projection / map
# ---------------------------------------------------------------------------

STAGES = [
    [("filter", "g > 2 and s = 'ab'"), ("map", [("h", "g * (1 - f)"), ("y", "extract(year from d)")])],
    [("map", [("g", "g + i"), ("m", "extract(month from d)")]), ("filter", "g < 20 or t = 'x'"),
     ("project", ["g", "m", "s"])],
    [("filter", "not (f > 0.5) or i is null"), ("map", [("day", "extract(day from d)"),
                                                         ("c", "case when b then 1 else 0 end")])],
]


def _steps(pkg_sqlparse, stage):
    out = []
    for kind, payload in stage:
        if kind == "filter":
            out.append(("filter", pkg_sqlparse.parse_expression(payload)))
        elif kind == "map":
            out.append(("map", [(n, pkg_sqlparse.parse_expression(e)) for n, e in payload]))
        else:
            out.append((kind, payload))
    return out


@pytest.mark.parametrize("stage", range(len(STAGES)))
@pytest.mark.parametrize("n", [0, 2000])
def test_k16_fused_elementwise_matches_reference(stage, n, fresh_aot):
    """The port's FusedElementwise (K16's plain version here) against the
    reference's, on a table without null dates (the reference extracts a
    field from the null sentinel's day number; the port gives null)."""
    from quokka_tpu.ops.stagefuse import FusedElementwise as RefElemwise
    from quokka_tpu_torch.ops import stagefuse

    t = mixed_table(n, seed=stage, nulls=False)
    ref_b = ref_batch_of(t)
    b = port_batch(ref_b)
    seq = stagefuse.SEQUENTIAL
    got = stagefuse.FusedElementwise(_steps(sqlparse, STAGES[stage]))(b)
    assert stagefuse.SEQUENTIAL == seq, "the stage took the per-step path"
    ref = RefElemwise(_steps(ref_sqlparse, STAGES[stage]))(ref_b)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert got.count_valid() == ref.count_valid()
    assert list(got.columns) == list(ref.columns)
    for name, c in ref.columns.items():
        if hasattr(c, "codes"):
            np.testing.assert_array_equal(got.columns[name].codes.numpy()[valid],
                                          np.asarray(c.codes)[valid])
        else:
            np.testing.assert_array_equal(got.columns[name].data.numpy()[valid],
                                          np.asarray(c.data)[valid], err_msg=name)


def test_k16_kernel_source_and_extract_before_1970():
    """K16's generated source parses and names one kernel; its plain version
    gives numpy's civil dates for days before and after 1970, and null for
    a null date."""
    from quokka_tpu_torch.ops import stagefuse

    days = np.array([-719468, -25567, -366, -365, -1, 0, 59, 60, 10957, 11016, 2932896],
                    dtype=np.int32)
    t = pa.table({"d": pa.array(days.tolist() + [None], type=pa.int32()).cast(pa.date32())})
    b = port_batch(ref_batch_of(t))
    steps = [("map", [(f, sqlparse.parse_expression(f"extract({f} from d)"))
                      for f in ("year", "month", "day")])]
    fe = stagefuse.FusedElementwise(steps)
    call, kinds = fe.prepare(b)
    tree = ast.parse(call.kern.src)
    assert [f.name for f in tree.body] == ["qk_elemwise"]
    assert kinds == ["i", "i", "i"] and call.out_dtypes == [torch.int32] * 3
    out = fe(b)
    dt = days.astype("datetime64[D]")
    want = {"year": dt.astype("datetime64[Y]").astype(int) + 1970,
            "month": dt.astype("datetime64[M]").astype(int) % 12 + 1,
            "day": (dt - dt.astype("datetime64[M]")).astype(int) + 1}
    for f, w in want.items():
        got = out.columns[f].data.numpy()
        np.testing.assert_array_equal(got[:len(days)], w, err_msg=f)
        assert got[len(days)] == -(2**31), f"null date must give a null {f}"
