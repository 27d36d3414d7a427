"""The kernel-strategy rows the port now honours, against the reference
(quokka_tpu, JAX x64 on the CPU): ``groupby=sort``, whose small-key path is
the one-hot partial aggregate (K6, the reference's ``_build_small`` matmul)
and whose general path and final aggregate are the sort group-by (row 10).

K6's plain version lines up with the reference's output index for index:
counts, integer sums and each bucket's smallest row exact; float sums to
rtol 1e-9 (the reference sums by a float64 matmul, the port by a scatter:
another order).  Queries compare keys exactly and floats to rtol 1e-9 after
a sort.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quokka_tpu
import quokka_tpu_torch
import tpch_data
from quokka_tpu import sqlparse as ref_sqlparse
from quokka_tpu.ops import batch as ref_batch
from quokka_tpu.ops import fuse as ref_fuse
from quokka_tpu.ops.expr_compile import plan_aggregation as ref_plan
from quokka_tpu_torch import QuokkaContext, sqlparse
from quokka_tpu_torch.ops import batch, fuse, strategy
from quokka_tpu_torch.ops.expr_compile import plan_aggregation

from test_torch_q1 import q1
from test_torch_q1 import same as same_q1
from test_torch_q3q5 import q5, same_q5
from test_torch_q4q13q19q7 import q4, same_sorted
from torch_port_util import fresh_aot, mixed_table, port_batch, ref_batch_of  # noqa: F401

AGGS = ("sum(g) as sg, count(*) as n, count(g) as ng, avg(f) as af, "
        "sum(g * (1 - f) * (1 + g)) as sx, sum(i) as si")
KEYS = ["s", "t"]


def _decode(col, num):
    codes = np.asarray(col.codes)[:num]
    vals = col.dictionary.values
    return [None if c < 0 else vals[c] for c in codes]


@pytest.fixture
def onehot_calls(monkeypatch):
    """The K6 calls a run makes (the plain version runs on the CPU)."""
    calls = []
    real = fuse.onehot_agg

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, out))
        return out

    monkeypatch.setattr(fuse, "onehot_agg", counted)
    return calls


@pytest.mark.parametrize("n,nulls", [(0, False), (900, False), (4000, True)])
def test_k6_matches_reference_index_for_index(n, nulls, monkeypatch, onehot_calls, fresh_aot):
    """A Q1-shaped partial aggregate (two dictionary keys with nulls, float,
    integer and count partials) under groupby=sort: the port's one-hot path
    against the reference's matmul path, row for row."""
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    t = mixed_table(n, seed=31 + n, nulls=nulls)
    ref_b = ref_batch_of(t)
    ref_out = ref_fuse.FusedPartialAgg(KEYS, ref_plan(ref_sqlparse.parse_select_list(AGGS)))(
        ref_b)
    plan = plan_aggregation(sqlparse.parse_select_list(AGGS))
    b = port_batch(ref_b)
    strategy.reset_used()
    out = fuse.FusedPartialAgg(KEYS, plan)(b)
    assert len(onehot_calls) == 1, "the batch must take the one-hot path"
    assert strategy.used_snapshot()["groupby"] == "sort"
    num = out.count_valid()
    assert num == ref_out.count_valid()
    assert out.padded_len == ref_out.padded_len == 256
    for k in KEYS:  # the keys gathered at each bucket's smallest row
        assert _decode(out.columns[k], num) == _decode(ref_out.columns[k], num)
    for pname, op, _tmp in plan.partials:
        got = out.columns[pname].data.numpy()[:num]
        exp = np.asarray(ref_out.columns[pname].data)[:num]
        assert got.dtype == exp.dtype, (pname, op)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-12)
        else:
            np.testing.assert_array_equal(got, exp)
    assert out.columns[plan.partials[1][0]].data.dtype == torch.int32  # count(*)


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_k6_plain_matches_a_numpy_oracle(n_keys):
    """Per bucket: float64 sums, exact int64 sums, counts and the smallest
    row, with null codes in slot 0 and invalid rows (NaN payloads) nowhere;
    the columns come tagged as K6 takes them (float64, int64, plain)."""
    r = np.random.default_rng(n_keys)
    n = 5000
    sizes = [3, 7, 2][:n_keys]
    dims = [int(2 ** np.ceil(np.log2(s + 1))) for s in sizes]
    strides = tuple(int(np.prod(dims[i + 1:])) for i in range(n_keys))
    g_n = int(np.prod(dims))
    codes = [r.integers(-1, s, n).astype(np.int32) for s in sizes]
    valid = r.random(n) < 0.85
    f = r.normal(size=(2, n)) * 1e3
    f[:, ~valid] = np.nan
    i = r.integers(-2**40, 2**40, (1, n)).astype(np.int64)
    fs, is_, counts, rep = fuse.onehot_agg(
        [torch.from_numpy(x) for x in f] + [torch.from_numpy(x) for x in i],
        [fuse._AGG_TAG[torch.float64]] * 2 + [fuse._AGG_TAG[torch.int64]], 2,
        [torch.from_numpy(c) for c in codes], strides, g_n, torch.from_numpy(valid))
    gid = sum((c.astype(np.int64) + 1) * s for c, s in zip(codes, strides))
    for g in range(g_n):
        rows = np.nonzero(valid & (gid == g))[0]
        assert int(counts[g]) == len(rows)
        assert int(rep[g]) == (rows[0] if len(rows) else n)
        assert int(is_[0, g]) == int(i[0, rows].sum())
        np.testing.assert_allclose(fs[:, g].numpy(), f[:, rows].sum(1), rtol=1e-12, atol=1e-9)
    assert counts.dtype == torch.int32 and rep.dtype == torch.int64


# sum (the reference's __nn0), count and avg (its __nncount) over plain
# columns of the four types K6 reads in place
TYPED_AGGS = ("sum(f) as sf, sum(x32) as sx, sum(i) as si, sum(j32) as sj, count(*) as n, "
              "count(x32) as nx, count(j32) as nj, avg(g) as ag, avg(i) as ai")


def _typed_batches(n, seed, nulls):
    """mixed_table with columns x32 and j32, as a reference batch (which
    widens them to float64 and int64 under x64) and a port batch that
    holds them as float32 and int32 (NaN and the int32 sentinel for nulls)."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    t = mixed_table(n, seed=seed, nulls=nulls)
    x32 = r.normal(size=n).astype(np.float32)
    x32[r.random(n) < 0.05] = np.nan
    j32 = [None if nulls and k else int(v)
           for v, k in zip(r.integers(-1000, 1000, n), r.random(n) < 0.08)]
    t = t.append_column("x32", pa.array(x32, type=pa.float32())).append_column(
        "j32", pa.array(j32, type=pa.int32()))
    ref_b = ref_batch_of(t)
    b = port_batch(ref_b)
    x = b.columns["x32"].data
    j = b.columns["j32"].data
    j = torch.where(j == torch.iinfo(j.dtype).min, batch.NULL_I32, j)
    cols = {**b.columns, "x32": batch.NumCol(x.to(torch.float32), "f"),
            "j32": batch.NumCol(j.to(torch.int32), "i")}
    return ref_b, batch.DeviceBatch(cols, b.valid)


@pytest.mark.parametrize("nulls", [False, True], ids=["plain", "nulls"])
def test_k6_reads_plain_columns_of_four_types_tagged(nulls, monkeypatch, onehot_calls,
                                                     fresh_aot):
    """float64, float32, int64 and int32 columns reach the tagged plain
    version as they lie (the batch's own tensors), bare, under __nn0 and
    under __nncount, and the result lines up with the reference's."""
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    ref_b, b = _typed_batches(3000, seed=5, nulls=nulls)
    ref_out = ref_fuse.FusedPartialAgg(KEYS, ref_plan(ref_sqlparse.parse_select_list(
        TYPED_AGGS)))(ref_b)
    plan = plan_aggregation(sqlparse.parse_select_list(TYPED_AGGS))
    out = fuse.FusedPartialAgg(KEYS, plan)(b)
    assert len(onehot_calls) == 1
    (cols, tags, nf, *_), _ = onehot_calls[0]
    own = {b.columns[k].data.data_ptr(): k for k in ("f", "x32", "i", "j32", "g")}
    read = {(own.get(c.data_ptr()), tag) for c, tag in zip(cols, tags)}
    tag, wrap = fuse._AGG_TAG, fuse._AGG_WRAP
    nn0, nnc = wrap["__nn0"], wrap["__nncount"]
    assert read == {("f", tag[torch.float64] | nn0), ("x32", tag[torch.float32] | nn0),
                    ("i", tag[torch.int64] | nn0), ("j32", tag[torch.int32] | nn0),
                    ("x32", tag[torch.float32] | nnc), ("j32", tag[torch.int32] | nnc),
                    ("g", tag[torch.float64] | nn0), ("g", tag[torch.float64] | nnc),
                    ("i", tag[torch.int64] | nnc)}
    assert nf == 3  # f, x32, g sum into float64
    num = out.count_valid()
    assert num == ref_out.count_valid()
    for k in KEYS:
        assert _decode(out.columns[k], num) == _decode(ref_out.columns[k], num)
    pre = dict(plan.pre)
    for pname, op, tmp in plan.partials:
        got = out.columns[pname].data.numpy()[:num]
        exp = np.asarray(ref_out.columns[pname].data)[:num]
        if op == "sum" and pre[tmp].sql().startswith("__nn0(j32"):
            # summed in its column's own int32 (the reference's bridge
            # widened the column to int64)
            assert got.dtype == np.int32
        else:
            assert got.dtype == exp.dtype, (pname, op)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-12)
        else:
            np.testing.assert_array_equal(got.astype(np.int64), exp.astype(np.int64))


@pytest.mark.parametrize("aggs,pre_passes", [
    ("sum(g) as sg, count(*) as n, count(f) as nf, avg(i) as ai", 0),
    ("sum(g * (1 - f)) as sx, sum(g) as sg, count(*) as n", 1),
    ("count(*) as n", 0),
])
def test_one_hot_batch_runs_no_k5_and_a_pre_pass_only_for_expressions(aggs, pre_passes,
                                                                      monkeypatch):
    """A batch on the one-hot path evaluates no pre-expression by K5 (its
    plain columns are read in place, with no copy) and runs K6's pre-pass
    once when, and only when, a partial's input is an expression."""
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    calls = {"pre": 0, "k6": 0}
    real_pre, real_k6 = fuse.onehot_pre, fuse.onehot_agg

    def pre(*a, **kw):
        calls["pre"] += 1
        return real_pre(*a, **kw)

    def k6(*a, **kw):
        calls["k6"] += 1
        return real_k6(*a, **kw)

    def no_k5(*a, **kw):
        raise AssertionError("K5 ran on a one-hot batch")

    monkeypatch.setattr(fuse, "onehot_pre", pre)
    monkeypatch.setattr(fuse, "onehot_agg", k6)
    monkeypatch.setattr(fuse.FusedPartialAgg, "prepare_general", no_k5)
    monkeypatch.setattr(fuse.PreAggCall, "run", no_k5)
    b = port_batch(ref_batch_of(mixed_table(2000, seed=9)))
    fuse.FusedPartialAgg(KEYS, plan_aggregation(sqlparse.parse_select_list(aggs)))(b)
    assert calls == {"pre": pre_passes, "k6": 1}


def _fake_batches(padded, dict_size):
    """One dictionary key of ``dict_size`` values over ``padded`` rows, as
    a port batch and a reference batch."""
    values = np.array([f"v{j}" for j in range(dict_size)], dtype=object)
    codes = np.zeros(padded, dtype=np.int32)
    valid = np.ones(padded, dtype=bool)
    port = batch.DeviceBatch({"k": batch.StrCol(torch.from_numpy(codes),
                                                batch.StringDict(values))},
                             torch.from_numpy(valid))
    ref = ref_batch.DeviceBatch({"k": ref_batch.StrCol(jnp.asarray(codes),
                                                       ref_batch.StringDict(values))},
                                jnp.asarray(valid))
    return port, ref


@pytest.mark.parametrize("padded,dict_size,one_hot", [
    (1 << 20, 3, True),      # Q1-like: 5 buckets
    (1 << 20, 25, True),     # Q5's n_name: 33 buckets, 277 MB
    (1 << 21, 25, False),    # ... 554 MB at 2^21 rows
    (1 << 20, 100, False),   # the backtest's symbols: 129 buckets, 1.08 GB
    (1 << 12, 300, False),   # past 256 buckets: neither small path
])
def test_one_hot_gate_matches_reference(padded, dict_size, one_hot):
    """The one-hot takes a batch only where its float64 operand fits 512
    MiB; the scatter strategy (K2) has no such gate."""
    p, r = _fake_batches(padded, dict_size)
    plan = plan_aggregation(sqlparse.parse_select_list("sum(x) as s, count(*) as n"))
    agg = fuse.FusedPartialAgg(["k"], plan)
    ref_agg = ref_fuse.FusedPartialAgg(["k"], ref_plan(ref_sqlparse.parse_select_list(
        "sum(x) as s, count(*) as n")))
    got = agg._small_dims(p, use_tables=False)
    assert (got is not None) is one_hot
    assert got == ref_agg._small_dims(r, use_tables=False)
    assert agg._small_dims(p, use_tables=True) == ref_agg._small_dims(r, use_tables=True)


# -- queries under groupby=sort, through both packages ----------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "nulls"])
def tpch(request, tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=13, nulls=request.param)
    root = tmp_path_factory.mktemp("strategy_rows")
    return tpch_data.write_parquet_dir(tables, str(root))


def test_q1_groupby_sort_matches_reference(tpch, monkeypatch, onehot_calls, fresh_aot):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    strategy.reset_used()
    got = q1(QuokkaContext(device="cpu"), tpch["lineitem"])
    assert onehot_calls, "Q1's partial aggregate must take the one-hot path"
    assert strategy.used_snapshot()["groupby"] == "sort"
    same_q1(got, q1(quokka_tpu.QuokkaContext(), tpch["lineitem"]))


def test_q4_groupby_sort_matches_reference(tpch, monkeypatch, onehot_calls, fresh_aot):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    strategy.reset_used()
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = q4(None, ctx, tpch).collect()
    assert onehot_calls
    assert strategy.used_snapshot()["groupby"] == "sort"
    ref = q4(None, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2), tpch).collect()
    same_sorted(["o_orderpriority"])(got, ref)


def test_q5_groupby_sort_matches_reference(tpch, monkeypatch, onehot_calls, fresh_aot):
    """Q5's n_name group-by (25 nations, 32 buckets) takes the one-hot with
    its expression input from K6's pre-pass, and agrees with the reference."""
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    strategy.reset_used()
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = q5(quokka_tpu_torch, ctx, tpch).collect()
    assert onehot_calls
    assert all(a[5] == 32 for a, _ in onehot_calls)  # n_groups
    assert strategy.used_snapshot()["groupby"] == "sort"
    ref = q5(quokka_tpu, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2), tpch).collect()
    same_q5(got, ref)


def test_batch_past_the_gate_takes_the_general_path(tpch, monkeypatch, onehot_calls,
                                                    fresh_aot):
    """With the one-hot gate lowered below Q1's batches, both packages take
    the general path (the sort group-by) and still agree."""
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    monkeypatch.setattr(fuse, "_SMALL_GROUPBY_MAX_BYTES", 1 << 10)
    monkeypatch.setattr(ref_fuse, "_SMALL_GROUPBY_MAX_BYTES", 1 << 10)
    strategy.reset_used()
    got = q1(QuokkaContext(device="cpu"), tpch["lineitem"])
    assert not onehot_calls
    assert strategy.used_snapshot()["groupby"] == "sort"
    same_q1(got, q1(quokka_tpu.QuokkaContext(), tpch["lineitem"]))
