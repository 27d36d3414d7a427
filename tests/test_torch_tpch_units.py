"""The surface TPC-H Q16 and Q22 added to the PyTorch port, against the
reference (quokka_tpu, JAX x64) on the CPU: the str op ``slice``
(``substring``) as a deduplicated dictionary transform, ``count(distinct
col)`` and ``DataStream.count_distinct``, a string-valued map output inside
a fused stage (kernel K16's plain version takes the numeric rest), and a
group-by, a join key and a distinct on a column whose dictionary repeats a
value.  Inputs are made with numpy from a seed; results compare exactly
(keys and counts) after a sort on the keys.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import quokka_tpu
import quokka_tpu_torch
from quokka_tpu.ops import expr_compile as ref_expr
from quokka_tpu_torch import sqlparse
from quokka_tpu_torch.ops import expr_compile, fuse, stagefuse

from torch_port_util import fresh_aot, port_batch, ref_batch_of  # noqa: F401


def _phones(n, seed, nulls=True):
    r = np.random.default_rng(seed)
    vals = [f"{k}-{r.integers(100, 999)}" for k in r.integers(10, 14, n)]
    vals[3] = "7"  # shorter than the slice
    vals[4] = ""
    if nulls:
        for i in np.nonzero(r.random(n) < 0.1)[0]:
            vals[i] = None
    return pa.table({"p": pa.array(vals, type=pa.string()),
                     "v": pa.array(r.normal(size=n))})


def _rows(col, valid):
    """The string value of each valid row (None for a null)."""
    codes = np.asarray(col.codes)[: len(valid)]
    vals = col.dictionary.values
    return [None if c < 0 or vals[c] is None else str(vals[c])
            for c, ok in zip(codes, valid) if ok]


@pytest.mark.parametrize("sql", ["substring(p, 1, 2)", "substring(p, 3)",
                                 "substring(p, 2, 100)", "substring(p, 20, 2)",
                                 "substring(p, 20)", "upper(substring(p, 1, 2))"])
def test_slice_matches_reference(sql):
    """``slice`` with and without a length, an offset past the string and
    null entries: the port's rows equal the reference's, null rows stay
    null, and the new dictionary holds each value once."""
    table = _phones(300, seed=1)
    ref_b = ref_batch_of(table)
    b = port_batch(ref_b)
    e = sqlparse.parse_expression(sql)
    got = expr_compile.evaluate(e, b)
    exp = ref_expr.evaluate(quokka_tpu.sqlparse.parse_expression(sql), ref_b)
    valid = np.asarray(ref_b.valid)
    assert _rows(got, valid) == _rows(exp, valid)
    null_rows = np.asarray(b.columns["p"].codes)[: len(valid)][valid] < 0
    assert null_rows.any()
    assert (np.asarray(got.codes)[: len(valid)][valid][null_rows] < 0).all()
    vals = [v for v in got.dictionary.values if v is not None]
    assert len(vals) == len(set(vals))


def test_slice_keeps_null_dictionary_entries_null():
    """A dictionary entry that is None (a null) stays None; the codes of the
    other entries go through the deduplicated dictionary."""
    from quokka_tpu_torch.ops import bridge

    b = bridge.batch_from_numpy({"p": np.array([0, 1, 2, 3, -1], dtype=np.int32)},
                                np.ones(5, dtype=bool),
                                {"p": np.array(["ab-1", None, "ab-2", "c"], dtype=object)}, {})
    got = expr_compile.evaluate(sqlparse.parse_expression("substring(p, 1, 2)"), b)
    assert _rows(got, [True] * 5) == ["ab", None, "ab", "c", None]
    assert sorted(got.dictionary.values.tolist()) == ["ab", "c"]


def _both(build, tables, sort_by):
    """build(pkg, ctx, tables) through both packages, each result sorted on
    ``sort_by`` (the port on the CPU, with no fallback or per-step batch)."""
    fallbacks, sequential = fuse.FALLBACKS, stagefuse.SEQUENTIAL
    got = build(quokka_tpu_torch, quokka_tpu_torch.QuokkaContext(device="cpu"), tables)
    assert (fuse.FALLBACKS, stagefuse.SEQUENTIAL) == (fallbacks, sequential)
    exp = build(quokka_tpu, quokka_tpu.QuokkaContext(), tables)
    return tuple(d.sort_values(sort_by, na_position="last").reset_index(drop=True)
                 for d in (got, exp))


def _distinct_table(n=2000, seed=5):
    r = np.random.default_rng(seed)
    x = r.integers(0, 40, n).astype(float)
    x[r.random(n) < 0.1] = np.nan  # nulls
    return pa.table({"g": pa.array(np.array(["a", "b", "c"])[r.integers(0, 3, n)]),
                     "x": pa.array(x, from_pandas=True),
                     "y": pa.array(r.integers(0, 5, n))})


def test_count_distinct_excludes_nulls(fresh_aot):
    t = _distinct_table()
    got, exp = _both(lambda pkg, ctx, t: ctx.from_arrow(t["t"]).groupby("g").agg_sql(
        "count(distinct x) as n").collect(), {"t": t}, ["g"])
    pd.testing.assert_frame_equal(got[["g", "n"]], exp[["g", "n"]], check_dtype=False)
    df = t.to_pandas()
    assert got.n.tolist() == df.groupby("g").x.nunique().sort_index().tolist()
    got, exp = _both(lambda pkg, ctx, t: ctx.from_arrow(t["t"]).count_distinct("x").collect(),
                     {"t": t}, ["count"])
    assert int(got["count"][0]) == int(exp["count"][0]) == df.x.nunique()


@pytest.mark.parametrize("sql", ["count(distinct x) as n, sum(y) as s",
                                 "count(distinct x) as n, count(distinct y) as m",
                                 "count(distinct x + 1) as n"])
def test_count_distinct_mixed_or_on_an_expression_raises(sql):
    ctx = quokka_tpu_torch.QuokkaContext(device="cpu")
    ds = ctx.from_arrow(_distinct_table(50))
    with pytest.raises(ValueError, match="count\\(distinct"):
        ds.groupby("g").agg_sql(sql)
    with pytest.raises(ValueError, match="count\\(distinct"):
        quokka_tpu.QuokkaContext().from_arrow(_distinct_table(50)).groupby("g").agg_sql(sql)


def test_string_map_output_in_a_fused_stage(fresh_aot):
    """Q22's shape: a substring map, a filter on the new column and another
    on a number, an anti join and a group-by on the new column, in one fused
    stage with K16 (plain here) taking the numeric rest; the groups are one
    per value."""
    r = np.random.default_rng(9)
    n = 3000
    phones = np.array([f"{k}-{i:05d}" for i, k in enumerate(r.integers(10, 20, n))],
                      dtype=object)
    cust = pa.table({"k": np.arange(n), "p": phones, "b": r.normal(size=n)})
    orders = pa.table({"ok": r.integers(0, n, n // 2)})

    def build(pkg, ctx, t):
        return (ctx.from_arrow(t["cust"])
                .with_columns_sql("substring(p, 1, 2) as cc")
                .filter_sql("cc in ('11', '13', '17', '19')")
                .filter_sql("b > 0.25")
                .join(ctx.from_arrow(t["orders"]), left_on="k", right_on="ok", how="anti")
                .groupby("cc").agg_sql("count(*) as n, sum(b) as s").collect())

    calls = []
    real = stagefuse.ElemwiseCall.run
    try:
        stagefuse.ElemwiseCall.run = lambda self: calls.append(self) or real(self)
        got, exp = _both(build, {"cust": cust, "orders": orders}, ["cc"])
    finally:
        stagefuse.ElemwiseCall.run = real
    assert any("cc" in c.strings for c in calls)
    assert got.cc.tolist() == ["11", "13", "17", "19"]
    pd.testing.assert_frame_equal(got[["cc", "n", "s"]], exp[["cc", "n", "s"]],
                                  check_dtype=False, rtol=1e-9)


def _repeated_dictionary(n=4000, seed=3):
    """A dictionary column whose dictionary holds "x" and "y" twice each, the
    codes of each copy drawn at random."""
    r = np.random.default_rng(seed)
    codes = r.integers(0, 5, n).astype(np.int32)
    col = pa.DictionaryArray.from_arrays(pa.array(codes), pa.array(["x", "y", "x", "z", "y"]))
    return pa.table({"s": col, "v": pa.array(r.integers(0, 100, n))})


def test_group_by_on_a_repeated_dictionary_value(fresh_aot):
    t = _repeated_dictionary()
    got, exp = _both(lambda pkg, ctx, t: ctx.from_arrow(t["t"]).groupby("s").agg_sql(
        "count(*) as n, sum(v) as sv").collect(), {"t": t}, ["s"])
    assert got.s.tolist() == ["x", "y", "z"]
    pd.testing.assert_frame_equal(got[["s", "n", "sv"]], exp[["s", "n", "sv"]],
                                  check_dtype=False)


def test_join_key_on_a_repeated_dictionary_value(fresh_aot):
    t = _repeated_dictionary()
    dim = pa.table({"name": ["x", "y", "z"], "w": [1, 2, 3]})
    got, exp = _both(lambda pkg, ctx, t: ctx.from_arrow(t["t"]).join(
        ctx.from_arrow(t["dim"]), left_on="s", right_on="name").groupby("w").agg_sql(
        "count(*) as n").collect(), {"t": t, "dim": dim}, ["w"])
    assert got.w.tolist() == [1, 2, 3]
    pd.testing.assert_frame_equal(got[["w", "n"]], exp[["w", "n"]], check_dtype=False)


def test_distinct_on_a_repeated_dictionary_value(fresh_aot):
    t = _repeated_dictionary()
    got, exp = _both(lambda pkg, ctx, t: ctx.from_arrow(t["t"]).select(["s"]).distinct()
                     .collect(), {"t": t}, ["s"])
    assert got.s.tolist() == exp.s.tolist() == ["x", "y", "z"]


def test_dict_transform_gathers_codes_on_the_batch_device():
    """The transform's codes stay on the codes' device and dtype."""
    from quokka_tpu_torch.ops import bridge

    b = bridge.batch_from_numpy({"p": np.array([2, 0, 1], dtype=np.int32)},
                                np.ones(3, dtype=bool),
                                {"p": np.array(["Ab", "aB", "c"], dtype=object)}, {})
    got = expr_compile.evaluate(sqlparse.parse_expression("lower(p)"), b)
    assert got.codes.dtype == torch.int32 and got.codes.device.type == "cpu"
    assert _rows(got, [True] * 3) == ["c", "ab", "ab"]
    assert len(got.dictionary) == 2
