"""The PyTorch port's TPC-H Q3 and Q5 end to end, against the reference
(quokka_tpu, JAX x64 on the CPU) and against pandas, on tpch_data tables
read from Parquet with io_channels=2 and exec_channels=2, the queries written
as tests/test_tpch.py writes them.

Each query runs under both join_build strategies (QK_KERNEL_STRATEGY, read
by both packages) and with two broadcast thresholds: the default (at this
scale every build side is broadcast) and 100 rows, which turns the orders
(and Q5's customer) builds into hash-partitioned joins, so the hash
exchange (K4) and a hash join at the head of a fused stage run too.  The
data is uniform, and Zipf-skewed (hot foreign keys).

Tolerances: keys exact, floats rtol 1e-9 (summation order); Q5's groups
compare after a sort on the key.
"""

import datetime

import numpy as np
import pandas as pd
import pytest

import quokka_tpu
import quokka_tpu.optimizer as ref_optimizer
import quokka_tpu_torch
import quokka_tpu_torch.optimizer as port_optimizer
import tpch_data
from quokka_tpu_torch.ops import fuse, strategy

from torch_port_util import fresh_aot  # noqa: F401

STRATEGIES = ["hashtable", "sort"]
THRESHOLDS = {"broadcast": None, "partitioned": 100}


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "skew"])
def env(request, tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=7, skew=request.param)
    root = tmp_path_factory.mktemp("tpch_q3q5")
    paths = tpch_data.write_parquet_dir(tables, str(root))
    return paths, {k: t.to_pandas() for k, t in tables.items()}


def _setup(monkeypatch, join_build, threshold):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"join_build={join_build}")
    if threshold is not None:
        monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", threshold)
        monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", threshold)
    # the catalogs cache estimates per reader; readers are new per query
    strategy.reset_used()


def q3(pkg, ctx, paths):
    """tests/test_tpch.py::test_q3's query, against either package."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    d = pkg.date("1995-03-15")
    col = pkg.col
    return (
        s["lineitem"].filter(col("l_shipdate") > d)
        .join(s["orders"].filter(col("o_orderdate") < d),
              left_on="l_orderkey", right_on="o_orderkey")
        .join(s["customer"].filter(col("c_mktsegment") == "BUILDING"),
              left_on="o_custkey", right_on="c_custkey")
        .groupby(["l_orderkey", "o_orderdate", "o_shippriority"])
        .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue")
        .top_k(["revenue"], 10, [True])
    )


def q5(pkg, ctx, paths):
    """tests/test_tpch.py::test_q5's query, against either package."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    return (
        s["lineitem"]
        .join(s["orders"].filter_sql(
            "o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'"),
            left_on="l_orderkey", right_on="o_orderkey")
        .join(s["customer"], left_on="o_custkey", right_on="c_custkey")
        .join(s["supplier"], left_on=["l_suppkey", "c_nationkey"],
              right_on=["s_suppkey", "s_nationkey"])
        .join(s["nation"], left_on="c_nationkey", right_on="n_nationkey")
        .join(s["region"].filter(pkg.col("r_name") == "ASIA"),
              left_on="n_regionkey", right_on="r_regionkey")
        .groupby("n_name")
        .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue")
    )


def pandas_q3(dfs):
    l, o, c = dfs["lineitem"], dfs["orders"], dfs["customer"]
    cut = datetime.date(1995, 3, 15)
    m = (l[l.l_shipdate > cut]
         .merge(o[o.o_orderdate < cut], left_on="l_orderkey", right_on="o_orderkey")
         .merge(c[c.c_mktsegment == "BUILDING"], left_on="o_custkey", right_on="c_custkey"))
    m["rev"] = m.l_extendedprice * (1 - m.l_discount)
    return (m.groupby(["l_orderkey", "o_orderdate", "o_shippriority"]).rev.sum()
            .reset_index(name="revenue").nlargest(10, "revenue"))


def pandas_q5(dfs):
    l, o, c = dfs["lineitem"], dfs["orders"], dfs["customer"]
    su, n, r = dfs["supplier"], dfs["nation"], dfs["region"]
    of = o[(o.o_orderdate >= datetime.date(1994, 1, 1))
           & (o.o_orderdate < datetime.date(1995, 1, 1))]
    m = (l.merge(of, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(su, left_on=["l_suppkey", "c_nationkey"], right_on=["s_suppkey", "s_nationkey"])
         .merge(n, left_on="c_nationkey", right_on="n_nationkey")
         .merge(r[r.r_name == "ASIA"], left_on="n_regionkey", right_on="r_regionkey"))
    m["rev"] = m.l_extendedprice * (1 - m.l_discount)
    return m.groupby("n_name").rev.sum().reset_index(name="revenue")


def _dates(s):
    return [pd.Timestamp(v).date() for v in s]


def same_q3(got, exp):
    got = got.sort_values("revenue", ascending=False).reset_index(drop=True)
    exp = exp.sort_values("revenue", ascending=False).reset_index(drop=True)
    assert len(got) == len(exp) == 10
    np.testing.assert_array_equal(got.l_orderkey.to_numpy(), exp.l_orderkey.to_numpy())
    np.testing.assert_array_equal(got.o_shippriority.to_numpy(), exp.o_shippriority.to_numpy())
    assert _dates(got.o_orderdate) == _dates(exp.o_orderdate)
    np.testing.assert_allclose(got.revenue.to_numpy(), exp.revenue.to_numpy(), rtol=1e-9)


def same_q5(got, exp):
    got = got.sort_values("n_name").reset_index(drop=True)
    exp = exp.sort_values("n_name").reset_index(drop=True)
    assert len(got) == len(exp) > 0
    assert list(got.n_name) == list(exp.n_name)
    np.testing.assert_allclose(got.revenue.to_numpy(), exp.revenue.to_numpy(), rtol=1e-9)


QUERIES = {"q3": (q3, pandas_q3, same_q3), "q5": (q5, pandas_q5, same_q5)}


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("layout", list(THRESHOLDS))
@pytest.mark.parametrize("join_build", STRATEGIES)
def test_query_matches_reference_and_pandas(env, query, layout, join_build, monkeypatch,
                                            fresh_aot):
    paths, dfs = env
    build, oracle, same = QUERIES[query]
    _setup(monkeypatch, join_build, THRESHOLDS[layout])
    fallbacks = fuse.FALLBACKS
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = build(quokka_tpu_torch, ctx, paths).collect()
    assert fuse.FALLBACKS == fallbacks, f"{query} left the fused kernels"
    assert strategy.used_snapshot()["join_build"] == join_build
    ref = build(quokka_tpu, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2),
                paths).collect()
    same(got, oracle(dfs))
    same(got, ref)


def _shape(sub, nid):
    """A plan as nested tuples from the sink down: node kind, join kind,
    keys and broadcast flag, fused-stage members, source predicate and
    projection."""
    node = sub[nid]
    kind = type(node).__name__
    if kind == "SourceNode":
        pred = node.predicate.sql() if node.predicate is not None else None
        return (kind, pred, tuple(node.projection or ()))
    if kind == "JoinNode":
        desc = (kind, node.how, tuple(node.left_on), tuple(node.right_on), node.broadcast)
    elif kind == "FusedStageNode":
        desc = (kind, tuple(_member(m) for m in node.members))
    elif kind == "AggNode":
        desc = (kind, tuple(node.keys))
    elif kind == "TopKNode":
        desc = (kind, tuple(node.by), node.k, tuple(node.descending))
    else:
        desc = (kind,)
    return desc + (node.stage, tuple(_shape(sub, p) for p in node.parents))


def _member(m):
    if type(m).__name__ == "JoinNode":
        return ("JoinNode", tuple(m.left_on), tuple(m.right_on), m.broadcast)
    return (type(m).__name__,)


def _plan(pkg, query, paths):
    ctx = (pkg.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
           if pkg is quokka_tpu_torch else pkg.QuokkaContext(io_channels=2, exec_channels=2))
    ds = QUERIES[query][0](pkg, ctx, paths)
    sub, sink = ctx._prepare_plan(ds.node_id)
    ctx._assign_stages(sub, sink)
    return _shape(sub, sink)


def _joins(shape):
    """Every join of a plan shape as (left keys, right keys, broadcast)."""
    out = []
    if shape[0] == "FusedStageNode":
        out += [m[1:] for m in shape[1] if m[0] == "JoinNode"]
    elif shape[0] == "JoinNode":
        out.append(shape[2:5])
    for child in shape[-1] if shape[0] != "SourceNode" else ():
        out += _joins(child)
    return out


@pytest.mark.parametrize("layout", list(THRESHOLDS))
def test_optimized_plans_match_reference(env, layout, monkeypatch, fresh_aot):
    """The optimised plans (node kinds, broadcast flags, stage members,
    pushed filters and projections, stages) equal the reference's for Q3.
    For Q5 the reference's cost-fed reorder_joins moves the nation and
    region joins ahead of the supplier join, a pass the port does not carry
    (it keeps the user's join order), so Q5 compares its set of joins with
    their broadcast flags, and its results (test above)."""
    paths, _ = env
    _setup(monkeypatch, "hashtable", THRESHOLDS[layout])
    assert _plan(quokka_tpu_torch, "q3", paths) == _plan(quokka_tpu, "q3", paths)
    port5, ref5 = _plan(quokka_tpu_torch, "q5", paths), _plan(quokka_tpu, "q5", paths)
    assert sorted(_joins(port5)) == sorted(_joins(ref5))
    assert [j[:2] for j in _joins(port5)] != [j[:2] for j in _joins(ref5)], \
        "the reference no longer reorders Q5's joins: compare the whole plan"


@pytest.mark.parametrize("layout", list(THRESHOLDS))
def test_q3_plan_fuses_one_stage(env, layout, monkeypatch):
    """Q3 runs as one fused stage: [join(orders), BroadcastJoin(customer),
    partial Agg], with the orders join hash-partitioned once its build is
    over the broadcast threshold."""
    paths, _ = env
    _setup(monkeypatch, "hashtable", THRESHOLDS[layout])
    shape = _plan(quokka_tpu_torch, "q3", paths)
    topk = shape[-1][0]
    fused = topk[-1][0]
    assert fused[0] == "FusedStageNode"
    members = fused[1]
    assert [m[0] for m in members] == ["JoinNode", "JoinNode", "AggNode"]
    assert members[0][3] is (layout == "broadcast") and members[1][3] is True


def test_stage_fusion_off_gives_the_same_result(env, monkeypatch, fresh_aot):
    paths, dfs = env
    _setup(monkeypatch, "hashtable", THRESHOLDS["partitioned"])
    monkeypatch.setenv("QK_STAGE_FUSE", "0")
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    assert "FusedStage" not in q3(quokka_tpu_torch, ctx, paths).explain()
    same_q3(q3(quokka_tpu_torch, ctx, paths).collect(), pandas_q3(dfs))
