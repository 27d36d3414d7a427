"""The PyTorch port's TPC-H Q4, Q13, Q19 and Q7 end to end, against the
reference (quokka_tpu, JAX x64 on the CPU) and against pandas, on
tpch_data tables read from Parquet with io_channels=2 and exec_channels=2,
the queries written as tests/test_tpch.py and tests/test_tpch2.py write
them.

Q4 is a semi join on a non-unique build (the general join's semi branch),
Q13 a left join (null payloads, count(col), an aggregate over an
aggregate), Q19 a PK join followed by a filter across both sides (kernel
K16 inside the fused stage), Q7 five PK joins, rename/select, a cross-join
filter and with_columns_sql with extract(year ...) inside the stage.

Each query runs under both join_build strategies and with two broadcast
thresholds: the default (at this scale every build side is broadcast) and
100 rows, which makes the larger builds hash-partitioned joins.  The data
is uniform, and Zipf-skewed (hot foreign keys).

Tolerances: keys and counts exact, floats rtol 1e-9 (summation order);
grouped results compare after a sort on the keys.
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
from quokka_tpu_torch.ops import fuse, join, stagefuse, strategy

from torch_port_util import fresh_aot  # noqa: F401

STRATEGIES = ["hashtable", "sort"]
THRESHOLDS = {"broadcast": None, "partitioned": 100}


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "skew"])
def env(request, tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=11, skew=request.param)
    root = tmp_path_factory.mktemp("tpch_q4q13q19q7")
    paths = tpch_data.write_parquet_dir(tables, str(root))
    return paths, {k: t.to_pandas() for k, t in tables.items()}


def _setup(monkeypatch, join_build, threshold):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"join_build={join_build}")
    if threshold is not None:
        monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", threshold)
        monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", threshold)
    strategy.reset_used()


def q4(pkg, ctx, paths):
    """tests/test_tpch.py::test_q4's query."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    return (
        s["orders"]
        .filter_sql("o_orderdate >= date '1993-07-01' and o_orderdate < date '1993-10-01'")
        .join(s["lineitem"].filter_sql("l_commitdate < l_receiptdate"),
              left_on="o_orderkey", right_on="l_orderkey", how="semi")
        .groupby("o_orderpriority")
        .agg_sql("count(*) as order_count")
    )


def q13(pkg, ctx, paths):
    """tests/test_tpch.py::test_q13's query."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    return (
        s["customer"]
        .join(s["orders"].filter(~pkg.col("o_comment").str.contains("special")),
              left_on="c_custkey", right_on="o_custkey", how="left")
        .groupby("c_custkey")
        .agg_sql("count(o_orderkey) as c_count")
        .groupby("c_count")
        .agg_sql("count(*) as custdist")
    )


Q19_FILTER = (
    "(p_brand = 'Brand#12' and l_quantity >= 1 and l_quantity <= 11 "
    " and p_size between 1 and 5) "
    "or (p_brand = 'Brand#23' and l_quantity >= 10 and l_quantity <= 20 "
    " and p_size between 1 and 10) "
    "or (p_brand = 'Brand#34' and l_quantity >= 20 and l_quantity <= 30 "
    " and p_size between 1 and 15)")


def q19(pkg, ctx, paths):
    """tests/test_tpch.py::test_q19's query."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    return (
        s["lineitem"]
        .join(s["part"], left_on="l_partkey", right_on="p_partkey")
        .filter_sql(Q19_FILTER)
        .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue, count(*) as n")
    )


def q7(pkg, ctx, paths):
    """tests/test_tpch2.py::test_q7's query."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    n1 = s["nation"].rename({"n_name": "supp_nation", "n_nationkey": "n1key"})
    n2 = s["nation"].rename({"n_name": "cust_nation", "n_nationkey": "n2key"})
    return (
        s["lineitem"]
        .filter_sql("l_shipdate between date '1995-01-01' and date '1996-12-31'")
        .join(s["supplier"], left_on="l_suppkey", right_on="s_suppkey")
        .join(s["orders"], left_on="l_orderkey", right_on="o_orderkey")
        .join(s["customer"], left_on="o_custkey", right_on="c_custkey")
        .join(n1.select(["supp_nation", "n1key"]), left_on="s_nationkey", right_on="n1key")
        .join(n2.select(["cust_nation", "n2key"]), left_on="c_nationkey", right_on="n2key")
        .filter_sql("(supp_nation = 'FRANCE' and cust_nation = 'GERMANY') or "
                    "(supp_nation = 'GERMANY' and cust_nation = 'FRANCE')")
        .with_columns_sql("extract(year from l_shipdate) as l_year, "
                          "l_extendedprice * (1 - l_discount) as volume")
        .groupby(["supp_nation", "cust_nation", "l_year"])
        .agg_sql("sum(volume) as revenue")
    )


def pandas_q4(dfs):
    o, l = dfs["orders"], dfs["lineitem"]
    of = o[(o.o_orderdate >= datetime.date(1993, 7, 1))
           & (o.o_orderdate < datetime.date(1993, 10, 1))]
    lk = set(l[l.l_commitdate < l.l_receiptdate].l_orderkey)
    sel = of[of.o_orderkey.isin(lk)]
    return sel.groupby("o_orderpriority").size().reset_index(name="order_count")


def pandas_q13(dfs):
    c, o = dfs["customer"], dfs["orders"]
    of = o[~o.o_comment.str.contains("special")]
    m = c.merge(of, left_on="c_custkey", right_on="o_custkey", how="left")
    cc = m.groupby("c_custkey").o_orderkey.count().reset_index(name="c_count")
    return cc.groupby("c_count").size().reset_index(name="custdist")


def pandas_q19(dfs):
    l, p = dfs["lineitem"], dfs["part"]
    m = l.merge(p, left_on="l_partkey", right_on="p_partkey")
    cond = (
        ((m.p_brand == "Brand#12") & m.l_quantity.between(1, 11) & m.p_size.between(1, 5))
        | ((m.p_brand == "Brand#23") & m.l_quantity.between(10, 20) & m.p_size.between(1, 10))
        | ((m.p_brand == "Brand#34") & m.l_quantity.between(20, 30) & m.p_size.between(1, 15))
    )
    f = m[cond]
    return pd.DataFrame({"revenue": [(f.l_extendedprice * (1 - f.l_discount)).sum()],
                         "n": [len(f)]})


def pandas_q7(dfs):
    l, su, o, c, n = (dfs[k] for k in ("lineitem", "supplier", "orders", "customer", "nation"))
    f = l[(l.l_shipdate >= datetime.date(1995, 1, 1))
          & (l.l_shipdate <= datetime.date(1996, 12, 31))]
    j = (f.merge(su, left_on="l_suppkey", right_on="s_suppkey")
         .merge(o, left_on="l_orderkey", right_on="o_orderkey")
         .merge(c, left_on="o_custkey", right_on="c_custkey")
         .merge(n.rename(columns={"n_name": "supp_nation"}), left_on="s_nationkey",
                right_on="n_nationkey")
         .merge(n.rename(columns={"n_name": "cust_nation"}), left_on="c_nationkey",
                right_on="n_nationkey"))
    j = j[((j.supp_nation == "FRANCE") & (j.cust_nation == "GERMANY"))
          | ((j.supp_nation == "GERMANY") & (j.cust_nation == "FRANCE"))]
    j = j.assign(l_year=pd.to_datetime(j.l_shipdate).dt.year,
                 volume=j.l_extendedprice * (1 - j.l_discount))
    return (j.groupby(["supp_nation", "cust_nation", "l_year"]).volume.sum()
            .reset_index(name="revenue"))


def same_sorted(by):
    def check(got, exp):
        assert len(exp) > 0
        got = got.sort_values(by).reset_index(drop=True)[list(exp.columns)]
        exp = exp.sort_values(by).reset_index(drop=True)
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=1e-9)
    return check


def same_q19(got, exp):
    assert int(exp.n[0]) > 0
    assert int(got.n[0]) == int(exp.n[0])
    np.testing.assert_allclose(got.revenue[0], exp.revenue[0], rtol=1e-9)


# query -> (query function, pandas oracle, comparison)
QUERIES = {
    "q4": (q4, pandas_q4, same_sorted(["o_orderpriority"])),
    "q13": (q13, pandas_q13, same_sorted(["c_count"])),
    "q19": (q19, pandas_q19, same_q19),
    "q7": (q7, pandas_q7, same_sorted(["supp_nation", "cust_nation", "l_year"])),
}


class _Calls:
    """Counts the general join's and K16's calls during one query."""

    def __init__(self, monkeypatch):
        self.general = self.elemwise = 0
        real_general, real_plain = join.hash_join_general, stagefuse.elementwise_plain

        def general(*a, **kw):
            self.general += 1
            return real_general(*a, **kw)

        def plain(*a, **kw):
            self.elemwise += 1
            return real_plain(*a, **kw)

        monkeypatch.setattr(join, "hash_join_general", general)
        monkeypatch.setattr(stagefuse, "elementwise_plain", plain)


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("layout", list(THRESHOLDS))
@pytest.mark.parametrize("join_build", STRATEGIES)
def test_query_matches_reference_and_pandas(env, query, layout, join_build, monkeypatch,
                                            fresh_aot):
    paths, dfs = env
    build, oracle, same = QUERIES[query]
    _setup(monkeypatch, join_build, THRESHOLDS[layout])
    calls = _Calls(monkeypatch)
    fallbacks, sequential = fuse.FALLBACKS, stagefuse.SEQUENTIAL
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = build(quokka_tpu_torch, ctx, paths).collect()
    assert fuse.FALLBACKS == fallbacks, f"{query} left the fused kernels"
    assert stagefuse.SEQUENTIAL == sequential, f"{query} took the per-step stage path"
    if query in ("q4", "q13"):
        assert calls.general > 0, f"{query} did not take the general join"
    if query in ("q19", "q7"):
        assert calls.elemwise > 0, f"{query} ran no in-stage elementwise step"
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
    else:
        desc = (kind,)
    return desc + (node.stage, tuple(_shape(sub, p) for p in node.parents))


def _member(m):
    kind = type(m).__name__
    if kind == "JoinNode":
        return (kind, m.how, tuple(m.left_on), tuple(m.right_on), m.broadcast)
    if kind == "FilterNode":
        return (kind, m.predicate.sql())
    if kind == "AggNode":
        return (kind, tuple(m.keys))
    return (kind, tuple(m.schema))


def _plan(pkg, query, paths):
    ctx = (pkg.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
           if pkg is quokka_tpu_torch else pkg.QuokkaContext(io_channels=2, exec_channels=2))
    ds = QUERIES[query][0](pkg, ctx, paths)
    sub, sink = ctx._prepare_plan(ds.node_id)
    ctx._assign_stages(sub, sink)
    return _shape(sub, sink)


def _joins(shape):
    """Every join of a plan shape as (how, left keys, right keys, broadcast)."""
    out = []
    if shape[0] == "FusedStageNode":
        out += [m[1:] for m in shape[1] if m[0] == "JoinNode"]
    elif shape[0] == "JoinNode":
        out.append(shape[1:5])
    for child in shape[-1] if shape[0] != "SourceNode" else ():
        out += _joins(child)
    return out


@pytest.mark.parametrize("layout", list(THRESHOLDS))
def test_optimized_plans_match_reference(env, layout, monkeypatch, fresh_aot):
    """Q4, Q13 and Q19's optimised plans (node kinds, broadcast flags, stage
    members, pushed filters and projections, stages) equal the reference's.
    For Q7 the reference's cost-fed reorder_joins may move joins, a pass
    the port does not carry (it keeps the user's join order), so Q7
    compares its set of joins with their broadcast flags, and its results
    (test above)."""
    paths, _ = env
    _setup(monkeypatch, "hashtable", THRESHOLDS[layout])
    for query in ("q4", "q13", "q19"):
        assert _plan(quokka_tpu_torch, query, paths) == _plan(quokka_tpu, query, paths), query
    port7, ref7 = _plan(quokka_tpu_torch, "q7", paths), _plan(quokka_tpu, "q7", paths)
    assert sorted(_joins(port7)) == sorted(_joins(ref7))


def _stage_members(shape):
    """Member kinds of every fused stage in a plan shape."""
    out = []
    if shape[0] == "FusedStageNode":
        out.append([m[0] for m in shape[1]])
    for child in shape[-1] if shape[0] != "SourceNode" else ():
        out += _stage_members(child)
    return out


def test_q19_and_q7_keep_their_filter_and_map_in_a_stage(env, monkeypatch):
    """Q19's filter and Q7's filter and map cannot be pushed below the joins:
    they stay inside the fused stage that ends in the partial aggregate."""
    paths, _ = env
    _setup(monkeypatch, "hashtable", THRESHOLDS["partitioned"])
    assert ["JoinNode", "FilterNode", "AggNode"] in _stage_members(
        _plan(quokka_tpu_torch, "q19", paths))
    stages7 = _stage_members(_plan(quokka_tpu_torch, "q7", paths))
    assert any(m[-3:] == ["FilterNode", "MapNode", "AggNode"] for m in stages7), stages7
    assert stages7.count(["MapNode", "ProjectionNode"]) == 2, stages7


def test_stage_fusion_off_gives_the_same_result(env, monkeypatch, fresh_aot):
    """Without stage fusion Q7's filter and its map run as actors of their
    own."""
    paths, dfs = env
    _setup(monkeypatch, "hashtable", THRESHOLDS["partitioned"])
    monkeypatch.setenv("QK_STAGE_FUSE", "0")
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    plan = q7(quokka_tpu_torch, ctx, paths).explain()
    assert "FusedStage" not in plan and "Filter" in plan and "Map(" in plan
    QUERIES["q7"][2](q7(quokka_tpu_torch, ctx, paths).collect(), pandas_q7(dfs))
