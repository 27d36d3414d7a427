"""The port's ``DataStream.distinct`` (DistinctNode, DistinctExecutor,
``kernels.distinct``, the optimizer's distinct cases), TPC-H Q21 (three
distincts over lineitem) and the mesh's distinct, against the reference
(quokka_tpu, JAX x64 on the CPU) and pandas.

A distinct is a group-by with no aggregates a batch, then an anti join of
the batch's keys against the keys its channel has seen (the general join's
plan: K10's pass and K13p on a card, their plain versions here).  The
sources deal small batches, so every channel sees several and the anti join
runs.  The data is uniform, Zipf-skewed (hot keys) and with nulls; on null
data the reference is the oracle, not pandas: a null key never matches the
keys seen (SQL join semantics), so each batch that holds one emits it again,
in both packages.

Q21 is tests/test_tpch2.py::test_q21's query, under both join_build
strategies and with two broadcast thresholds (the default, and 100 rows,
which makes the larger builds hash-partitioned joins), as
tests/test_torch_q4q13q19q7.py runs its queries.

Tolerances: keys and counts exact; rows compare after a sort on every
column.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import quokka_tpu
import quokka_tpu.optimizer as ref_optimizer
import quokka_tpu_torch
import quokka_tpu_torch.optimizer as port_optimizer
import tpch_data
from quokka_tpu.dataset.readers import InputArrowDataset as RefArrowDataset
from quokka_tpu.parallel.mesh import make_mesh as ref_make_mesh
from quokka_tpu_torch import logical
from quokka_tpu_torch.dataset.readers import InputArrowDataset
from quokka_tpu_torch.ops import fuse, join, stagefuse, strategy
from quokka_tpu_torch.parallel.mesh import make_mesh

from torch_port_util import fresh_aot  # noqa: F401

KINDS = ["uniform", "skew", "nulls"]
NAMES = np.array(["ab", "cd", "ef", "gh", "ij"], dtype=object)


def _table(kind: str, n: int = 3000) -> pa.Table:
    r = np.random.default_rng(KINDS.index(kind) + 17)
    if kind == "skew":
        k = np.minimum(r.zipf(1.5, n), 400).astype(np.int64)
    else:
        k = r.integers(0, 120, n).astype(np.int64)
    s = NAMES[r.integers(0, len(NAMES), n)]
    v = r.integers(0, 3, n) * 0.5
    kmask = smask = None
    if kind == "nulls":
        kmask, smask = r.random(n) < 0.05, r.random(n) < 0.05
    return pa.table({"k": pa.array(k, mask=kmask), "s": pa.array(s.tolist(), mask=smask),
                     "v": v})


def _stream(pkg, ctx, table, batch_rows=256):
    reader = (InputArrowDataset if pkg is quokka_tpu_torch else RefArrowDataset)(
        table, batch_rows=batch_rows)
    return ctx.read_dataset(reader)


def _ctx(pkg):
    if pkg is quokka_tpu_torch:
        return pkg.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    return pkg.QuokkaContext(io_channels=2, exec_channels=2)


def _rows(df):
    """The rows as a sorted list of tuples, nulls as None."""
    df = df.astype(object).where(pd.notna(df), None)
    return sorted(map(tuple, df.itertuples(index=False)), key=repr)


class _Calls:
    """Counts the general join's calls and its semi / anti plans."""

    def __init__(self, monkeypatch):
        self.general, self.anti = 0, 0
        real_general = join.hash_join_general

        def general(*a, **kw):
            self.general += 1
            self.anti += (kw.get("how", a[4] if len(a) > 4 else "inner") == "anti")
            return real_general(*a, **kw)

        monkeypatch.setattr(join, "hash_join_general", general)


QUERIES = {
    "composite": lambda s: s.select(["k", "s"]).distinct(),
    "one_key": lambda s: s.distinct(["k"]),
    "every_column": lambda s: s.distinct(),
    "filtered": lambda s: s.select(["k", "s"]).distinct().filter_sql("k > 10"),
}


def _pandas(query, df):
    if query == "one_key":
        return df[["k"]].drop_duplicates()
    if query == "every_column":
        return df.drop_duplicates()
    out = df[["k", "s"]].drop_duplicates()
    if query == "filtered":
        out = out[out.k > 10]
    return out


@pytest.mark.parametrize("query", list(QUERIES))
@pytest.mark.parametrize("kind", KINDS)
def test_distinct_matches_reference_and_pandas(kind, query, monkeypatch, fresh_aot):
    table = _table(kind)
    calls = _Calls(monkeypatch)
    got = QUERIES[query](_stream(quokka_tpu_torch, _ctx(quokka_tpu_torch), table)).collect()
    ref = QUERIES[query](_stream(quokka_tpu, _ctx(quokka_tpu), table)).collect()
    assert calls.anti > 0, "no channel ran its anti join against the keys seen"
    assert list(got.columns) == list(ref.columns)
    assert _rows(got) == _rows(ref)
    want = _pandas(query, table.to_pandas())
    if kind == "nulls":
        # the same distinct rows; a null key may come once a batch
        assert sorted(set(_rows(got)), key=repr) == _rows(want)
        assert len(got) > len(want)
    else:
        assert _rows(got) == _rows(want)


def test_filter_moves_below_distinct(fresh_aot):
    """A filter over a distinct runs below it (reference optimizer.py:209):
    the distinct's input is the filtered stream, and nothing filters above
    it."""
    ctx = _ctx(quokka_tpu_torch)
    ds = QUERIES["filtered"](_stream(quokka_tpu_torch, ctx, _table("uniform")))
    sub, sink = ctx._prepare_plan(ds.node_id)
    kinds = {}

    def names(node):
        """The node's kind, or its members' kinds in a fused stage."""
        members = getattr(node, "members", None)
        return [type(m).__name__ for m in members] if members else [type(node).__name__]

    def walk(nid, above):
        node = sub[nid]
        for kind in names(node):
            kinds.setdefault(kind, []).append(above)
        if isinstance(node, logical.SourceNode) and node.predicate is not None:
            kinds.setdefault("FilterNode", []).append(above)
        for p in node.parents:
            walk(p, above + names(node))

    walk(sink, [])
    (above_distinct,) = kinds["DistinctNode"]
    assert "FilterNode" not in above_distinct
    (above_filter,) = kinds["FilterNode"]
    assert "DistinctNode" in above_filter
    # a distinct's input is pruned to its keys (reference optimizer.py:377)
    (src,) = [n for n in sub.values() if isinstance(n, logical.SourceNode)]
    assert src.schema == ["k", "s"]


def test_distinct_keys_must_exist():
    ctx = _ctx(quokka_tpu_torch)
    with pytest.raises(ValueError, match="nope"):
        _stream(quokka_tpu_torch, ctx, _table("uniform")).distinct(["k", "nope"])


# ---------------------------------------------------------------------------
# TPC-H Q21
# ---------------------------------------------------------------------------

THRESHOLDS = {"broadcast": None, "partitioned": 100}


@pytest.fixture(scope="module", params=KINDS)
def env(request, tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=11, skew=request.param == "skew",
                                nulls=request.param == "nulls")
    root = tmp_path_factory.mktemp(f"tpch_q21_{request.param}")
    paths = tpch_data.write_parquet_dir(tables, str(root))
    return request.param, paths, {k: t.to_pandas() for k, t in tables.items()}


def _nation(dfs):
    """Q21's nation: the modal supplier nation (the mini data's 30 suppliers
    may not cover SAUDI ARABIA), as tests/test_tpch2.py::test_q21 picks it."""
    su, n = dfs["supplier"], dfs["nation"]
    key = int(su.s_nationkey.mode()[0])
    return key, n[n.n_nationkey == key].n_name.iloc[0]


def q21(pkg, ctx, paths, nat_name):
    """tests/test_tpch2.py::test_q21's query."""
    s = {name: ctx.read_parquet(p) for name, p in paths.items()}
    late = s["lineitem"].filter_sql("l_receiptdate > l_commitdate")
    n_supp = (s["lineitem"].select(["l_orderkey", "l_suppkey"]).distinct()
              .groupby("l_orderkey").agg_sql("count(*) as n_supp")
              .rename({"l_orderkey": "ns_orderkey"}))
    n_late = (late.select(["l_orderkey", "l_suppkey"]).distinct()
              .groupby("l_orderkey").agg_sql("count(*) as n_late")
              .rename({"l_orderkey": "nl_orderkey"}))
    return (late.select(["l_orderkey", "l_suppkey"]).distinct()
            .join(s["orders"].filter_sql("o_orderstatus = 'F'"),
                  left_on="l_orderkey", right_on="o_orderkey", how="semi")
            .join(n_supp, left_on="l_orderkey", right_on="ns_orderkey")
            .join(n_late, left_on="l_orderkey", right_on="nl_orderkey")
            .filter_sql("n_supp > 1 and n_late = 1")
            .join(s["supplier"], left_on="l_suppkey", right_on="s_suppkey")
            .join(s["nation"].filter_sql(f"n_name = '{nat_name}'"),
                  left_on="s_nationkey", right_on="n_nationkey", how="semi")
            .groupby("s_name")
            .agg_sql("count(*) as numwait"))


def pandas_q21(dfs, nat_key):
    l, o, su = dfs["lineitem"], dfs["orders"], dfs["supplier"]
    pairs = l[["l_orderkey", "l_suppkey"]].drop_duplicates()
    ns = pairs.groupby("l_orderkey").size().rename("n_supp")
    lf = l[l.l_receiptdate > l.l_commitdate]
    lpairs = lf[["l_orderkey", "l_suppkey"]].drop_duplicates()
    nl = lpairs.groupby("l_orderkey").size().rename("n_late")
    fkeys = set(o[o.o_orderstatus == "F"].o_orderkey)
    j = lpairs.merge(ns, on="l_orderkey").merge(nl, on="l_orderkey")
    j = j[j.l_orderkey.isin(fkeys) & (j.n_supp > 1) & (j.n_late == 1)]
    j = j[j.l_suppkey.isin(set(su[su.s_nationkey == nat_key].s_suppkey))]
    return (j.merge(su, left_on="l_suppkey", right_on="s_suppkey")
            .groupby("s_name").size().reset_index(name="numwait"))


def _sorted(df):
    return df.sort_values("s_name").reset_index(drop=True)[["s_name", "numwait"]]


@pytest.mark.parametrize("layout", list(THRESHOLDS))
@pytest.mark.parametrize("join_build", ["hashtable", "sort"])
def test_q21_matches_reference_and_pandas(env, layout, join_build, monkeypatch, fresh_aot):
    kind, paths, dfs = env
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"join_build={join_build}")
    if THRESHOLDS[layout] is not None:
        monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", THRESHOLDS[layout])
        monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", THRESHOLDS[layout])
    strategy.reset_used()
    calls = _Calls(monkeypatch)
    fallbacks, sequential = fuse.FALLBACKS, stagefuse.SEQUENTIAL
    nat_key, nat_name = _nation(dfs)
    got = q21(quokka_tpu_torch, _ctx(quokka_tpu_torch), paths, nat_name).collect()
    assert fuse.FALLBACKS == fallbacks and stagefuse.SEQUENTIAL == sequential
    assert calls.anti > 0, "Q21's distincts ran no anti join against the keys seen"
    ref = q21(quokka_tpu, _ctx(quokka_tpu), paths, nat_name).collect()
    assert len(got) > 0
    pd.testing.assert_frame_equal(_sorted(got), _sorted(ref), check_dtype=False)
    if kind != "nulls":
        pd.testing.assert_frame_equal(_sorted(got), _sorted(pandas_q21(dfs, nat_key)),
                                      check_dtype=False)


def test_q21_plan_has_three_distincts(env):
    _, paths, dfs = env
    ctx = _ctx(quokka_tpu_torch)
    plan = q21(quokka_tpu_torch, ctx, paths, _nation(dfs)[1]).explain()
    assert plan.count("Distinct(['l_orderkey', 'l_suppkey'])") == 3


# ---------------------------------------------------------------------------
# the mesh's distinct (reference parallel/mesh_exec.py:1025)
# ---------------------------------------------------------------------------


def _orders():
    r = np.random.default_rng(7)
    n = 1000
    return pa.table({"o_orderkey": np.arange(n, dtype=np.int64),
                     "o_custkey": r.integers(0, 200, n).astype(np.int64),
                     "o_status": np.array(["F", "O", "P"])[r.integers(0, 3, n)]})


MESH_QUERIES = {
    "one_key": lambda ctx, t: ctx.from_arrow(t).select(["o_custkey"]).distinct().collect(),
    "composite": lambda ctx, t: ctx.from_arrow(t).select(["o_custkey", "o_status"])
    .distinct().collect(),
    "then_groupby": lambda ctx, t: ctx.from_arrow(t).select(["o_custkey", "o_status"])
    .distinct().groupby("o_status").agg_sql("count(*) as n").collect(),
}


@pytest.mark.parametrize("query", list(MESH_QUERIES))
def test_mesh_distinct_matches_reference_mesh_and_engine(query, fresh_aot):
    """The port's mesh (eight shards) against the reference's mesh on the
    suite's eight virtual devices and against the port's engine; both meshes
    run it with no fallback."""
    t = _orders()
    mctx = quokka_tpu_torch.QuokkaContext(device="cpu", mesh=make_mesh(8, device="cpu"))
    got = MESH_QUERIES[query](mctx, t)
    assert mctx.last_mesh_fallback is None, mctx.last_mesh_fallback
    rctx = quokka_tpu.QuokkaContext(mesh=ref_make_mesh(8))
    ref = MESH_QUERIES[query](rctx, t)
    assert rctx.last_mesh_fallback is None
    assert list(got.columns) == list(ref.columns)
    assert _rows(got) == _rows(ref)
    assert _rows(got) == _rows(MESH_QUERIES[query](quokka_tpu_torch.QuokkaContext(device="cpu"),
                                                   t))
    if query == "one_key":
        assert len(got) == t.column("o_custkey").to_pandas().nunique()
