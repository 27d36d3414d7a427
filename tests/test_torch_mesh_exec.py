"""Mesh execution of the PyTorch port (``QuokkaContext(mesh=...)``,
``quokka_tpu_torch/parallel/mesh_exec.py``) against the reference's mesh on
the suite's 8 virtual CPU devices and against the port's own engine: the
tests of tests/test_mesh_exec.py (all but ``test_distinct``: the port has no
DistinctNode yet) and the nine queries of tests/test_mesh_tpch.py.

Every result is held against the reference's mesh result and the port's
engine result, after a sort on every column: keys exactly, floats to rtol
1e-9 (another summation order, the suite's tolerance).  Each mesh run must
stay on the mesh (``last_mesh_fallback is None``) where the reference's
does, and fall back loudly where the reference's does.  The reference's
results are computed once per module.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

import quokka_tpu
from quokka_tpu.parallel.mesh import make_mesh as ref_make_mesh
from quokka_tpu_torch import QuokkaContext
from quokka_tpu_torch.parallel import mesh_exec
from quokka_tpu_torch.parallel.mesh import make_mesh

import tpch_data
from test_mesh_exec import q3, tiny_tpch
from test_mesh_tpch import QUERIES
import torch_port_util  # noqa: F401  (each test process gets its own reference AOT store)

RTOL = 1e-9
_REF = {}


def mesh_ctx():
    return QuokkaContext(device="cpu", mesh=make_mesh(8, device="cpu"))


def reference_mesh(name, build):
    """The reference mesh's result of one query, once per test process; it
    must run on the mesh."""
    if name not in _REF:
        ctx = quokka_tpu.QuokkaContext(mesh=ref_make_mesh(8))
        _REF[name] = (build(ctx), ctx.last_mesh_fallback)
    return _REF[name]


def _norm(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def assert_same(got, exp):
    assert list(got.columns) == list(exp.columns)
    pd.testing.assert_frame_equal(_norm(got), _norm(exp), check_dtype=False, rtol=RTOL)


def check_three_ways(name, build):
    """The port's mesh against the reference's mesh and the port's engine."""
    mctx = mesh_ctx()
    got = build(mctx)
    assert mctx.last_mesh_fallback is None, mctx.last_mesh_fallback
    ref, ref_fallback = reference_mesh(name, build)
    assert ref_fallback is None
    assert_same(got, ref)
    assert_same(got, build(QuokkaContext(device="cpu")))
    return got


@pytest.fixture(scope="module")
def tpch_tables():
    return tiny_tpch(None)


class TestMeshMatchesEngine:
    def test_q3_shape(self, tpch_tables):
        customer, orders, lineitem = tpch_tables
        check_three_ways("q3 shape", lambda ctx: q3(ctx, customer, orders, lineitem))

    def test_groupby_string_key(self, tpch_tables):
        customer, _, _ = tpch_tables
        check_three_ways("string key", lambda ctx: ctx.from_arrow(customer)
                         .groupby("c_mktsegment").agg_sql("count(*) as n").collect())

    @pytest.mark.parametrize("how", ["semi", "anti", "left", "inner"])
    def test_semi_anti_left(self, tpch_tables, how):
        customer, orders, _ = tpch_tables

        def q(ctx):
            o = ctx.from_arrow(orders)
            c = ctx.from_arrow(customer).filter_sql("c_mktsegment = 'MACHINERY'")
            return o.join(c, left_on="o_custkey", right_on="c_custkey", how=how).collect()

        got = check_three_ways(f"join {how}", q)
        if how == "left":
            assert got.c_mktsegment.isna().any()

    def test_agg_with_orderby_limit(self, tpch_tables):
        _, _, lineitem = tpch_tables
        got = check_three_ways("top-k", lambda ctx: ctx.from_arrow(lineitem)
                               .groupby("l_orderkey").agg_sql("sum(l_extendedprice) as total")
                               .top_k(["total"], 5, descending=[True]).collect())
        assert len(got) == 5

    def test_keyless_agg(self, tpch_tables):
        _, _, lineitem = tpch_tables
        check_three_ways("keyless", lambda ctx: ctx.from_arrow(lineitem).agg_sql(
            "sum(l_extendedprice) as s, count(*) as n, avg(l_discount) as a").collect())

    def test_asof_plan_runs_on_the_mesh(self):
        # an as-of join by symbol: the reference's test of a plan that once
        # fell back; both meshes now run it
        trades = pa.table({"time": np.arange(10, dtype=np.int64), "sym": ["A"] * 10})
        quotes = pa.table({"time": np.arange(0, 10, 2, dtype=np.int64), "sym": ["A"] * 5,
                           "bid": np.arange(5).astype(np.float64)})

        def q(ctx):
            t = ctx.from_arrow_sorted(trades, sorted_by="time")
            return t.join_asof(ctx.from_arrow_sorted(quotes, sorted_by="time"), on="time",
                               by="sym").collect()

        assert len(check_three_ways("asof plan", q)) == 10


class TestMeshManyToMany:
    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_mm_inner_and_left(self, how):
        r = np.random.default_rng(21)
        # repeated build keys: the many-to-many path
        build = pa.table({"k": r.integers(0, 50, 300).astype(np.int64),
                          "w": r.uniform(0, 1, 300).round(5)})
        probe = pa.table({"k": r.integers(0, 100, 800).astype(np.int64),
                          "v": r.uniform(0, 1, 800).round(5)})
        got = check_three_ways(f"mm {how}", lambda ctx: ctx.from_arrow(probe).join(
            ctx.from_arrow(build), on="k", how=how).collect())
        exp = probe.to_pandas().merge(build.to_pandas(), on="k", how=how)
        assert len(got) == len(exp)
        np.testing.assert_allclose(got.w.sum(), exp.w.dropna().sum(), rtol=RTOL)
        if how == "left":
            assert got.w.isna().sum() == exp.w.isna().sum()

    def test_mm_overflow_falls_back(self, monkeypatch):
        monkeypatch.setattr(mesh_exec, "MM_CAPACITY_FACTOR", 1)
        # every probe row matches 40 build rows: past a capacity of 1x
        build = pa.table({"k": np.zeros(40, dtype=np.int64),
                          "w": np.arange(40).astype(np.float64)})
        probe = pa.table({"k": np.zeros(100, dtype=np.int64),
                          "v": np.arange(100).astype(np.float64)})
        ctx = mesh_ctx()
        got = ctx.from_arrow(probe).join(ctx.from_arrow(build), on="k").collect()
        assert ctx.last_mesh_fallback is not None and "overflow" in ctx.last_mesh_fallback
        assert len(got) == 4000  # the engine's full product


def test_a_kernel_fault_propagates_instead_of_falling_back(monkeypatch):
    """Only a plan-shape refusal falls back: a fault inside a mesh kernel
    propagates instead of quietly running the engine."""
    from quokka_tpu_torch.ops import kernels

    t = pa.table({"k": np.arange(64, dtype=np.int64), "v": np.ones(64)})

    def broken(*a, **kw):
        raise RuntimeError("K24 failed to launch")

    monkeypatch.setattr(kernels, "mesh_bucketize", broken)
    ctx = mesh_ctx()
    with pytest.raises(RuntimeError, match="K24 failed"):
        ctx.from_arrow(t).groupby("k").agg_sql("sum(v) as s").collect()


# ---------------------------------------------------------------------------
# tests/test_mesh_tpch.py: nine TPC-H queries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mesh_tpch")
    return tpch_data.write_parquet_dir(tpch_data.generate(sf=0.0015, seed=23), str(root))


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_mesh_equals_engine(tpch_paths, name):
    def build(ctx):
        s = {k: ctx.read_parquet(p) for k, p in tpch_paths.items()}
        return QUERIES[name](ctx, s)

    check_three_ways(f"tpch {name}", build)
