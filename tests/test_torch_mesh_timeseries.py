"""The time-series tier on the PyTorch port's mesh (``mesh_exec.mesh_asof``,
``mesh_window_agg``, ``mesh_session_window``, ``mesh_sliding_window``,
``mesh_shift``) against the reference's mesh on the suite's 8 virtual CPU
devices and the port's engine: the tests of tests/test_mesh_timeseries.py
but ``TestMeshCEP`` (pattern recognition is not ported).

Results compare after a sort on every column, ints exactly and floats to
rtol 1e-9.  By-less operators and fine hops fall back to the engine loudly
(``last_mesh_fallback`` names why), as the reference's do.  The port takes
int64 times as they are (the reference rebases wide ones onto int32), so
the ns-timestamp tests run the same shapes without a rebase.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import quokka_tpu
import quokka_tpu.windows as ref_windows
import quokka_tpu_torch.windows as port_windows
from quokka_tpu.parallel.mesh import make_mesh as ref_make_mesh
from quokka_tpu_torch import QuokkaContext
from quokka_tpu_torch.parallel.mesh import make_mesh

from test_mesh_timeseries import _make_ns_ticks
from test_timeseries import make_ticks
import torch_port_util  # noqa: F401  (each test process gets its own reference AOT store)

RTOL = 1e-9
_REF = {}


@pytest.fixture(scope="module")
def ticks(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mesh_ticks")
    trades, quotes = make_ticks()
    tp, qp = str(root / "trades.parquet"), str(root / "quotes.parquet")
    pq.write_table(trades, tp, row_group_size=512)
    pq.write_table(quotes, qp, row_group_size=512)
    return tp, qp


@pytest.fixture(scope="module")
def ns_ticks(tmp_path_factory):
    return _make_ns_ticks(tmp_path_factory)


def W(ctx):
    """The window classes of the context's package."""
    return ref_windows if isinstance(ctx, quokka_tpu.QuokkaContext) else port_windows


def mesh_ctx():
    return QuokkaContext(device="cpu", mesh=make_mesh(8, device="cpu"))


def _streams(ctx, tp, qp):
    return (ctx.read_sorted_parquet(tp, sorted_by="time"),
            ctx.read_sorted_parquet(qp, sorted_by="time"))


def _norm(df):
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def assert_same(got, exp):
    assert list(got.columns) == list(exp.columns)
    pd.testing.assert_frame_equal(_norm(got), _norm(exp), check_dtype=False, rtol=RTOL)


def on_mesh(name, build):
    """The port's mesh result, held against the reference's mesh (run once
    per process) and the port's engine; both meshes must stay on the mesh."""
    mctx = mesh_ctx()
    got = build(mctx)
    assert mctx.last_mesh_fallback is None, mctx.last_mesh_fallback
    if name not in _REF:
        rctx = quokka_tpu.QuokkaContext(mesh=ref_make_mesh(8))
        _REF[name] = (build(rctx), rctx.last_mesh_fallback)
    ref, ref_fallback = _REF[name]
    assert ref_fallback is None, ref_fallback
    assert_same(got, ref)
    assert_same(got, build(QuokkaContext(device="cpu")))
    return got


def falls_back(build, word):
    """A loud fallback on the port's mesh, with the engine's result."""
    mctx = mesh_ctx()
    got = build(mctx)
    assert mctx.last_mesh_fallback is not None and word in mctx.last_mesh_fallback
    assert_same(got, build(QuokkaContext(device="cpu")))


class TestMeshAsof:
    @pytest.mark.parametrize("direction", ["backward", "forward"])
    def test_asof_matches_reference_and_engine(self, ticks, direction):
        tp, qp = ticks

        def q(ctx):
            t, qs = _streams(ctx, tp, qp)
            return t.join_asof(qs, on="time", by="symbol", direction=direction).collect()

        on_mesh(f"asof {direction}", q)

    def test_asof_then_agg(self, ticks):
        tp, qp = ticks

        def q(ctx):
            t, qs = _streams(ctx, tp, qp)
            return (t.join_asof(qs, on="time", by="symbol").groupby("symbol")
                    .agg_sql("sum(size) as total_size, count(*) as n").collect())

        on_mesh("asof then agg", q)

    def test_byless_asof_falls_back_loudly(self, ticks):
        tp, qp = ticks

        def q(ctx):
            t, qs = _streams(ctx, tp, qp)
            return t.join_asof(qs, on="time").collect()

        falls_back(q, "asof")


class TestMeshWindows:
    def test_tumbling_matches(self, ticks):
        tp, qp = ticks
        on_mesh("tumbling", lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).TumblingWindow(10_000),
            "sum(size) as total, count(*) as n, avg(size) as mean_sz", by="symbol").collect())

    def test_hopping_matches(self, ticks):
        tp, qp = ticks
        on_mesh("hopping", lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).HoppingWindow(20_000, 10_000), "count(*) as n, sum(size) as total",
            by="symbol").collect())

    def test_fine_hop_falls_back_loudly(self, ticks):
        tp, qp = ticks
        falls_back(lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).HoppingWindow(50_000, 1_000), "count(*) as n", by="symbol").collect(),
            "replication")

    def test_session_matches(self, ticks):
        tp, qp = ticks
        on_mesh("session", lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).SessionWindow(50), "sum(size) as total, count(*) as n, avg(size) as mean_sz",
            by="symbol").collect())

    def test_sliding_matches(self, ticks):
        tp, qp = ticks
        on_mesh("sliding", lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).SlidingWindow(5_000),
            "sum(size) as roll_sum, count(*) as roll_n, max(size) as roll_max",
            by="symbol").collect())

    def test_sliding_zero_key_not_polluted_by_shuffle_padding(self):
        # the shuffle zero-fills padding; a last key whose limbs are all
        # zero (integer key 0) must not take it in
        r = np.random.default_rng(3)
        n = 64
        t = pa.table({"time": np.arange(n, dtype=np.int64) * 100,
                      "k": np.zeros(n, dtype=np.int64),
                      "v": r.integers(1, 10, n).astype(np.int64)})
        got = on_mesh("sliding zero key", lambda ctx: ctx.from_arrow_sorted(
            t, sorted_by="time").window_agg(W(ctx).SlidingWindow(5000), "sum(v) as sv",
                                            by="k").collect())
        d = t.to_pandas()
        exp = [int(d.v[(d.time >= d.time[i] - 5000) & (d.time <= d.time[i])].sum())
               for i in range(n)]
        got = got.sort_values("time").reset_index(drop=True)
        np.testing.assert_array_equal(got.sv.to_numpy().astype(np.int64), np.array(exp))

    def test_byless_session_falls_back_loudly(self, ticks):
        tp, qp = ticks
        falls_back(lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).SessionWindow(7), "count(*) as n").collect(), "session")


@pytest.fixture(scope="module")
def unique_ticks(tmp_path_factory):
    # unique (symbol, time) pairs: with ties the lag target depends on the
    # reader's order in the engine too
    r = np.random.default_rng(29)
    n, nsym = 4000, 5
    times = np.sort(r.choice(500_000, n, replace=False)).astype(np.int64)
    t = pa.table({"time": times,
                  "symbol": np.array([f"S{i}" for i in range(nsym)])[r.integers(0, nsym, n)],
                  "size": r.integers(1, 500, n).astype(np.int64),
                  "px": r.uniform(1, 100, n).round(3)})
    p = str(tmp_path_factory.mktemp("torch_shift_ticks") / "t.parquet")
    pq.write_table(t, p, row_group_size=512)
    return p, t.to_pandas()


class TestMeshShift:
    @pytest.mark.parametrize("n", [1, 3])
    def test_shift_matches_reference_engine_and_pandas(self, unique_ticks, n):
        tp, tdf = unique_ticks
        got = on_mesh(f"shift {n}", lambda ctx: ctx.read_sorted_parquet(
            tp, sorted_by="time").shift(["size", "px"], n=n, by="symbol").collect())
        keys = ["symbol", "time"]
        got = got.sort_values(keys).reset_index(drop=True)
        d = tdf.sort_values(keys)
        oracle = d.groupby("symbol").px.shift(n).reindex(d.index)
        merged = d.assign(px_oracle=oracle).sort_values(keys).reset_index(drop=True)
        np.testing.assert_allclose(got[f"px_shifted_{n}"].to_numpy(),
                                   merged.px_oracle.to_numpy(), equal_nan=True)

    def test_byless_shift_falls_back_loudly(self, ticks):
        tp, qp = ticks
        falls_back(lambda ctx: _streams(ctx, tp, qp)[0].shift(["size"], n=1).collect(),
                   "shift")


class TestMeshWideTimestamps:
    """ns-epoch int64 times: the reference's wide branches, the port's
    int64 times as they are."""

    @pytest.mark.parametrize("direction", ["backward", "forward"])
    def test_ns_asof_vs_pandas(self, ns_ticks, direction):
        tp, qp, tdf, qdf = ns_ticks

        def q(ctx):
            t, qs = _streams(ctx, tp, qp)
            return t.join_asof(qs, on="time", by="symbol", direction=direction).collect()

        got = on_mesh(f"ns asof {direction}", q)
        exp = pd.merge_asof(tdf.sort_values("time"), qdf.sort_values("time"), on="time",
                            by="symbol", direction=direction).dropna(subset=["bid"])
        keys = ["symbol", "time", "size"]
        got = got.sort_values(keys).reset_index(drop=True)
        exp = exp.sort_values(keys).reset_index(drop=True)
        assert len(got) == len(exp)
        np.testing.assert_allclose(got.bid.to_numpy(), exp.bid.to_numpy(), rtol=RTOL)

    def test_ns_tumbling_vs_pandas(self, ns_ticks):
        tp, qp, tdf, _ = ns_ticks
        size = 100_000_000  # 0.1 s in ns
        got = on_mesh("ns tumbling", lambda ctx: _streams(ctx, tp, qp)[0].window_agg(
            W(ctx).TumblingWindow(size), "sum(size) as total, count(*) as n",
            by="symbol").collect())
        d = tdf.copy()
        d["w"] = (d.time // size) * size
        exp = (d.groupby(["symbol", "w"]).agg(total=("size", "sum"), n=("size", "size"))
               .reset_index().sort_values(["symbol", "w"]).reset_index(drop=True))
        got = got.sort_values(["symbol", "window_start"]).reset_index(drop=True)
        np.testing.assert_array_equal(got.window_start.to_numpy(), exp.w.to_numpy())
        np.testing.assert_array_equal(got.total.to_numpy(), exp.total.to_numpy())
        np.testing.assert_array_equal(got.n.to_numpy(), exp.n.to_numpy())
