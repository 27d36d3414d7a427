"""The time-series tier of the PyTorch port against pandas and the
reference (quokka_tpu, JAX x64 on the CPU): the tests of
tests/test_timeseries.py and tests/test_asof_ties.py, run through
quokka_tpu_torch on the CPU.

Every as-of query runs under both asof strategies (``searchsorted``, K18;
``sort``, K19) and every query with one and with two exec channels.  Ints
and indices compare exactly, floats to rtol 1e-9 (another summation
order).  The reference's CEP test (``pattern_recognize``) has a guard test
here instead: that operator is not ported and raises.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import quokka_tpu
import quokka_tpu.windows as ref_windows
import quokka_tpu_torch.windows as port_windows
from quokka_tpu_torch import QuokkaContext, logical
from quokka_tpu_torch.datastream import OrderedStream
from quokka_tpu_torch.dataset.readers import InputArrowDataset
from quokka_tpu_torch.ops import asof, bridge, kernels
from quokka_tpu_torch.ops import strategy as kstrategy
from quokka_tpu_torch.windows import OnCompletionTrigger, TumblingWindow

from torch_port_util import fresh_aot  # noqa: F401

STRATEGIES = ["searchsorted", "sort"]
CHANNELS = [1, 2]


def make_ticks(n_trades=3000, n_quotes=6000, n_symbols=5, seed=3):
    r = np.random.default_rng(seed)
    syms = np.array([f"SYM{i}" for i in range(n_symbols)])
    trades = pa.table({
        "time": np.sort(r.integers(0, 100_000, n_trades)).astype(np.int64),
        "symbol": syms[r.integers(0, n_symbols, n_trades)],
        "size": r.integers(1, 500, n_trades).astype(np.int64),
    })
    # unique quote times: pandas' oracle is order-dependent on (symbol, time)
    # duplicates (ties have their own tests below)
    qtimes = np.sort(r.choice(100_000, n_quotes, replace=False)).astype(np.int64)
    quotes = pa.table({
        "time": qtimes,
        "symbol": syms[r.integers(0, n_symbols, n_quotes)],
        "bid": r.uniform(10, 20, n_quotes).round(3),
    })
    return trades, quotes


@pytest.fixture(scope="module")
def ticks(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ticks")
    trades, quotes = make_ticks()
    tp, qp = str(root / "trades.parquet"), str(root / "quotes.parquet")
    pq.write_table(trades, tp, row_group_size=512)
    pq.write_table(quotes, qp, row_group_size=512)
    return tp, qp, trades.to_pandas(), quotes.to_pandas()


_REF = {}


def reference(name, build):
    """The reference's result of one query, run once per test process."""
    if name not in _REF:
        _REF[name] = build(quokka_tpu.QuokkaContext())
    return _REF[name]


def windows_of(ctx):
    """The window classes of the context's package."""
    return ref_windows if isinstance(ctx, quokka_tpu.QuokkaContext) else port_windows


def ctx_of(channels):
    return QuokkaContext(io_channels=2, exec_channels=channels, device="cpu")


@pytest.fixture
def asof_strategy(request, monkeypatch):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"asof={request.param}")
    kstrategy.reset_used()
    yield request.param
    assert kstrategy.used_snapshot().get("asof") in (None, request.param)


def _sorted(df, key):
    return df.sort_values(key).reset_index(drop=True)


def _same(got, exp, key, exact=(), close=()):
    got, exp = _sorted(got, key), _sorted(exp, key)
    assert len(got) == len(exp)
    for c in list(key) + list(exact):
        np.testing.assert_array_equal(got[c].to_numpy(), exp[c].to_numpy())
    for c in close:
        np.testing.assert_allclose(got[c].to_numpy(), exp[c].to_numpy(), rtol=1e-9)


# ---------------------------------------------------------------------------
# as-of join
# ---------------------------------------------------------------------------


class TestAsof:
    @pytest.mark.parametrize("asof_strategy", STRATEGIES, indirect=True)
    @pytest.mark.parametrize("channels", CHANNELS)
    def test_asof_join_parquet(self, ticks, asof_strategy, channels, fresh_aot):
        tp, qp, tdf, qdf = ticks

        def q(ctx):
            t = ctx.read_sorted_parquet(tp, sorted_by="time")
            return t.join_asof(ctx.read_sorted_parquet(qp, sorted_by="time"), on="time",
                               by="symbol").collect()

        got = q(ctx_of(channels))
        exp = pd.merge_asof(tdf, qdf, on="time", by="symbol",
                            direction="backward").dropna(subset=["bid"])
        key = ["time", "symbol", "size"]
        _same(got, exp, key, exact=["bid"])
        _same(got, reference("asof_parquet", q), key, exact=["bid"])

    @pytest.mark.parametrize("asof_strategy", STRATEGIES, indirect=True)
    @pytest.mark.parametrize("channels", CHANNELS)
    def test_asof_then_agg(self, ticks, asof_strategy, channels, fresh_aot):
        tp, qp, tdf, qdf = ticks

        def q(ctx):
            t = ctx.read_sorted_parquet(tp, sorted_by="time")
            return (t.join_asof(ctx.read_sorted_parquet(qp, sorted_by="time"), on="time",
                                by="symbol")
                    .with_columns_sql("bid * size as notional")
                    .groupby("symbol").agg_sql("sum(notional) as total, count(*) as n")
                    .collect())

        got = q(ctx_of(channels))
        m = pd.merge_asof(tdf, qdf, on="time", by="symbol").dropna(subset=["bid"])
        exp = (m.assign(notional=m.bid * m["size"]).groupby("symbol")
               .agg(total=("notional", "sum"), n=("notional", "size")).reset_index())
        _same(got, exp, ["symbol"], exact=["n"], close=["total"])
        _same(got, reference("asof_agg", q), ["symbol"], exact=["n"], close=["total"])


class TestAsofTies:
    @pytest.mark.parametrize("asof_strategy", STRATEGIES, indirect=True)
    def test_equal_time_quote_wins_and_last_duplicate_used(self, asof_strategy):
        ctx = ctx_of(1)
        trades = pa.table({"time": np.array([5, 10], dtype=np.int64), "symbol": ["A", "A"]})
        quotes = pa.table({"time": np.array([5, 10, 10], dtype=np.int64),
                           "symbol": ["A", "A", "A"], "bid": [1.0, 2.0, 3.0]})
        t = ctx.from_arrow_sorted(trades, sorted_by="time")
        q = ctx.from_arrow_sorted(quotes, sorted_by="time")
        got = t.join_asof(q, on="time", by="symbol").collect().sort_values("time")
        # a same-time quote matches (backward includes ties); among quotes at
        # one time, the later row wins
        assert got.bid.tolist() == [1.0, 3.0]


def _streamed(ctx, table, batch_rows):
    reader = InputArrowDataset(table, batch_rows=batch_rows)
    return ctx.new_stream(logical.SourceNode(reader, list(table.column_names),
                                             sorted_by=["time"]), ordered=True)


class TestAsofForward:
    @pytest.mark.parametrize("asof_strategy", STRATEGIES, indirect=True)
    @pytest.mark.parametrize("channels", CHANNELS)
    def test_forward_asof_lagging_key(self, asof_strategy, channels, fresh_aot):
        # key A's quotes arrive long after its trades: the matched-is-final
        # rule must hold A's trades until those quotes come
        r = np.random.default_rng(4)
        tt = np.arange(0, 1000, dtype=np.int64)
        trades = pa.table({"time": tt,
                           "symbol": np.where(np.arange(1000) % 2 == 0, "A", "B"),
                           "size": r.integers(1, 9, 1000).astype(np.int64)})
        qb = np.arange(1, 1000, 2, dtype=np.int64)
        qa = np.arange(5000, 5010, dtype=np.int64)
        quotes = pa.table({"time": np.concatenate([qb, qa]),
                           "symbol": ["B"] * len(qb) + ["A"] * len(qa),
                           "bid": np.concatenate([qb, qa]).astype(np.float64) / 10})

        def q(ctx, mod):
            return mod(ctx, trades, 64).join_asof(mod(ctx, quotes, 64), on="time",
                                                  by="symbol", direction="forward").collect()

        got = q(ctx_of(channels), _streamed)
        exp = pd.merge_asof(trades.to_pandas(), quotes.to_pandas().sort_values("time"),
                            on="time", by="symbol", direction="forward").dropna(subset=["bid"])
        _same(got, exp, ["symbol", "time"], exact=["bid", "size"])

        def ref_streamed(ctx, table, batch_rows):
            from quokka_tpu import logical as ref_logical
            from quokka_tpu.dataset.readers import InputArrowDataset as RefReader

            return ctx.new_stream(ref_logical.SourceNode(
                RefReader(table, batch_rows=batch_rows), list(table.column_names),
                sorted_by=["time"]), ordered=True)

        _same(got, reference("forward_lagging", lambda c: q(c, ref_streamed)),
              ["symbol", "time"], exact=["bid", "size"])

    @pytest.mark.parametrize("asof_strategy", STRATEGIES, indirect=True)
    def test_forward_asof_single_batch(self, asof_strategy):
        trades = pa.table({"time": np.array([1, 5, 9], dtype=np.int64),
                           "symbol": ["A", "A", "A"]})
        quotes = pa.table({"time": np.array([4, 7], dtype=np.int64),
                           "symbol": ["A", "A"], "bid": [1.0, 2.0]})
        ctx = ctx_of(1)
        t = ctx.from_arrow_sorted(trades, sorted_by="time")
        q = ctx.from_arrow_sorted(quotes, sorted_by="time")
        got = t.join_asof(q, on="time", by="symbol", direction="forward").collect()
        got = got.sort_values("time")
        # t=1 -> quote 4; t=5 -> quote 7; t=9 has none and is dropped
        assert got.time.tolist() == [1, 5]
        assert got.bid.tolist() == [1.0, 2.0]


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


class TestWindows:
    def _oracle_tumbling(self, df, size):
        d = df.assign(w=(df.time // size) * size)
        return (d.groupby(["symbol", "w"]).agg(total=("size", "sum"), n=("size", "size"))
                .reset_index().rename(columns={"w": "window_start"}))

    @pytest.mark.parametrize("channels", CHANNELS)
    def test_tumbling(self, ticks, channels, fresh_aot):
        tp, qp, tdf, qdf = ticks

        def q(ctx):
            t = ctx.read_sorted_parquet(tp, sorted_by="time")
            return t.window_agg(windows_of(ctx).TumblingWindow(10_000),
                                "sum(size) as total, count(*) as n", by="symbol").collect()

        got = q(ctx_of(channels))
        key = ["symbol", "window_start"]
        _same(got, self._oracle_tumbling(tdf, 10_000), key, exact=["total", "n"])
        _same(got, reference("tumbling", q), key, exact=["total", "n", "window_end"])

    def test_tumbling_completion_trigger(self, ticks):
        tp, qp, tdf, qdf = ticks
        t = ctx_of(2).read_sorted_parquet(tp, sorted_by="time")
        got = t.window_agg(TumblingWindow(10_000), "sum(size) as total", by="symbol",
                           trigger=OnCompletionTrigger()).collect()
        exp = self._oracle_tumbling(tdf, 10_000)
        _same(got, exp, ["symbol", "window_start"], exact=["total"])

    @pytest.mark.parametrize("channels", CHANNELS)
    def test_hopping(self, ticks, channels, fresh_aot):
        tp, qp, tdf, qdf = ticks
        size, hop = 20_000, 10_000

        def q(ctx):
            t = ctx.read_sorted_parquet(tp, sorted_by="time")
            return t.window_agg(windows_of(ctx).HoppingWindow(size, hop), "count(*) as n",
                                by="symbol").collect()

        got = q(ctx_of(channels))
        frames = []
        for j in range(size // hop):
            dd = tdf.assign(window_start=(tdf.time // hop - j) * hop)
            frames.append(dd[(dd.window_start >= 0) & (dd.time < dd.window_start + size)])
        exp = pd.concat(frames).groupby(["symbol", "window_start"]).size().reset_index(name="n")
        key = ["symbol", "window_start"]
        _same(got, exp, key, exact=["n"])
        _same(got, reference("hopping", q), key, exact=["n", "window_end"])

    def test_session(self):
        t = pa.table({
            "time": np.array([0, 5, 8, 100, 103, 500, 1000, 1004, 1009], dtype=np.int64),
            "symbol": ["A"] * 9,
            "size": np.arange(1, 10, dtype=np.int64),
        })

        def q(ctx):
            s = ctx.from_arrow_sorted(t, sorted_by="time")
            return s.window_agg(windows_of(ctx).SessionWindow(50),
                                "sum(size) as total, count(*) as n", by="symbol").collect()

        got = q(ctx_of(1)).sort_values("session_start").reset_index(drop=True)
        # sessions: [0, 5, 8], [100, 103], [500], [1000, 1004, 1009]
        assert got.session_start.tolist() == [0, 100, 500, 1000]
        assert got.session_end.tolist() == [8, 103, 500, 1009]
        assert got.total.tolist() == [6, 9, 6, 24]
        assert got.n.tolist() == [3, 2, 1, 3]
        _same(got, reference("session", q), ["session_start"],
              exact=["session_end", "total", "n"])

    @pytest.mark.parametrize("channels", CHANNELS)
    def test_sliding(self, ticks, channels, fresh_aot):
        tp, qp, tdf, qdf = ticks
        size = 5_000

        def q(ctx):
            t = ctx.read_sorted_parquet(tp, sorted_by="time")
            return t.window_agg(windows_of(ctx).SlidingWindow(size), "sum(size) as roll_sum, "
                                "count(*) as roll_n", by="symbol").collect()

        got = q(ctx_of(channels))
        exp = _rolling_oracle(tdf, "symbol", "size", size)
        key = ["symbol", "time", "size"]
        _same(got, exp, key, exact=["roll_sum", "roll_n"])
        _same(got, reference("sliding", q), key, exact=["roll_sum", "roll_n"])


def _rolling_oracle(df, by, col, size):
    """Per row, sum / count / min / max of `col` over the rows of its key
    with time in [t - size, t], by a direct numpy scan."""
    rows = []
    for key, g in df.groupby(by):
        times, vals = g.time.to_numpy(), g[col].to_numpy()
        lo = np.searchsorted(times, times - size, side="left")
        hi = np.searchsorted(times, times, side="right")
        for i in range(len(g)):
            w = vals[lo[i]:hi[i]]
            rows.append((key, times[i], vals[i], w.sum(), len(w), w.min(), w.max()))
    return pd.DataFrame(rows, columns=[by, "time", col, "roll_sum", "roll_n", "lo", "hi"])


class TestSlidingMinMax:
    @pytest.mark.parametrize("channels", CHANNELS)
    def test_rolling_min_max_matches_pandas(self, channels, fresh_aot):
        r = np.random.default_rng(8)
        n = 4000
        t = pa.table({
            "time": np.sort(r.choice(100_000, n, replace=False)).astype(np.int64),
            "sym": np.array(["A", "B"])[r.integers(0, 2, n)],
            "px": r.uniform(10, 20, n).round(4),
        })

        def q(ctx):
            s = ctx.from_arrow_sorted(t, sorted_by="time")
            return s.window_agg(windows_of(ctx).SlidingWindow(500),
                                "min(px) as lo, max(px) as hi, sum(px) as tot",
                                by="sym").collect()

        got = q(ctx_of(channels))
        exp = _rolling_oracle(t.to_pandas(), "sym", "px", 500).rename(
            columns={"roll_sum": "tot"})
        _same(got, exp, ["sym", "time"], exact=["lo", "hi"], close=["tot"])
        _same(got, reference("sliding_minmax", q), ["sym", "time"], exact=["lo", "hi"],
              close=["tot"])


# ---------------------------------------------------------------------------
# ordered-stream metadata, shift, and what is not ported
# ---------------------------------------------------------------------------


class TestOrderedMetadata:
    def test_window_output_sorted_by_window_start(self, ticks):
        tp, qp, tdf, qdf = ticks
        t = ctx_of(2).read_sorted_parquet(tp, sorted_by="time")
        w = t.window_agg(TumblingWindow(10_000), "sum(size) as vol", by="symbol")
        assert w.sorted_by == ["window_start"]

    def test_select_dropping_time_col_demotes_to_plain_stream(self):
        t = pa.table({"time": np.arange(5, dtype=np.int64), "v": np.ones(5)})
        s = ctx_of(1).from_arrow_sorted(t, sorted_by="time")
        assert isinstance(s.select(["time", "v"]), OrderedStream)
        assert not isinstance(s.select(["v"]), OrderedStream)

    def test_ordered_select_validates_columns(self):
        t = pa.table({"time": np.arange(5, dtype=np.int64), "v": np.ones(5)})
        s = ctx_of(1).from_arrow_sorted(t, sorted_by="time")
        with pytest.raises(ValueError):
            s.select(["nope"])


def test_optimizer_keeps_order_and_does_not_fuse_ordered_nodes():
    """Projection pushdown keeps a sorted source's sort column even when no
    consumer reads it, and no fused stage crosses an as-of, window or shift
    node (or the ordered map after the as-of)."""
    t = pa.table({"time": np.arange(8, dtype=np.int64), "s": ["A", "B"] * 4,
                  "v": np.arange(8, dtype=np.float64), "w": np.ones(8)})
    ctx = ctx_of(2)
    src = ctx.from_arrow_sorted(t, sorted_by="time")
    plan = (src.join_asof(ctx.from_arrow_sorted(t.select(["time", "s", "w"]), "time"),
                          on="time", by="s", suffix="_q")
            .with_columns_sql("v * w_q as x").groupby("s").agg_sql("sum(x) as sx").explain())
    assert "FusedStage" not in plan and "AsofJoin" in plan and "Map(" in plan
    # the plain stream after the shift fuses, but the shift stays outside
    shifted = src.shift("v", by="s").select(["s", "v_shifted_1"]).filter_sql(
        "v_shifted_1 > 0")
    plan = shifted.explain()
    shift_line = next(ln for ln in plan.splitlines() if "Shift(" in ln)
    assert shift_line.lstrip().startswith("[")
    assert sorted(shifted.collect().v_shifted_1.tolist()) == [1.0, 2.0, 3.0, 4.0, 5.0]
    plan = src.agg_sql("sum(v) as sv").explain()
    source_line = next(ln for ln in plan.splitlines() if "Source(" in ln)
    assert "schema=['time', 'v']" in source_line


class TestShift:
    @pytest.mark.parametrize("channels", CHANNELS)
    def test_shift_by_key(self, channels):
        t = pa.table({
            "time": np.arange(12, dtype=np.int64),
            "sym": (["A", "B"] * 6),
            "px": np.arange(12, dtype=np.float64) * 1.5,
        })

        def q(ctx):
            return ctx.from_arrow_sorted(t, sorted_by="time").shift(
                "px", n=1, by="sym").collect()

        got = q(ctx_of(channels)).sort_values("time").reset_index(drop=True)
        df = t.to_pandas()
        df["px_shifted_1"] = df.groupby("sym").px.shift(1)
        np.testing.assert_array_equal(got.px_shifted_1.to_numpy(), df.px_shifted_1.to_numpy())
        _same(got, reference("shift", q), ["time"], exact=["px_shifted_1"])

    def test_shift_fill_value_raises(self):
        """The reference's OrderedStream.shift takes fill_value and never
        passes it on (its rows without history stay null); the port raises
        instead of ignoring it."""
        t = pa.table({"time": np.arange(6, dtype=np.int64), "sym": ["A", "B"] * 3,
                      "px": np.arange(6, dtype=np.float64)})

        def q(ctx, **kw):
            return ctx.from_arrow_sorted(t, sorted_by="time").shift(
                "px", n=1, by="sym", **kw).collect()

        with pytest.raises(NotImplementedError, match="fill_value"):
            q(ctx_of(1), fill_value=0.0)
        ignored = q(quokka_tpu.QuokkaContext(), fill_value=0.0).sort_values("time")
        plain = reference("shift fill", q).sort_values("time")
        assert ignored.px_shifted_1.isna().sum() == 2
        np.testing.assert_array_equal(ignored.px_shifted_1.to_numpy(),
                                      plain.px_shifted_1.to_numpy())


def test_keyless_shift_and_sliding_across_batches():
    """Without by-keys every row is one segment; across 700-row batches the
    shift carry and the sliding windows must not read the padding after
    the live rows.  Pandas is the oracle: the reference gets this wrong
    (ROADMAP Queue 3).  One exec channel: without keys the stream is not
    partitioned by key, so only one channel sees it whole."""
    r = np.random.default_rng(2)
    n = 3000
    t = pa.table({"time": np.sort(r.choice(100_000, n, replace=False)).astype(np.int64),
                  "px": r.uniform(10, 20, n).round(3)})
    ctx = ctx_of(1)
    s = ctx.new_stream(logical.SourceNode(InputArrowDataset(t, batch_rows=700),
                                          ["time", "px"], sorted_by=["time"]), ordered=True)
    df = t.to_pandas()
    got = s.shift("px", n=1).collect().sort_values("time")
    np.testing.assert_array_equal(got.px_shifted_1.to_numpy(), df.px.shift(1).to_numpy())
    got = s.window_agg(port_windows.SlidingWindow(500),
                       "sum(px) as tot, count(*) as n").collect()
    exp = _rolling_oracle(df.assign(k=0), "k", "px", 500)
    _same(got.assign(k=0), exp.rename(columns={"roll_sum": "tot", "roll_n": "n"}),
          ["time"], exact=["n"], close=["tot"])


class TestCEP:
    def test_rise_pattern(self):
        """CEP (the reference's pattern_recognize, executors/cep.py) is not
        ported: it raises, naming its ROADMAP item."""
        t = pa.table({"time": np.arange(10, dtype=np.int64), "sym": ["A"] * 10,
                      "px": np.arange(10, dtype=np.float64)})
        s = ctx_of(1).from_arrow_sorted(t, sorted_by="time")
        with pytest.raises(NotImplementedError, match="The rest of the time-series tier"):
            s.pattern_recognize([("low", "px < 10"), ("rise", "px > low.px + 2")],
                                within=5, by="sym")


@pytest.mark.parametrize("call", ["asof_host", "stateful_transform_sorted",
                                  "read_sorted_csv"])
def test_unported_time_series_pieces_raise(call, monkeypatch):
    ctx = ctx_of(1)
    t = pa.table({"time": np.arange(4, dtype=np.int64), "s": ["A"] * 4,
                  "v": np.ones(4)})
    s = ctx.from_arrow_sorted(t, sorted_by="time")
    with pytest.raises(NotImplementedError, match="The rest of the time-series tier"):
        if call == "asof_host":
            monkeypatch.setenv("QK_KERNEL_STRATEGY", "asof=host")
            s.join_asof(ctx.from_arrow_sorted(t, sorted_by="time"), on="time",
                        by="s").collect()
        elif call == "stateful_transform_sorted":
            s.stateful_transform_sorted(object(), ["time"])
        else:
            ctx.read_sorted_csv("ticks.csv", sorted_by="time")


def test_string_keys_match_across_dictionaries():
    """Trades and quotes carry their symbols in dictionaries of another
    order and size; the hash key limbs agree, so the join matches."""
    trades = pa.table({"time": np.array([3, 6, 9, 12], dtype=np.int64),
                       "symbol": ["C", "A", "B", "C"]})
    quotes = pa.table({"time": np.array([1, 2, 4, 5, 8], dtype=np.int64),
                       "symbol": ["A", "Z", "C", "B", "A"],
                       "bid": [1.0, 2.0, 3.0, 4.0, 5.0]})
    for strat in STRATEGIES:
        tb = bridge.arrow_to_device(trades, "cpu")
        qb = bridge.arrow_to_device(quotes, "cpu")
        assert list(tb.columns["symbol"].dictionary.values) != list(
            qb.columns["symbol"].dictionary.values)
        out = asof.asof_join(tb, qb, "time", "time", ["symbol"], ["symbol"], ["bid"],
                             strategy=strat)
        m = out.columns.pop("__asof_matched__").data
        got = bridge.device_to_host(kernels.compact(kernels.apply_mask(out, m)))
        assert got["bid"].tolist() == [1.0, 4.0, 3.0]  # C at 3 has no earlier C quote


# ---------------------------------------------------------------------------
# test_asof_ties.py: pandas' tie-break in both directions
# ---------------------------------------------------------------------------


def _ticks_with_ties(seed=9, n_trades=300, n_quotes=600):
    r = np.random.default_rng(seed)
    # coarse times force many exact (symbol, time) collisions
    tt = np.sort(r.integers(0, 40, n_trades)).astype(np.int64)
    qt = np.sort(r.integers(0, 40, n_quotes)).astype(np.int64)
    syms = np.array(["A", "B"])
    trades = pa.table({"time": tt, "symbol": syms[r.integers(0, 2, n_trades)],
                       "size": r.integers(1, 9, n_trades).astype(np.int32)})
    quotes = pa.table({"time": qt, "symbol": syms[r.integers(0, 2, n_quotes)],
                       "bid": np.arange(n_quotes, dtype=np.float64)})
    return trades, quotes


def _asof_frame(trades, quotes, direction, strat):
    out = asof.asof_join(bridge.arrow_to_device(trades, "cpu"),
                         bridge.arrow_to_device(quotes, "cpu"), "time", "time",
                         ["symbol"], ["symbol"], ["bid"], direction=direction,
                         strategy=strat)
    out = kernels.apply_mask(out, out.columns.pop("__asof_matched__").data)
    return _sorted(bridge.to_pandas(kernels.compact(out)), ["time", "symbol", "size"])


@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("strat", STRATEGIES)
def test_tie_break_matches_pandas(direction, strat, fresh_aot):
    trades, quotes = _ticks_with_ties()
    got = _asof_frame(trades, quotes, direction, strat)
    exp = pd.merge_asof(trades.to_pandas(), quotes.to_pandas(), on="time", by="symbol",
                        direction=direction).dropna(subset=["bid"])
    exp = _sorted(exp, ["time", "symbol", "size"])
    assert len(got) == len(exp)
    # bid is the quote's row, so equality pins which tied quote was taken
    np.testing.assert_array_equal(got.bid.to_numpy(), exp.bid.to_numpy())
    # and the reference's device kernel of the same strategy agrees
    from quokka_tpu.ops import asof as ref_asof
    from quokka_tpu.ops import bridge as ref_bridge
    from quokka_tpu.ops import kernels as ref_kernels

    ref = ref_asof.asof_join(ref_bridge.arrow_to_device(trades),
                             ref_bridge.arrow_to_device(quotes), "time", "time", ["symbol"],
                             ["symbol"], ["bid"], direction=direction, strategy=strat)
    ref = ref_kernels.apply_mask(ref, ref.columns.pop("__asof_matched__").data)
    ref = _sorted(ref_bridge.device_to_arrow(ref_kernels.compact(ref)).to_pandas(),
                  ["time", "symbol", "size"])
    np.testing.assert_array_equal(got.bid.to_numpy(), ref.bid.to_numpy())


def test_sort_and_searchsorted_paths_agree():
    trades, quotes = _ticks_with_ties(seed=123)
    for direction in ("backward", "forward"):
        a = _asof_frame(trades, quotes, direction, "sort")
        b = _asof_frame(trades, quotes, direction, "searchsorted")
        pd.testing.assert_frame_equal(a, b)


def test_mixed_time_dtypes():
    """int trade times against float quote times: the quote time is cast to
    the trade's dtype before the sort, in both strategies."""
    trades = pa.table({"time": np.array([1, 5, 9], dtype=np.int64),
                       "symbol": ["A", "A", "A"]})
    quotes = pa.table({"time": np.array([0.5, 4.5, 8.5]), "symbol": ["A", "A", "A"],
                       "bid": np.array([1.0, 2.0, 3.0])})
    for strat in STRATEGIES:
        out = asof.asof_join(bridge.arrow_to_device(trades, "cpu"),
                             bridge.arrow_to_device(quotes, "cpu"), "time", "time",
                             ["symbol"], ["symbol"], ["bid"], strategy=strat)
        assert out.columns["__asof_matched__"].data[:3].tolist() == [True, True, True]
        np.testing.assert_allclose(out.columns["bid"].data[:3].numpy(), [1.0, 2.0, 3.0])
