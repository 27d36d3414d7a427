"""The port engine's host overlap (quokka_tpu_torch/runtime/engine.py: the
IO pool, the emitter thread; dataset/readers.py: the Parquet readahead)
against the reference (quokka_tpu, JAX x64 on the CPU), on the CPU.

- TPC-H Q1 and Q3 over Parquet files of several row groups a channel,
  read cold, equal the reference's results and pandas'.
- A recording reader shows where each batch was read: every batch on a
  ``quokka-io`` thread but at most one a channel (a channel the pool does
  not warm reads its first batch on the loop), and each lineage read once.
- A sorted source (``read_sorted_parquet`` through an as-of join) keeps the
  reference's result with one and with two exec channels.
- An error in a reader on an IO thread, or in the sink's conversion on the
  emitter, reaches ``collect()`` (no re-read hides it, nothing hangs), and
  no ``quokka-io`` or ``quokka-emit`` thread outlives a ``collect()``.

Tolerances: keys and counts exact, floats rtol 1e-9 (summation order), as
in test_torch_q1 / test_torch_q3q5 / test_torch_timeseries.
"""

import os
import threading

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import quokka_tpu
import quokka_tpu_torch
import tpch_data
from quokka_tpu import QuokkaContext as RefContext
from quokka_tpu_torch import QuokkaContext
from quokka_tpu_torch.dataset.readers import InputHostDataset
from quokka_tpu_torch.ops import bridge, pack
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol
from quokka_tpu_torch.runtime import scancache
from quokka_tpu_torch.runtime.engine import Engine
from quokka_tpu_torch.runtime.task import TapedInputTask

from torch_port_util import fresh_aot  # noqa: F401
from test_torch_q1 import pandas_q1, q1, same
from test_torch_q3q5 import pandas_q3, q3, same_q3

POOL_THREADS = ("quokka-io", "quokka-emit")
_PORT_THREADS = []  # the pool threads of the port's engines the test started


@pytest.fixture(autouse=True)
def cold_and_no_threads(monkeypatch):
    """Every query here reads its files anew, and leaves no thread of the
    port's pools.  Those are recorded as they start (``Engine._pool_init``,
    both pools' initializer): a reference engine that another test left
    running in this process names its threads the same way, and is not
    the port's."""
    real_init = Engine._pool_init

    def pool_init(self):
        _PORT_THREADS.append(threading.current_thread())
        real_init(self)

    monkeypatch.setattr(Engine, "_pool_init", pool_init)
    _PORT_THREADS.clear()
    scancache.clear()
    yield
    scancache.clear()
    assert not _pool_threads()


def _pool_threads():
    """The names of the port's pool threads still alive."""
    alive = [t.name for t in _PORT_THREADS if t.is_alive()]
    assert all(n.startswith(POOL_THREADS) for n in alive), alive
    return alive


def _collect(stream, seconds=300):
    """``stream.collect()`` on a thread of its own, which must end within
    ``seconds`` (an engine that hangs fails the test instead of the run);
    its error is raised here."""
    out = {}

    def run():
        try:
            out["df"] = stream.collect()
        except BaseException as e:  # handed to the test's thread
            out["err"] = e

    t = threading.Thread(target=run, name="collect")
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"collect() did not end within {seconds} s"
    assert not _pool_threads(), _pool_threads()
    if "err" in out:
        raise out["err"]
    return out["df"]


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=13)
    root = tmp_path_factory.mktemp("tpch_prefetch")
    # 2,048-row row groups: several batches a channel on every table
    paths = tpch_data.write_parquet_dir(tables, str(root), row_group_size=2048)
    return paths, {k: t.to_pandas() for k, t in tables.items()}


def test_q1_over_parquet_matches_reference(tpch, fresh_aot):
    paths, dfs = tpch
    assert pq.ParquetFile(paths["lineitem"]).metadata.num_row_groups >= 6
    got = q1(QuokkaContext(device="cpu"), paths["lineitem"])
    assert not _pool_threads()
    same(got, pandas_q1(dfs["lineitem"]))
    same(got, q1(RefContext(), paths["lineitem"]))


def test_q3_over_parquet_matches_reference(tpch, fresh_aot):
    paths, dfs = tpch
    got = _collect(q3(quokka_tpu_torch, QuokkaContext(device="cpu"), paths))
    same_q3(got, pandas_q3(dfs))
    same_q3(got, q3(quokka_tpu, RefContext(), paths).collect())


class RecordingReader(InputHostDataset):
    """An in-memory reader that records the thread each lineage was read
    on, and raises on the lineages in ``fail_on``."""

    def __init__(self, table, batch_rows, fail_on=()):
        super().__init__(table, batch_rows)
        self.reads = []  # (channel, lineage, thread name)
        self.fail_on = set(fail_on)

    def execute(self, channel, lineage):
        self.reads.append((channel, lineage, threading.current_thread().name))
        if lineage in self.fail_on:
            raise ValueError(f"unreadable lineage {lineage}")
        return super().execute(channel, lineage)


def _tables(seed=3):
    r = np.random.default_rng(seed)
    fact = bridge.HostTable({"fk": r.integers(0, 300, 5000).astype(np.int64),
                             "x": r.uniform(0, 1, 5000).round(3)})
    dim = bridge.HostTable({"pk": np.arange(300, dtype=np.int64),
                            "g": r.integers(0, 7, 300).astype(np.int64)})
    return fact, dim


def _join_stream(ctx, fact, dim):
    return (ctx.read_dataset(fact).join(ctx.read_dataset(dim), left_on="fk", right_on="pk")
            .groupby("g").agg_sql("sum(x) as sx, count(*) as n"))


def _join_oracle(fact, dim):
    f = pd.DataFrame(fact.columns).merge(pd.DataFrame(dim.columns), left_on="fk",
                                         right_on="pk")
    return f.groupby("g").agg(sx=("x", "sum"), n=("x", "size")).reset_index()


def test_batches_are_read_on_the_io_threads(fresh_aot):
    fact_t, dim_t = _tables()
    fact, dim = RecordingReader(fact_t, 256), RecordingReader(dim_t, 32)
    got = _collect(_join_stream(QuokkaContext(io_channels=2, exec_channels=2, device="cpu"),
                                fact, dim))
    exp = _join_oracle(fact_t, dim_t)
    got = got.sort_values("g").reset_index(drop=True)
    np.testing.assert_array_equal(got["g"].to_numpy(), exp["g"].to_numpy())
    np.testing.assert_array_equal(got["n"].to_numpy(), exp["n"].to_numpy())
    np.testing.assert_allclose(got["sx"].to_numpy(), exp["sx"].to_numpy(), rtol=1e-9)
    for reader, n in ((fact, 5000), (dim, 300)):
        lineages = [lin for _, lin, _ in reader.reads]
        # every lineage once: no read twice, none missed
        assert sorted(lineages) == sorted(lin for lins in reader.get_own_state(2).values()
                                          for lin in lins)
        assert sum(length for _, length in lineages) == n
        on_loop = {}
        for ch, _, name in reader.reads:
            if not name.startswith("quokka-io"):
                on_loop[ch] = on_loop.get(ch, 0) + 1
        assert all(k <= 1 for k in on_loop.values()), on_loop
        assert sum(name.startswith("quokka-io") for _, _, name in reader.reads) >= \
            len(lineages) - 2


@pytest.fixture(scope="module")
def ticks(tmp_path_factory):
    r = np.random.default_rng(21)
    syms = np.array([f"SYM{i}" for i in range(5)])
    trades = pa.table({
        "time": np.sort(r.integers(0, 100_000, 3000)).astype(np.int64),
        "symbol": syms[r.integers(0, 5, 3000)],
        "size": r.integers(1, 500, 3000).astype(np.int64)})
    quotes = pa.table({
        "time": np.sort(r.choice(100_000, 6000, replace=False)).astype(np.int64),
        "symbol": syms[r.integers(0, 5, 6000)],
        "bid": r.uniform(10, 20, 6000).round(3)})
    root = tmp_path_factory.mktemp("prefetch_ticks")
    tp, qp = str(root / "trades.parquet"), str(root / "quotes.parquet")
    pq.write_table(trades, tp, row_group_size=500)
    pq.write_table(quotes, qp, row_group_size=500)
    return tp, qp, trades.to_pandas(), quotes.to_pandas()


_REF = {}


@pytest.mark.parametrize("channels", [1, 2])
def test_sorted_source_through_asof_keeps_the_reference_result(ticks, channels, fresh_aot):
    tp, qp, tdf, qdf = ticks

    def q(ctx):
        t = ctx.read_sorted_parquet(tp, sorted_by="time")
        return (t.join_asof(ctx.read_sorted_parquet(qp, sorted_by="time"), on="time",
                            by="symbol")
                .with_columns_sql("bid * size as notional"))

    got = _collect(q(QuokkaContext(io_channels=2, exec_channels=channels, device="cpu")))
    if "ref" not in _REF:
        _REF["ref"] = q(quokka_tpu.QuokkaContext()).collect()
    exp = pd.merge_asof(tdf, qdf, on="time", by="symbol",
                        direction="backward").dropna(subset=["bid"])
    key = ["time", "symbol", "size"]
    for want in (exp.assign(notional=exp.bid * exp["size"]), _REF["ref"]):
        g = got.sort_values(key).reset_index(drop=True)
        w = want.sort_values(key).reset_index(drop=True)
        assert len(g) == len(w) > 0
        for c in key + ["bid"]:
            np.testing.assert_array_equal(g[c].to_numpy(), w[c].to_numpy())
        np.testing.assert_allclose(g["notional"].to_numpy(), w["notional"].to_numpy(),
                                   rtol=1e-9)


@pytest.mark.parametrize("side,index", [("build", 0), ("probe", 2)])
def test_a_reader_error_on_an_io_thread_reaches_collect(side, index, fresh_aot):
    """The build side's first read (started before the loop) or a later
    read of the probe side fails on an IO thread."""
    fact_t, dim_t = _tables(5)
    table, rows = (dim_t, 32) if side == "build" else (fact_t, 256)
    bad = InputHostDataset(table, rows).get_own_state(2)[1][index]
    failing = RecordingReader(table, rows, fail_on=[bad])
    fact = failing if side == "probe" else RecordingReader(fact_t, 256)
    dim = failing if side == "build" else RecordingReader(dim_t, 32)
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    with pytest.raises(ValueError, match="unreadable lineage"):
        _collect(_join_stream(ctx, fact, dim))
    tried = [name for _, lin, name in failing.reads if lin == bad]
    assert len(tried) == 1 and tried[0].startswith("quokka-io"), tried  # no re-read
    # the context runs the next query as before
    got = _collect(_join_stream(ctx, RecordingReader(fact_t, 256), RecordingReader(dim_t, 32)))
    assert got["n"].sum() == _join_oracle(fact_t, dim_t)["n"].sum()


def test_a_sink_conversion_error_on_the_emitter_reaches_collect(monkeypatch, fresh_aot):
    real = bridge.device_to_host
    threads = []

    def convert(batch):
        threads.append(threading.current_thread().name)
        if len(threads) == 3:
            raise RuntimeError("conversion failed")
        return real(batch)

    monkeypatch.setattr(bridge, "device_to_host", convert)
    t = pa.table({"v": np.arange(20_000, dtype=np.int64)})
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    with pytest.raises(RuntimeError, match="conversion failed"):
        _collect(ctx.read_dataset(_ArrowSlices(t, 1000)).filter_sql("v >= 0"))
    assert threads and all(n.startswith("quokka-emit") for n in threads), threads
    # many sink batches, more than the emitter keeps in flight: all land, in order
    threads.clear()
    monkeypatch.setattr(bridge, "device_to_host", lambda b: threads.append(
        threading.current_thread().name) or real(b))
    got = _collect(ctx.read_dataset(_ArrowSlices(t, 500)).filter_sql("v >= 0"))
    assert len(threads) >= 20 and all(n.startswith("quokka-emit") for n in threads)
    np.testing.assert_array_equal(np.sort(got["v"].to_numpy()), np.arange(20_000))


def test_a_readahead_slot_is_served_only_to_its_dataset_and_unchanged_file(tmp_path):
    """A slot armed for a file's next row group: a rewrite of the file
    between the two reads, or another dataset that took over the slot's
    key (a reused ``id``), reads anew and returns the bytes on disk."""
    from quokka_tpu_torch.dataset import readers

    p = str(tmp_path / "t.parquet")

    def write(base):
        pq.write_table(pa.table({"v": np.arange(base, base + 200, dtype=np.int64)}), p,
                       row_group_size=100)

    def armed(ds):
        ent = readers._READAHEAD._slots[(id(ds), 0)]
        ent[3].result(timeout=60)  # the readahead has read the old bytes
        return ent

    write(0)
    ds = readers.InputParquetDataset(p)
    state = ds.get_own_state(1)
    assert [rg for _, rg in state[0]] == [0, 1]
    assert ds.execute(0, state[0][0])["v"].to_pylist()[0] == 0
    armed(ds)
    os.utime(p, ns=(0, 0))  # any other mtime: a rewrite that keeps the size
    write(1000)
    os.utime(p, ns=(10**18, 10**18))
    assert ds.execute(0, state[0][1])["v"].to_pylist()[0] == 1100

    # a slot taken over by another dataset's key
    ds2 = readers.InputParquetDataset(p, columns=["v"])
    ds2.get_own_state(1)
    assert ds.execute(0, state[0][0])["v"].to_pylist()[0] == 1000
    ent = armed(ds)
    with readers._READAHEAD._lock:
        readers._READAHEAD._slots[(id(ds2), 0)] = readers._READAHEAD._slots.pop((id(ds), 0))
    assert readers._READAHEAD.take(ds2, 0, state[0][1], readers._file_ident(p)) is None
    assert ent[0]() is ds  # the slot still names the dataset that armed it
    # and the dataset that armed it takes it while the file is unchanged
    assert ds.execute(0, state[0][0])["v"].to_pylist()[0] == 1000
    armed(ds)
    assert readers._READAHEAD.take(ds, 0, state[0][1], readers._file_ident(p)) is not None


class _ArrowSlices:
    """A pyarrow table in ``rows``-row slices (an in-memory source without
    a byte identity)."""

    def __init__(self, table, rows):
        self.inner = InputHostDataset(bridge.arrow_to_host(table), rows)
        self.schema = table.column_names

    def get_own_state(self, channels):
        return self.inner.get_own_state(channels)

    def execute(self, channel, lineage):
        return self.inner.execute(channel, lineage)


def test_peek_next_seq_and_the_plans_join():
    task = TapedInputTask(0, 0, [3, 5, 8])
    assert (task.current_seq(), task.peek_next_seq()) == (3, 5)
    assert task.advance().advance().peek_next_seq() is None
    # two encodes of one signature decide side by side: the wider decision
    # stays, whichever lands last
    u8, u16, full = pack._IntPlan("uint8"), pack._IntPlan("uint16"), pack._IntPlan("full")
    assert pack._join(u16, u8) is u16 and pack._join(u8, u16) is u16
    assert pack._join(None, u8) is u8 and pack._join(full, u16) is full
    d16, d256, ffull = pack._FloatPlan("dict", 16), pack._FloatPlan("dict", 256), \
        pack._FloatPlan("full")
    assert pack._join(d256, d16) is d256 and pack._join(d16, ffull) is ffull
    assert pack._join(ffull, d256) is ffull


def test_shared_plans_and_cache_under_many_threads():
    """Threads that share the wire's plans and the scan cache, with a short
    switch interval: in each of 50 rounds two threads encode a fresh
    signature at once, one needing a uint8 wire and one uint16, and the
    stored plan must end at uint16 whichever lands last; sixteen threads
    (more than the cores) look up and fill one scan cache, whose counts
    and bytes must add up (a lost update breaks either)."""
    import sys

    n = 8192
    leaves = [[pack.ValidCount(n, n), np.arange(n, dtype=np.int64) % m] for m in (200, 60_000)]
    cache = scancache.ScanCache(cap_bytes=40 * (n * 8 + n))
    errors = []

    def run_threads(target, count, *args):
        threads = [threading.Thread(target=target, args=(i, *args)) for i in range(count)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors

    def encode(i, barrier):
        try:
            barrier.wait(30)
            pack._encode(leaves[i])
        except BaseException as e:  # handed to the test's thread
            errors.append(e)

    def lookups(i):
        try:
            for j in range(20):
                key = ("k", (i * 20 + j) % 48)
                if cache.get(key) is None:
                    cache.put(key, DeviceBatch(
                        {"v": NumCol(torch.zeros(n, dtype=torch.float64))},
                        torch.ones(n, dtype=torch.bool), n))
        except BaseException as e:
            errors.append(e)

    old, saved = sys.getswitchinterval(), pack._PLANS
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(50):
            pack._PLANS = {}
            run_threads(encode, 2, threading.Barrier(2))
            assert pack._PLANS[(("__valid__", n), ("int64", (n,)))][1].wire == "uint16"
        run_threads(lookups, 16)
    finally:
        sys.setswitchinterval(old)
        pack._PLANS = saved
    s = cache.stats()
    assert s["hits"] + s["misses"] == 16 * 20
    assert s["bytes"] == sum(nb for _, nb, _ in cache._data.values()) <= cache.caps["cpu"]
    assert s["entries"] == len(cache._data) <= 40
