"""The port's device scan cache (quokka_tpu_torch/runtime/scancache.py)
against the reference's (quokka_tpu/runtime/scancache.py), on the CPU:
tests/test_scancache.py's two tests through the port, each result held to
the same query through quokka_tpu on the same file; a warm run that lands
nothing (no read, no K23) and gives the cold run's bits; and the port's own
guard: a cached tensor written in place makes the next ``get`` raise, and
through an engine, ``collect()``.

Tolerances: group keys and counts exact, float sums rtol 1e-9 (summation
order) against the reference and pandas; cold and warm runs bit for bit.
"""

import time

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import quokka_tpu
import tpch_data
from quokka_tpu.runtime import scancache as ref_scancache
from quokka_tpu_torch import QuokkaContext
from quokka_tpu_torch.dataset import readers
from quokka_tpu_torch.ops import pack
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol
from quokka_tpu_torch.runtime import scancache

from torch_port_util import fresh_aot  # noqa: F401
from test_torch_q1 import pandas_q1, q1, same


@pytest.fixture(autouse=True)
def fresh_cache():
    scancache.clear()
    ref_scancache.clear()
    yield
    scancache.clear()
    ref_scancache.clear()


def _write(path, seed):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({"k": rng.choice(["a", "b"], 1000), "v": rng.uniform(0, 1, 1000)})
    pq.write_table(pa.Table.from_pandas(df, preserve_index=False), path)
    return df


def _q(ctx, path):
    return (ctx.read_parquet(path).groupby("k").agg_sql("sum(v) as sv").collect()
            .sort_values("k").reset_index(drop=True))


def _port(path):
    return _q(QuokkaContext(io_channels=1, exec_channels=1, device="cpu"), path)


def _ref(path):
    return _q(quokka_tpu.QuokkaContext(io_channels=1, exec_channels=1), path)


def _same(got, exp):
    assert list(got["k"]) == list(exp["k"])
    np.testing.assert_allclose(got["sv"].to_numpy(), exp["sv"].to_numpy(), rtol=1e-9)


def test_warm_hit_and_rewrite_invalidation(tmp_path, fresh_aot):
    p = str(tmp_path / "t.parquet")
    df = _write(p, 1)
    out1 = _port(p)
    stats = scancache.GLOBAL.stats()
    assert stats["entries"] >= 1 and stats["misses"] >= 1
    out2 = _port(p)
    stats2 = scancache.GLOBAL.stats()
    assert stats2["hits"] >= 1, stats2
    pd.testing.assert_frame_equal(out1, out2)
    want = df.groupby("k").agg(sv=("v", "sum")).reset_index()
    np.testing.assert_allclose(out2["sv"].to_numpy(), want["sv"].to_numpy(), rtol=1e-9)
    _same(out2, _ref(p))

    # rewrite the file: the cache must not serve stale rows
    time.sleep(0.01)
    df3 = _write(p, 2)
    out3 = _port(p)
    want3 = df3.groupby("k").agg(sv=("v", "sum")).reset_index()
    np.testing.assert_allclose(out3["sv"].to_numpy(), want3["sv"].to_numpy(), rtol=1e-9)
    _same(out3, _ref(p))


def test_cap_and_disable(tmp_path, monkeypatch, fresh_aot):
    p = str(tmp_path / "t.parquet")
    _write(p, 3)
    small = scancache.ScanCache(cap_bytes=1)  # nothing fits
    monkeypatch.setattr(scancache, "GLOBAL", small)
    _same(_port(p), _ref(p))
    assert small.stats()["entries"] == 0

    disabled = scancache.ScanCache(cap_bytes=0)
    assert not disabled.enabled
    monkeypatch.setattr(scancache, "GLOBAL", disabled)
    _same(_port(p), _ref(p))
    assert disabled.stats() == {"entries": 0, "bytes": 0, "hits": 0, "misses": 0,
                                "by_query": {}}
    # QUOKKA_SCAN_CACHE_BYTES, the reference's setting: 0 disables, a size
    # caps host-resident and card-resident batches alike; unset, 256 MiB of
    # host-resident batches and 2 GiB of card-resident ones, whether or not
    # the process has a card
    monkeypatch.setenv("QUOKKA_SCAN_CACHE_BYTES", "0")
    assert not scancache.ScanCache().enabled
    monkeypatch.setenv("QUOKKA_SCAN_CACHE_BYTES", "4096")
    assert scancache.ScanCache().caps == {"cpu": 4096, "cuda": 4096}
    monkeypatch.delenv("QUOKKA_SCAN_CACHE_BYTES")
    assert scancache.ScanCache().caps == {"cpu": 256 << 20, "cuda": 2 << 30}


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=5)
    root = tmp_path_factory.mktemp("tpch_scancache")
    paths = tpch_data.write_parquet_dir(tables, str(root))
    return paths["lineitem"], tables["lineitem"].to_pandas()


def test_warm_q1_lands_nothing_and_gives_the_cold_bits(lineitem, monkeypatch, fresh_aot):
    """Q1 over a Parquet file of several row groups: the cold run misses on
    every batch, the warm runs hit on every batch with no read and no K23
    (its plain version here), and return the cold run's bits."""
    path, df = lineitem
    reads, decodes = [], []
    real_read, real_decode = readers.InputParquetDataset._read, pack.decode_plain
    monkeypatch.setattr(readers.InputParquetDataset, "_read",
                        lambda self, lin: reads.append(lin) or real_read(self, lin))
    monkeypatch.setattr(pack, "decode_plain",
                        lambda *a: decodes.append(1) or real_decode(*a))
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    batches = pq.ParquetFile(path).metadata.num_row_groups
    assert batches >= 4
    base = scancache.GLOBAL.stats()  # the counters run over the process
    cold = q1(ctx, path)
    s0 = scancache.GLOBAL.stats()
    assert (s0["hits"] - base["hits"], s0["misses"] - base["misses"], s0["entries"]) == \
        (0, batches, batches)
    n_reads, n_decodes = len(reads), len(decodes)
    assert n_reads == batches and n_decodes >= batches
    same(cold, pandas_q1(df))
    for run in range(1, 3):
        warm = q1(ctx, path)
        s = scancache.GLOBAL.stats()
        assert (s["hits"] - base["hits"], s["misses"] - base["misses"]) == \
            (run * batches, batches), s
        # the optimizer's catalog sample lands on the CPU outside the scan
        assert len(reads) == n_reads
        assert len(decodes) - n_decodes <= 1
        n_decodes = len(decodes)
        for c in cold.columns:
            a, b = cold[c].to_numpy(), warm[c].to_numpy()
            if a.dtype.kind == "f":
                a, b = a.view(np.int64), b.view(np.int64)
            np.testing.assert_array_equal(a, b)
    assert s["by_query"] == {}  # each query's accounting dropped at its cleanup


def test_query_accounting_and_lru():
    cache = scancache.ScanCache(cap_bytes=3 * 1024 * 8 + 3 * 1024)

    def batch(v):
        return DeviceBatch({"v": NumCol(torch.full((1024,), float(v), dtype=torch.float64))},
                           torch.ones(1024, dtype=torch.bool), 1024)

    for i in range(4):
        assert cache.get(("k", i), query="q") is None
        cache.put(("k", i), batch(i))
    s = cache.stats()
    assert (s["entries"], s["bytes"], s["misses"]) == (3, 3 * (1024 * 8 + 1024), 4)
    assert cache.get(("k", 0), query="q") is None  # the oldest went first
    got = cache.get(("k", 3), query="q")
    assert float(got.columns["v"].data[0]) == 3.0
    got.columns["w"] = got.columns["v"]  # the caller's copy, not the cached batch
    assert list(cache.get(("k", 3)).columns) == ["v"]
    assert cache.stats()["by_query"] == {"q": {"hits": 1, "misses": 5}}
    cache.drop_query("q")
    assert cache.stats()["by_query"] == {} and cache.stats()["entries"] == 3


def test_host_and_card_batches_count_against_their_own_caps(monkeypatch):
    """A host-resident batch is held to the host cap and a card-resident one
    to the card's, each evicting only its own kind (where a batch lies is
    stubbed here: a CPU test has no card)."""
    nb = 1024 * 8 + 1024
    cache = scancache.ScanCache()
    cache.caps = {"cpu": 2 * nb, "cuda": 3 * nb}
    card = set()
    monkeypatch.setattr(scancache, "_kind",
                        lambda b: "cuda" if id(b.valid) in card else "cpu")
    keep = []
    for i in range(3):
        for where in ("cpu", "cuda"):
            b = DeviceBatch({"v": NumCol(torch.full((1024,), float(i), dtype=torch.float64))},
                            torch.ones(1024, dtype=torch.bool), 1024)
            keep.append(b)
            if where == "cuda":
                card.add(id(b.valid))
            cache.put((where, i), b)
    assert cache.stats()["bytes"] == 5 * nb
    assert sorted(k for k in cache._data) == [("cpu", 1), ("cpu", 2),
                                              ("cuda", 0), ("cuda", 1), ("cuda", 2)]
    assert cache._bytes == {"cpu": 2 * nb, "cuda": 3 * nb}


def test_in_place_write_to_a_cached_column_raises(tmp_path, fresh_aot):
    cache = scancache.ScanCache(cap_bytes=1 << 20)
    data = torch.arange(16, dtype=torch.float64)
    cache.put(("k",), DeviceBatch({"v": NumCol(data)}, torch.ones(16, dtype=torch.bool), 16))
    assert cache.get(("k",)) is not None
    data.add_(1.0)
    with pytest.raises(RuntimeError, match="written in place"):
        cache.get(("k",))
    assert cache.get(("k",)) is None  # never served again

    # through the engine: the next query over the file raises from collect()
    p = str(tmp_path / "t.parquet")
    _write(p, 4)
    _port(p)
    ((batch, _, _),) = scancache.GLOBAL._data.values()
    batch.columns["v"].data.mul_(2.0)
    with pytest.raises(RuntimeError, match="written in place"):
        _port(p)
    _same(_port(p), _ref(p))  # read anew


def test_readers_without_byte_identity_bypass_the_cache(fresh_aot):
    assert not hasattr(readers.InputArrowDataset, "cache_key")
    assert not hasattr(readers.InputHostDataset, "cache_key")
    base = scancache.GLOBAL.stats()
    ctx = QuokkaContext(io_channels=2, exec_channels=1, device="cpu")
    t = pa.table({"k": np.array(["a", "b"] * 500), "v": np.arange(1000, dtype=np.float64)})
    for _ in range(2):
        got = ctx.from_arrow(t).groupby("k").agg_sql("sum(v) as sv").collect()
        assert sorted(got["sv"]) == [249500.0, 250000.0]
    s = scancache.GLOBAL.stats()
    assert (s["entries"], s["hits"], s["misses"]) == (0, base["hits"], base["misses"])
