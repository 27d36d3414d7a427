"""The PyTorch port's TPC-H Q1 slice end to end, against the reference
(quokka_tpu, JAX x64 on the CPU) and against pandas, on tpch_data tables
read from Parquet; plus the bridge it runs on.

Tolerances: keys and counts exact, floats rtol 1e-9 (summation order).
"""

import datetime

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import tpch_data
from quokka_tpu import QuokkaContext as RefContext
from quokka_tpu_torch import QuokkaContext, col
from quokka_tpu_torch.ops import bridge, fuse
from quokka_tpu_torch.parallel.mesh import Mesh

from torch_port_util import fresh_aot, mixed_table, port_batch, ref_batch_of  # noqa: F401

Q1_FILTER = "l_shipdate <= date '1998-12-01' - interval '90' day"
Q1_AGGS = ("sum(l_quantity) as sum_qty, sum(l_extendedprice) as sum_base_price, "
           "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
           "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge, "
           "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
           "avg(l_discount) as avg_disc, count(*) as count_order")
KEYS = ["l_returnflag", "l_linestatus"]


def q1(ctx, path):
    return (ctx.read_parquet(path).filter_sql(Q1_FILTER).groupby(KEYS)
            .agg_sql(Q1_AGGS).collect())


def pandas_q1(df):
    f = df[df.l_shipdate <= datetime.date(1998, 9, 2)]
    g = f.assign(disc_price=f.l_extendedprice * (1 - f.l_discount),
                 charge=f.l_extendedprice * (1 - f.l_discount) * (1 + f.l_tax))
    g = g.groupby(KEYS, dropna=False)
    return pd.DataFrame({
        "sum_qty": g.l_quantity.sum(), "sum_base_price": g.l_extendedprice.sum(),
        "sum_disc_price": g.disc_price.sum(), "sum_charge": g.charge.sum(),
        "avg_qty": g.l_quantity.mean(), "avg_price": g.l_extendedprice.mean(),
        "avg_disc": g.l_discount.mean(), "count_order": g.size(),
    }).reset_index()


def same(got, exp):
    by = KEYS
    got = got.sort_values(by, na_position="first").reset_index(drop=True)[list(exp.columns)]
    exp = exp.sort_values(by, na_position="first").reset_index(drop=True)
    assert len(got) == len(exp) > 0
    for c in by:
        assert [None if v is None or v != v else v for v in got[c]] == \
            [None if v is None or v != v else v for v in exp[c]]
    np.testing.assert_array_equal(got.count_order.to_numpy(), exp.count_order.to_numpy())
    for c in exp.columns:
        if c not in by and c != "count_order":
            np.testing.assert_allclose(got[c].to_numpy(np.float64), exp[c].to_numpy(np.float64),
                                       rtol=1e-9)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "nulls"])
def lineitem(request, tmp_path_factory):
    t = tpch_data.generate(sf=0.003, seed=7, nulls=request.param)["lineitem"]
    root = tmp_path_factory.mktemp("q1")
    return tpch_data.write_parquet_dir({"lineitem": t}, str(root))["lineitem"], t.to_pandas()


def test_q1_matches_reference_and_pandas(lineitem, fresh_aot):
    path, df = lineitem
    before = (fuse.FALLBACKS,)
    got = q1(QuokkaContext(io_channels=2, exec_channels=2, device="cpu"), path)
    assert fuse.FALLBACKS == before[0], "Q1 left the fused kernels"
    ref = q1(RefContext(io_channels=2, exec_channels=2), path)
    same(got, pandas_q1(df))
    same(got, ref)


@pytest.mark.parametrize("channels", [(1, 1), (2, 3), (3, 2)])
def test_q1_channel_layouts(lineitem, channels):
    path, df = lineitem
    ctx = QuokkaContext(io_channels=channels[0], exec_channels=channels[1], device="cpu")
    same(q1(ctx, path), pandas_q1(df))


def test_q1_from_arrow_and_pandas_and_numpy_collect(lineitem, monkeypatch):
    path, df = lineitem
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    ctx = QuokkaContext(device="cpu")
    exp = pandas_q1(df)
    for stream in (ctx.from_arrow(table), ctx.from_pandas(df)):
        same(stream.filter_sql(Q1_FILTER).groupby(KEYS).agg_sql(Q1_AGGS).collect(), exp)
    # without pandas, collect() hands back a dict of numpy arrays
    ds = ctx.from_arrow(table).filter(col("l_shipdate") <= datetime.date(1998, 9, 2)) \
        .groupby(KEYS).agg({"l_quantity": "sum", "*": "count"}).compute()
    cols = ds.to_numpy()
    assert set(cols) == {*KEYS, "l_quantity_sum", "count"}
    assert int(cols["count"].sum()) == int(exp.count_order.sum())


def test_global_aggregate_and_empty_input():
    df = pd.DataFrame({"x": np.arange(10.0), "k": ["a", "b"] * 5})
    ctx = QuokkaContext(device="cpu")
    got = ctx.from_pandas(df).filter_sql("x > 3").agg_sql("sum(x) as s, count(*) as n").collect()
    assert got.s[0] == 39.0 and got.n[0] == 6
    none = ctx.from_pandas(df).filter_sql("x > 100").groupby("k").agg_sql("sum(x) as s").collect()
    assert len(none) == 0 and list(none.columns) == ["k", "s"]


def test_unported_surface_raises():
    ctx = QuokkaContext(device="cpu")
    s = ctx.from_pandas(pd.DataFrame({"x": [1, 2]}))
    for call in (lambda: s.groupby("x", orderby="x"),
                 lambda: s.sort(["x"]),
                 lambda: QuokkaContext(device="cpu", exec_config={"fault_tolerance": True}),
                 lambda: QuokkaContext(device="cpu",
                                       mesh=Mesh(8, devices=["cuda:0", "cuda:1"]))):
        with pytest.raises(NotImplementedError):
            call()


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 300, 70000])
def test_arrow_to_device_matches_reference_bridge(n):
    t = mixed_table(n, seed=n)
    ref = ref_batch_of(t)
    got = bridge.arrow_to_device(t, "cpu")
    assert got.padded_len == ref.padded_len
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    mine = port_batch(ref)
    for name in t.column_names:
        a, b = got.columns[name], mine.columns[name]
        if hasattr(a, "codes"):
            # dictionaries may be ordered differently: compare decoded values
            va = [a.dictionary.values[c] if c >= 0 else None for c in a.codes.numpy()]
            vb = [b.dictionary.values[c] if c >= 0 else None for c in b.codes.numpy()]
            assert va == vb
        else:
            assert a.kind == b.kind and a.data.dtype == b.data.dtype
            np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())


def test_host_round_trip_with_nulls():
    n = 1000
    r = np.random.default_rng(0)
    ints = r.integers(-5, 5, n)
    valid_i = r.random(n) < 0.9
    table = bridge.HostTable(
        {"i": ints, "f": r.normal(size=n), "s": np.array(["a", None, "b"] * 333 + ["c"], dtype=object),
         "d": (r.integers(0, 20000, n)).astype("datetime64[D]"), "b": r.random(n) < 0.5,
         "c": np.where(valid_i, 1, 0).astype(np.int32)},
        validity={"i": valid_i}, dictionaries={"c": np.array(["no", "yes"], dtype=object)})
    b = bridge.host_to_device(table, "cpu")
    assert b.padded_len == 1024 and b.count_valid() == n
    back = bridge.device_to_host(b)
    np.testing.assert_array_equal(np.isnan(back["i"]), ~valid_i)
    np.testing.assert_array_equal(back["i"][valid_i], ints[valid_i])
    assert list(back["s"]) == list(table.columns["s"])
    np.testing.assert_array_equal(back["d"], table.columns["d"])
    assert list(back["c"]) == ["yes" if v else "no" for v in valid_i]
    df = bridge.to_pandas(b)
    assert isinstance(df.d[0], datetime.date)
    arrow = bridge.device_to_arrow(b)
    assert arrow.column("d").type == pa.date32() and arrow.column("i").null_count == (~valid_i).sum()


def test_concat_batches_merges_dictionaries():
    t1 = bridge.host_to_device(bridge.HostTable({"s": np.array(["a", "b"], dtype=object),
                                                 "x": np.array([1.0, 2.0])}), "cpu")
    t2 = bridge.host_to_device(bridge.HostTable({"s": np.array(["c", None, "a"], dtype=object),
                                                 "x": np.array([3.0, 4.0, 5.0])}), "cpu")
    out = bridge.device_to_host(bridge.concat_batches([t1, t2]))
    assert list(out["s"]) == ["a", "b", "c", None, "a"]
    assert out["x"].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert torch.equal(torch.tensor(out["x"]), torch.tensor([1.0, 2, 3, 4, 5], dtype=torch.float64))


def test_output_executor_writes_parquet(tmp_path):
    import pyarrow.parquet as pq

    from quokka_tpu_torch.executors.output import OutputExecutor

    b = bridge.host_to_device(bridge.HostTable({"x": np.arange(5.0),
                                                "s": np.array(list("abcab"), dtype=object)}), "cpu")
    ex = OutputExecutor(str(tmp_path), rows_per_file=3)
    names = ex.execute([b], 0, 0)
    tail = ex.done(0)
    files = bridge.device_to_host(names)["filename"].tolist() + \
        bridge.device_to_host(tail)["filename"].tolist()
    back = pa.concat_tables([pq.read_table(f) for f in files])
    assert back.column("x").to_pylist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert back.column("s").to_pylist() == list("abcab")
