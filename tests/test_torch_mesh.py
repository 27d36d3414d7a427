"""The mesh plane of the PyTorch port (``quokka_tpu_torch/parallel/mesh.py``)
against the reference's (``quokka_tpu/parallel/mesh.py``) on the test
suite's 8 virtual CPU devices: the tests of tests/test_parallel.py, the
shapes of ``__graft_entry__.dryrun_multichip``, and the two kernels of the
slice, K24 (``kernels.mesh_bucketize``) and K14 (``join._pk_match``), in
their plain versions.

The port runs its mesh as ``n_shards`` logical shards of one device
(``make_mesh(8, device="cpu")``); the reference's shard i lives on virtual
device i.  Both see the same numpy inputs.  Int keys and counts compare
exactly, float sums to rtol 1e-9 (another summation order).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import quokka_tpu
from quokka_tpu.ops import join as ref_join
from quokka_tpu.parallel import mesh as ref_mesh
from quokka_tpu_torch import QuokkaContext
from quokka_tpu_torch.ops import join, kernels
from quokka_tpu_torch.parallel import mesh
from quokka_tpu_torch.parallel.mesh import (
    collective_hash_shuffle,
    distributed_groupby_step,
    distributed_join_groupby_step,
    make_mesh,
)

import torch_port_util  # noqa: F401  (each test process gets its own reference AOT store)

RTOL = 1e-9


@pytest.fixture(scope="module")
def port_mesh():
    return make_mesh(8, device="cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# the mesh object
# ---------------------------------------------------------------------------


def test_make_mesh_shards_one_device(port_mesh):
    assert port_mesh.n_shards == 8 and port_mesh.device.type == "cpu"
    assert port_mesh.shard_rows(1024) == 128
    with pytest.raises(ValueError):
        port_mesh.shard_rows(100)


def test_mesh_over_several_devices_is_refused():
    with pytest.raises(NotImplementedError, match="Multi-GPU, remaining"):
        mesh.Mesh(8, devices=["cuda:0", "cuda:1"])


def test_shard_map_is_a_per_shard_apply(port_mesh):
    a = torch.arange(64)
    b = torch.arange(128)
    (sa, sb) = mesh.shard_map(lambda x, y: (x.sum().reshape(1), y[:1]), port_mesh)(a, b)
    np.testing.assert_array_equal(sa.numpy(), a.reshape(8, 8).sum(1).numpy())
    np.testing.assert_array_equal(sb.numpy(), np.arange(0, 128, 16))


# ---------------------------------------------------------------------------
# tests/test_parallel.py: the distributed steps
# ---------------------------------------------------------------------------


def _groups(keys, vals, valid):
    got = {}
    for k, v, ok in zip(_np(keys), _np(vals), _np(valid)):
        if ok:
            assert k not in got, "a key appears on two shards after the shuffle"
            got[int(k)] = v
    return got


class TestDistributedGroupby:
    def test_conserves_rows_and_sums(self, port_mesh):
        total = 256 * 8
        r = np.random.default_rng(0)
        keys = r.integers(0, 37, total).astype(np.int32)
        vals = r.normal(size=total)
        valid = np.ones(total, dtype=bool)
        fk, fs, fc, fv = distributed_groupby_step(port_mesh, 1, ("sum", "count"))(
            keys, vals, vals, valid)
        assert int(fc[fv].sum()) == total
        np.testing.assert_allclose(float(fs[fv].sum()), vals.sum(), rtol=RTOL)
        sums, counts = _groups(fk, fs, fv), _groups(fk, fc, fv)
        for k in range(37):
            np.testing.assert_allclose(sums[k], vals[keys == k].sum(), rtol=RTOL)
            assert counts[k] == (keys == k).sum()
        # the reference's step on its 8 devices: the same groups, the same
        # shards (one hash), the same per-shard order (key rank)
        rk, rs, rc, rv = ref_mesh.distributed_groupby_step(
            ref_mesh.make_mesh(8), key_cols=1, val_ops=("sum", "count"))(
            keys, vals, vals, valid)
        np.testing.assert_array_equal(_np(fv), np.asarray(rv))
        live = _np(fv)
        np.testing.assert_array_equal(_np(fk)[live], np.asarray(rk)[live])
        np.testing.assert_array_equal(_np(fc)[live], np.asarray(rc)[live])
        np.testing.assert_allclose(_np(fs)[live], np.asarray(rs)[live], rtol=RTOL)

    def test_invalid_rows_dropped(self, port_mesh):
        total = 8 * 128
        keys = np.zeros(total, dtype=np.int32)
        vals = np.ones(total)
        valid = np.zeros(total, dtype=bool)
        valid[: total // 2] = True
        fk, fc, fv = distributed_groupby_step(port_mesh, 1, ("count",))(keys, vals, valid)
        assert int(fc[fv].sum()) == total // 2


class TestDistributedJoin:
    def test_shuffle_join_psum(self, port_mesh):
        total = 8 * 256
        r = np.random.default_rng(1)
        l_key = r.integers(0, 100, total).astype(np.int32)
        l_val = r.normal(size=total)
        pad = total - 100
        r_key = np.concatenate([np.arange(100, dtype=np.int32), np.zeros(pad, np.int32)])
        r_val = np.concatenate([r.normal(size=100), np.zeros(pad)])
        r_valid = np.concatenate([np.ones(100, bool), np.zeros(pad, bool)])
        args = (l_key, l_val, np.ones(total, bool), r_key, r_val, r_valid)
        tot, rows = distributed_join_groupby_step(port_mesh)(*args)
        assert int(rows) == total
        expect = float((l_val * r_val[np.clip(l_key, 0, 99)]).sum())
        np.testing.assert_allclose(float(tot), expect, rtol=RTOL)
        ref_tot, ref_rows = ref_mesh.distributed_join_groupby_step(ref_mesh.make_mesh(8))(*args)
        assert int(ref_rows) == int(rows)
        np.testing.assert_allclose(float(tot), float(ref_tot), rtol=RTOL)


# ---------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip's two shapes through QuokkaContext(mesh=)
# ---------------------------------------------------------------------------


def _dryrun_tables():
    r = np.random.default_rng(1)
    n_cust, n_ord, n_li = 128, 512, 2048
    customer = pa.table({
        "c_custkey": np.arange(n_cust, dtype=np.int64),
        "c_mktsegment": np.array(["BUILDING", "MACHINERY", "AUTOMOBILE"])[
            r.integers(0, 3, n_cust)],
    })
    orders = pa.table({
        "o_orderkey": np.arange(n_ord, dtype=np.int64),
        "o_custkey": r.integers(0, n_cust, n_ord).astype(np.int64),
    })
    lineitem = pa.table({
        "l_orderkey": r.integers(0, n_ord, n_li).astype(np.int64),
        "l_extendedprice": r.uniform(100, 5000, n_li).round(2),
        "l_discount": r.uniform(0, 0.1, n_li).round(3),
        "l_quantity": r.integers(1, 50, n_li).astype(np.int64),
    })
    n_tr, n_qt = 1024, 2048
    syms = np.array(["AAA", "BBB", "CCC", "DDD"])
    trades = pa.table({
        "time": np.sort(r.integers(0, 50_000, n_tr)).astype(np.int64),
        "symbol": syms[r.integers(0, 4, n_tr)],
        "size": r.integers(1, 100, n_tr).astype(np.int64),
    })
    quotes = pa.table({
        "time": np.sort(r.choice(50_000, n_qt, replace=False)).astype(np.int64),
        "symbol": syms[r.integers(0, 4, n_qt)],
        "bid": r.uniform(10, 20, n_qt).round(3),
    })
    return customer, orders, lineitem, trades, quotes


def _q3_shape(ctx, customer, orders, lineitem):
    c = ctx.from_arrow(customer).filter_sql("c_mktsegment = 'BUILDING'")
    o = ctx.from_arrow(orders)
    l = ctx.from_arrow(lineitem).filter_sql("l_quantity < 45")
    return (l.join(o, left_on="l_orderkey", right_on="o_orderkey")
            .join(c, left_on="o_custkey", right_on="c_custkey")
            .groupby("l_orderkey")
            .agg_sql("sum(l_extendedprice * (1 - l_discount)) as revenue, count(*) as n")
            .collect().sort_values("l_orderkey").reset_index(drop=True))


def _asof_shape(ctx, trades, quotes):
    t = ctx.from_arrow_sorted(trades, sorted_by="time")
    q = ctx.from_arrow_sorted(quotes, sorted_by="time")
    return (t.join_asof(q, on="time", by="symbol")
            .groupby("symbol").agg_sql("sum(size) as total, count(*) as n")
            .collect().sort_values("symbol").reset_index(drop=True))


@pytest.mark.parametrize("shape", ["q3_shape", "asof_shape"])
def test_dryrun_multichip_shapes(port_mesh, shape):
    customer, orders, lineitem, trades, quotes = _dryrun_tables()
    run = ((lambda ctx: _q3_shape(ctx, customer, orders, lineitem)) if shape == "q3_shape"
           else (lambda ctx: _asof_shape(ctx, trades, quotes)))
    mctx = QuokkaContext(device="cpu", mesh=port_mesh)
    got = run(mctx)
    assert mctx.last_mesh_fallback is None, mctx.last_mesh_fallback
    ref_ctx = quokka_tpu.QuokkaContext(mesh=ref_mesh.make_mesh(8))
    ref = run(ref_ctx)
    assert ref_ctx.last_mesh_fallback is None
    eng = run(QuokkaContext(device="cpu"))
    for exp in (ref, eng):
        assert list(got.columns) == list(exp.columns)
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=RTOL)


# ---------------------------------------------------------------------------
# K24: the bucketize and exchange, against the reference's frames
# ---------------------------------------------------------------------------


def _k24_inputs(n_parts, n, case, seed):
    """Two int32 key limbs (a float64 one in the "float limbs" case), and
    carried int64 / float64 / float32 / bool / int32 columns, the last one
    each row's position in its shard."""
    r = np.random.default_rng(seed)
    total = n_parts * n
    k0 = r.integers(-5, 40, total).astype(np.int32)
    k1 = r.integers(0, 3, total).astype(np.int32)
    valid = r.random(total) < 0.8
    if case == "all invalid":
        valid[:] = False
    elif case == "one bucket":
        k0[:] = 7
        k1[:] = 1
    if case == "float limbs":
        k1 = r.choice(np.array([0.0, -0.0, np.nan, 2.5, -3.7, 1e12, -1e12]), total)
    cols = [k0, k1, r.integers(-2**40, 2**40, total), r.normal(size=total),
            r.normal(size=total).astype(np.float32), r.random(total) < 0.5,
            np.tile(np.arange(n, dtype=np.int32), n_parts)]
    return cols, valid


def _bits(c):
    """Floats by their bits, so NaN rows compare."""
    c = np.ascontiguousarray(c)
    return c.view(np.uint64 if c.itemsize == 8 else np.uint32) if c.dtype.kind == "f" else c


def _frame_rows(cols, valid, lo, hi):
    live = valid[lo:hi]
    rows = list(zip(*[_bits(c[lo:hi][live]).tolist() for c in cols]))
    return sorted(rows)


@pytest.mark.parametrize("n_parts", [1, 2, 8])
@pytest.mark.parametrize("case", ["random", "all invalid", "one bucket", "float limbs"])
def test_k24_plain_and_shuffle_match_the_reference_frames(n_parts, case, port_mesh):
    n = 64
    cols, valid = _k24_inputs(n_parts, n, case, seed=n_parts)
    key_idx = (0, 1)
    tcols = [torch.from_numpy(c) for c in cols]
    got, gvalid = kernels.mesh_bucketize_plain(tcols, torch.from_numpy(valid), key_idx,
                                               n_parts)
    got = [g.numpy() for g in got]
    gvalid = gvalid.numpy()
    assert gvalid.shape == (n_parts * n_parts * n,)
    # the port's shuffle on a mesh of n_parts shards gives the same layout
    sm = make_mesh(n_parts, device="cpu")
    sh, sv = collective_hash_shuffle(tcols, torch.from_numpy(valid), key_idx, sm)
    np.testing.assert_array_equal(sv.numpy(), gvalid)
    for a, b in zip(sh, got):
        np.testing.assert_array_equal(a.numpy().view(np.uint8), b.view(np.uint8))
    # the reference: each shard's _local_bucketize, frame by frame
    for s in range(n_parts):
        src = slice(s * n, (s + 1) * n)
        frames, fvalid = ref_mesh._local_bucketize(
            tuple(jnp.asarray(c[src]) for c in cols), jnp.asarray(valid[src]), key_idx,
            n_parts)
        frames = [np.asarray(f) for f in frames]
        fvalid = np.asarray(fvalid)
        for d in range(n_parts):
            lo = d * n_parts * n + s * n
            mine = gvalid[lo:lo + n]
            # validity and the zeroed padding exactly; the live rows as sets
            # (the reference's lax.sort does not promise order within a
            # bucket; K24 keeps row order)
            np.testing.assert_array_equal(mine, fvalid[d])
            for g, f in zip(got, frames):
                assert not g[lo:lo + n][~mine].any()
                assert not f[d][~fvalid[d]].any()
            assert _frame_rows(got, gvalid, lo, lo + n) == _frame_rows(
                [f[d] for f in frames], fvalid[d], 0, n)
            pos = got[-1][lo:lo + n][mine]
            assert (np.diff(pos) > 0).all(), "K24 keeps row order within a frame"
    # the reference's collective shuffle over n_parts virtual devices: the
    # same global layout (destination, then source frame)
    rm = ref_mesh.make_mesh(n_parts)
    fn = jax.jit(ref_mesh.shard_map(
        lambda *a: ref_mesh.collective_hash_shuffle(a[:-1], a[-1], key_idx, "dp"),
        mesh=rm, in_specs=P("dp"), out_specs=P("dp")))
    rcols, rvalid = fn(*[jnp.asarray(c) for c in cols], jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(rvalid), gvalid)
    for s in range(n_parts):
        for d in range(n_parts):
            lo = d * n_parts * n + s * n
            assert _frame_rows(got, gvalid, lo, lo + n) == _frame_rows(
                [np.asarray(c) for c in rcols], np.asarray(rvalid), lo, lo + n)


def test_k24_checks_its_arguments():
    v = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="shards"):
        kernels.mesh_bucketize([torch.zeros(64, dtype=torch.int32)], v[:63], (0,), 2)
    with pytest.raises(TypeError, match="unsupported column"):
        kernels.mesh_bucketize([torch.zeros(64, dtype=torch.int32),
                                torch.zeros(64, dtype=torch.int16)], v, (0,), 2)
    with pytest.raises(ValueError, match="n_parts"):
        kernels.mesh_bucketize([torch.zeros(64, dtype=torch.int32)], v, (0,), 65)


# ---------------------------------------------------------------------------
# K14: the rank PK match, against the reference's _pk_match
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "duplicate build keys", "no matches",
                                  "all invalid", "float keys"])
def test_pk_match_plain_exactly_matches_the_reference(case):
    r = np.random.default_rng(5)
    p, b = 300, 212
    if case == "float keys":
        keys = r.choice(np.array([0.0, -0.0, np.nan, 1.5, 2.5, -7.0]), p + b)
    else:
        keys = r.integers(0, 80, p + b).astype(np.int64)
    if case == "random":
        keys[p:] = r.permutation(250)[:b]  # unique build keys
    elif case == "no matches":
        keys[p:] = r.integers(1000, 2000, b)
    valid = r.random(p + b) < 0.9
    if case == "all invalid":
        valid[:] = False
    ref_idx, ref_m = ref_join._pk_match((jnp.asarray(keys),), jnp.asarray(valid), p)
    idx, m = join._pk_match([torch.from_numpy(keys)], torch.from_numpy(valid), p)
    assert idx.dtype == torch.int32 and m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    if case == "no matches" or case == "all invalid":
        assert not m.any()


def test_left_join_unmatched_rows_match_the_reference():
    """The mesh's left many-to-many join flags its output rows with no
    real build match by the plan's per-probe flags, gathered by K13's plain
    version: the reference's ``mm_unmatched``."""
    r = np.random.default_rng(8)
    p, b = 120, 90
    keys = r.integers(0, 60, p + b).astype(np.int64)
    valid = r.random(p + b) < 0.9
    limbs_t, valid_t = [torch.from_numpy(keys)], torch.from_numpy(valid)
    mc, total, offsets, bps, rp, unmatched = join.mm_plan_for(limbs_t, valid_t, p, "left",
                                                              valid_t[:p])
    probe_idx, _, _, got = join.mm_expand(mc, offsets, bps, rp, total, int(total), unmatched)
    ref_mc, *_ = ref_join.mm_plan_for([jnp.asarray(keys)], jnp.asarray(valid), p, "left",
                                      probe_valid=jnp.asarray(valid[:p]))
    exp = ref_join.mm_unmatched([jnp.asarray(keys)], jnp.asarray(valid), p,
                                jnp.asarray(probe_idx.numpy()), ref_mc)
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
