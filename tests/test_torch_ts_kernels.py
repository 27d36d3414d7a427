"""The time-series kernels of the PyTorch port against the reference
(quokka_tpu, JAX x64 on the CPU), on identical inputs made from a numpy seed.

K18 (the sorted-quote probe) against ``_ss_sort_quotes`` + ``_ss_probe``,
K19 (segmented fill-forward) against ``_seg_fill_forward``, K19's segment
bounds against ``_seg_fill_forward`` over the start rows +
``_rows_from_segment_end``, K20a (window bounds) against
``_bisect_left_segmented`` + ``_bisect_right_segmented``,
K20b (range min/max) against ``_range_minmax``, and the torch rows beside
them (``reduce_array``, ``_rows_from_segment_end``, the sort strategy's
``_asof_match``).  The port runs each kernel's plain torch version here
(the tensors lie on the CPU); tests/test_torch_cuda.py and chip_smoke.py
hold the CUDA kernels against those plain versions on a card.

Every kernel output here is an index, a flag, a count or a min / max, so
those comparisons are exact; only ``reduce_array``'s float sum holds to
rtol 1e-9 (another summation order, the suite's own tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quokka_tpu.executors import ts_execs as ref_ts
from quokka_tpu.ops import asof as ref_asof
from quokka_tpu.ops import kernels as ref_kernels
from quokka_tpu_torch import sqlparse
from quokka_tpu_torch.executors import ts_execs
from quokka_tpu_torch.ops import asof, bridge, kernels
from quokka_tpu_torch.ops.expr_compile import plan_aggregation
from quokka_tpu_torch.windows import SlidingWindow

import torch_port_util  # noqa: F401  (a private reference AOT store per process)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# K18: sort the quotes once, binary-search every trade
# ---------------------------------------------------------------------------


def _tick_ops(r, n, n_keys, key_kind, time_kind, t_hi):
    """Key limbs (none, two int32 hash-like limbs, or one int64) and a time
    limb for n rows; coarse times and few keys force (key, time) ties."""
    if key_kind == "none":
        keys = []
    elif key_kind == "str":
        code = r.integers(0, n_keys, n)
        hi = (np.array([0x5A5A5A5A, -0x1234567, 77, -5, 12345])[code % 5]).astype(np.int32)
        keys = [hi, (code * 7919 - 3).astype(np.int32)]
    else:
        keys = [r.integers(-3, n_keys - 3, n).astype(np.int64)]
    t = r.integers(0, t_hi, n)
    t = t.astype(np.float64) / 4 if time_kind == "float" else t.astype(np.int64)
    return keys, t


CASES = ["ties", "many_keys", "empty_quotes", "all_invalid_probe", "one_key"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("key_kind,time_kind", [("str", "int"), ("int", "float"),
                                                ("none", "int")])
def test_k18_probe_matches_reference(case, direction, key_kind, time_kind):
    r = np.random.default_rng(len(case) * 31 + len(direction) + len(key_kind))
    nq, p = 1024, 512
    n_keys = {"many_keys": 40, "one_key": 1}.get(case, 3)
    t_hi = 40 if case in ("ties", "one_key") else 5000
    qk, qt = _tick_ops(r, nq, n_keys, key_kind, time_kind, t_hi)
    pk, pt = _tick_ops(r, p, n_keys, key_kind, time_kind, t_hi)
    qvalid = r.random(nq) < 0.85
    pvalid = r.random(p) < 0.9
    if case == "empty_quotes":
        qvalid[:] = False
    if case == "all_invalid_probe":
        pvalid[:] = False
    upper, nkey = direction == "backward", len(qk)
    steps = max(1, int(np.ceil(np.log2(max(2, nq)))) + 1)

    r_sorted, r_perm, r_nv = ref_asof._ss_sort_quotes(
        tuple(jnp.asarray(a) for a in qk + [qt]), jnp.asarray(qvalid))
    r_idx, r_m = ref_asof._ss_probe(r_sorted, r_perm, r_nv,
                                    tuple(jnp.asarray(a) for a in pk + [pt]),
                                    jnp.asarray(pvalid), steps, upper, nkey)

    s_sorted, s_perm, s_nv = asof._ss_sort_quotes([_t(a) for a in qk + [qt]], _t(qvalid))
    for a, b in zip(s_sorted, r_sorted):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(s_perm), np.asarray(r_perm))
    assert int(s_nv) == int(r_nv)
    idx, m = asof.asof_probe(s_sorted, s_perm, s_nv, [_t(a) for a in pk + [pt]], _t(pvalid),
                             upper, nkey)
    assert idx.dtype == torch.int32 and m.dtype == torch.bool
    np.testing.assert_array_equal(_np(m), np.asarray(r_m))
    np.testing.assert_array_equal(_np(idx), np.asarray(r_idx))
    if case == "all_invalid_probe" or case == "empty_quotes":
        assert not _np(m).any()
    else:
        assert _np(m).any()


# ---------------------------------------------------------------------------
# K19: segmented fill-forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 257, 5000])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_k19_fill_forward_matches_reference(n, density):
    r = np.random.default_rng(n + int(density * 100))
    values = r.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    values[r.random(n) < 0.5] = -1
    starts = r.random(n) < density
    ref = ref_asof._seg_fill_forward(jnp.asarray(values), jnp.asarray(starts))
    got = asof.seg_fill_forward(_t(values), _t(starts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_k19_as_the_segment_start_of_sorted_keys():
    """The windows and shift use K19 to give every row its key segment's
    first row: the last start flag at or before the row."""
    keys = np.repeat(np.arange(7), [3, 1, 5, 2, 8, 1, 4])
    iota = np.arange(len(keys), dtype=np.int32)
    flag = np.r_[True, keys[1:] != keys[:-1]]
    got = _np(asof.seg_fill_forward(_t(np.where(flag, iota, -1).astype(np.int32)), _t(flag)))
    starts = np.searchsorted(keys, keys, side="left")
    np.testing.assert_array_equal(got, starts)


def _ref_segment_bounds(flag):
    n = len(flag)
    iota = np.arange(n, dtype=np.int32)
    start = ref_asof._seg_fill_forward(jnp.asarray(np.where(flag, iota, -1).astype(np.int32)),
                                       jnp.asarray(flag))
    end = iota + np.asarray(ref_ts._rows_from_segment_end(jnp.asarray(iota), jnp.asarray(flag),
                                                          n))
    return np.asarray(start), end


@pytest.mark.parametrize("n", [0, 1, 2, 257, 5000])
@pytest.mark.parametrize("density", ["every row", 0.3, 0.01, "one segment", "none"])
def test_k19_segment_bounds_match_reference(n, density):
    """Each row's segment start and end from the start flags, from the
    densest (every row its own segment) to one segment and no flag at all
    (rows before the first flag start at -1)."""
    r = np.random.default_rng(n * 7 + len(str(density)))
    if density == "every row":
        flag = np.ones(n, dtype=bool)
    elif density == "one segment":
        flag = np.arange(n) == 0
    elif density == "none":
        flag = np.zeros(n, dtype=bool)
    else:
        flag = r.random(n) < density
    start, end = asof.segment_bounds(_t(flag))
    assert start.dtype == end.dtype == torch.int32
    r_start, r_end = _ref_segment_bounds(flag)
    np.testing.assert_array_equal(_np(start), r_start)
    np.testing.assert_array_equal(_np(end), r_end)


def test_k19_segment_bounds_of_one_row_segments_and_padding():
    """Runs of one row between longer runs, then the padding after the live
    rows as a segment of its own, flagged where validity changes as the
    windows' and shift's ``_segments`` flags it."""
    lens = [1, 1, 4, 1, 9, 1, 1, 2, 1]
    key = np.repeat(np.arange(len(lens)), lens)
    valid = np.r_[np.ones(len(key), dtype=bool), np.zeros(13, dtype=bool)]
    key = np.r_[key, np.zeros(13, dtype=key.dtype)]
    iota = np.arange(len(key))
    flag = (valid != np.roll(valid, 1)) | (key != np.roll(key, 1)) | (iota == 0)
    start, end = asof.segment_bounds(_t(flag))
    r_start, r_end = _ref_segment_bounds(flag)
    np.testing.assert_array_equal(_np(start), r_start)
    np.testing.assert_array_equal(_np(end), r_end)
    assert _np(start)[-1] == len(iota) - 13 and _np(end)[len(iota) - 14] == len(iota) - 14


def _key_ticks(r, n, n_keys):
    t = np.sort(r.integers(0, 40 * n, n)).astype(np.int64)
    return bridge.HostTable({"sym": r.integers(0, n_keys, n).astype(np.int64), "time": t,
                             "px": r.uniform(10, 20, n).round(3)})


@pytest.mark.parametrize("n_keys", [1, 5])
def test_sliding_and_shift_executors_over_segment_bounds(n_keys):
    """The sliding-window and shift executors, which take every row's
    segment start and end from K19's segment bounds, over two padded
    batches with a carried tail, against a numpy oracle per key: the same
    lags and window sums as before the bounds came from one call."""
    r = np.random.default_rng(40 + n_keys)
    hosts = [_key_ticks(r, 900, n_keys), _key_ticks(r, 700, n_keys)]
    hosts[1].columns["time"] += hosts[0].columns["time"].max() + 1
    batches = [bridge.host_to_device(h, "cpu", sorted_by=["time"]) for h in hosts]
    assert all(b.padded_len > b.nrows for b in batches)
    allc = {c: np.concatenate([h.columns[c] for h in hosts]) for c in ("sym", "time", "px")}
    size = 400
    shift = ts_execs.ShiftExecutor("time", ["sym"], ["px"], 2)
    plan = plan_aggregation(sqlparse.parse_select_list("sum(px) as tot, count(*) as n"))
    slide = ts_execs.SlidingWindowExecutor("time", ["sym"], SlidingWindow(size), plan)
    got_shift = [bridge.device_to_host(shift.execute([b], 0, 0)) for b in batches]
    got_slide = [bridge.device_to_host(slide.execute([b], 0, 0)) for b in batches]
    got_shift = {c: np.concatenate([g[c] for g in got_shift]) for c in got_shift[0]}
    got_slide = {c: np.concatenate([g[c] for g in got_slide]) for c in got_slide[0]}
    want_lag = np.full(len(allc["time"]), np.nan)
    want_tot = np.zeros(len(allc["time"]))
    want_n = np.zeros(len(allc["time"]))
    for k in np.unique(allc["sym"]):
        rows = np.flatnonzero(allc["sym"] == k)
        t, px = allc["time"][rows], allc["px"][rows]
        want_lag[rows[2:]] = px[:-2]
        lo = np.searchsorted(t, t - size, side="left")
        hi = np.searchsorted(t, t, side="right")
        cs = np.r_[0.0, np.cumsum(px)]
        want_tot[rows] = cs[hi] - cs[lo]
        want_n[rows] = hi - lo
    for got, cols in ((got_shift, ["px_shifted_2"]), (got_slide, ["tot", "n"])):
        o = np.lexsort((got["time"], got["sym"]))
        w = np.lexsort((allc["time"], allc["sym"]))
        np.testing.assert_array_equal(got["time"][o], allc["time"][w])
        for c in cols:
            want = {"px_shifted_2": want_lag, "tot": want_tot, "n": want_n}[c][w]
            np.testing.assert_allclose(got[c][o], want, rtol=1e-9, atol=0)


# ---------------------------------------------------------------------------
# the sort strategy's match (row 10's rank, one sort, K19)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["backward", "forward"])
def test_sort_strategy_match_matches_reference(direction):
    r = np.random.default_rng(17 if direction == "backward" else 18)
    t, q = 512, 1024
    keys = r.integers(0, 4, t + q).astype(np.int64)
    times = r.integers(0, 50, t + q).astype(np.int64)
    valid = r.random(t + q) < 0.9
    is_trade = np.arange(t + q) < t
    fwd = direction == "forward"
    tt = -times if fwd else times
    r_idx, r_m = ref_asof._asof_match((jnp.asarray(keys),), (jnp.asarray(tt),),
                                      jnp.asarray(is_trade), jnp.asarray(valid), t,
                                      forward_ties=fwd)
    idx, m = asof._asof_match([_t(keys)], [_t(tt)], _t(is_trade), _t(valid), t,
                              forward_ties=fwd)
    np.testing.assert_array_equal(_np(m), np.asarray(r_m))
    live = _np(m)
    assert live.any()
    # invalid rows' ranks are arbitrary in both packages: matched rows only
    np.testing.assert_array_equal(_np(idx)[live], np.asarray(r_idx)[live])


# ---------------------------------------------------------------------------
# K20a: window bounds; K20b: range min / max; row 20's segment ends
# ---------------------------------------------------------------------------


def _sorted_segments(r, n, n_keys, time_kind, padding):
    """Rows sorted by (key, time) with equal timestamps, then `padding`
    rows of garbage (what a padded batch holds past its live rows)."""
    key = np.sort(r.integers(0, n_keys, n))
    t = r.integers(0, 3000, n)
    order = np.lexsort((t, key))
    key, t = key[order], t[order]
    key = np.r_[key, np.zeros(padding, dtype=key.dtype)]
    t = np.r_[t, r.integers(0, 3000, padding)]
    t = t.astype(np.float64) / 2 if time_kind == "float" else t.astype(np.int64)
    m = len(t)
    iota = np.arange(m, dtype=np.int32)
    flag = np.r_[True, key[1:] != key[:-1]]
    seg_start = np.asarray(ref_asof._seg_fill_forward(
        jnp.asarray(np.where(flag, iota, -1).astype(np.int32)), jnp.asarray(flag)))
    return t, iota, flag, seg_start


def test_rows_from_segment_end_matches_reference():
    r = np.random.default_rng(5)
    _, iota, flag, _ = _sorted_segments(r, 900, 6, "int", 124)
    ref = ref_ts._rows_from_segment_end(jnp.asarray(iota), jnp.asarray(flag), len(iota))
    got = ts_execs._rows_from_segment_end(_t(iota), _t(flag), len(iota))
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("time_kind", ["int", "float"])
@pytest.mark.parametrize("size", [0, 25, 400, 10**6])
@pytest.mark.parametrize("n_keys", [1, 9])
def test_k20a_bounds_match_reference(time_kind, size, n_keys):
    r = np.random.default_rng(size + n_keys)
    t, iota, flag, seg_start = _sorted_segments(r, 1800, n_keys, time_kind, 248)
    m = len(t)
    seg_end = iota + np.asarray(ref_ts._rows_from_segment_end(
        jnp.asarray(iota), jnp.asarray(flag), m))
    jt = jnp.asarray(t)
    r_left = ref_ts._bisect_left_segmented(jt, jt - size, jnp.asarray(seg_start),
                                           jnp.asarray(iota))
    r_right = ref_ts._bisect_right_segmented(jt, jt, jnp.asarray(iota), jnp.asarray(seg_end))
    left, right = ts_execs.window_bounds(_t(t), _t(seg_start), _t(seg_end.astype(np.int32)),
                                         size)
    assert left.dtype == right.dtype == torch.int32
    # every row, the garbage padding rows included
    np.testing.assert_array_equal(_np(left), np.asarray(r_left))
    np.testing.assert_array_equal(_np(right), np.asarray(r_right))


@pytest.mark.parametrize("size", [2.5, 0.5])
def test_k20a_fractional_size_on_int_times_matches_reference(size):
    """int64 times minus a fractional size: the reference (x64) compares in
    float64; float32 targets lose the epoch-millisecond times' low digits."""
    r = np.random.default_rng(int(size * 10))
    n = 3000
    key = np.sort(r.integers(0, 3, n))
    t = r.integers(0, 40, n) + 1_700_000_000_000
    o = np.lexsort((t, key))
    key, t = key[o], t[o]
    iota = np.arange(n, dtype=np.int32)
    flag = np.r_[True, key[1:] != key[:-1]]
    seg_start, seg_end = _ref_segment_bounds(flag)
    jt = jnp.asarray(t)
    r_left = ref_ts._bisect_left_segmented(jt, jt - size, jnp.asarray(seg_start),
                                           jnp.asarray(iota))
    r_right = ref_ts._bisect_right_segmented(jt, jt, jnp.asarray(iota), jnp.asarray(seg_end))
    left, right = ts_execs.window_bounds(_t(t), _t(seg_start), _t(seg_end.astype(np.int32)),
                                         size)
    np.testing.assert_array_equal(_np(left), np.asarray(r_left))
    np.testing.assert_array_equal(_np(right), np.asarray(r_right))
    assert (_np(left) < iota).any()


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32, np.int32])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_k20b_range_minmax_matches_reference(dtype, op, n):
    r = np.random.default_rng(n + len(op))
    if dtype in (np.float64, np.float32):
        x = r.normal(size=n).round(2).astype(dtype)
        x[r.random(n) < 0.02] = np.nan
    elif dtype == np.int64:
        x = r.integers(-(2**62), 2**62, n)
    else:
        x = r.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    left = r.integers(0, n, n)
    span = r.integers(0, 3, n) ** r.integers(0, 12, n)
    right = np.minimum(left + span, n - 1)
    left[r.random(n) < 0.05] = n - 1  # left > right: the degenerate range
    left, right = left.astype(np.int32), right.astype(np.int32)
    ref = ref_ts._range_minmax(jnp.asarray(x), jnp.asarray(left), jnp.asarray(right), op)
    got = ts_execs.range_minmax(_t(x), _t(left), _t(right), op)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_k20b_on_sliding_window_bounds():
    """K20b over the bounds K20a gives equals a direct min / max per row."""
    r = np.random.default_rng(11)
    t, iota, flag, seg_start = _sorted_segments(r, 1500, 4, "int", 0)
    seg_end = iota + _np(ts_execs._rows_from_segment_end(_t(iota), _t(flag), len(t)))
    left, right = ts_execs.window_bounds(_t(t), _t(seg_start), _t(seg_end.astype(np.int32)),
                                         300)
    x = r.uniform(10, 500, len(t)).round(3)
    lo = _np(ts_execs.range_minmax(_t(x), left, right, "min"))
    hi = _np(ts_execs.range_minmax(_t(x), left, right, "max"))
    for i in range(0, len(t), 37):
        w = x[_np(left)[i]: _np(right)[i] + 1]
        assert lo[i] == w.min() and hi[i] == w.max()


# ---------------------------------------------------------------------------
# row 9: reduce_array, the watermarks' reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.int32])
@pytest.mark.parametrize("live", ["some", "none"])
def test_reduce_array_matches_reference(op, dtype, live):
    r = np.random.default_rng(len(op))
    arr = (r.normal(size=600) * 1000).astype(dtype)
    valid = r.random(600) < (0.6 if live == "some" else 0.0)
    ref = ref_kernels.reduce_array(jnp.asarray(arr), jnp.asarray(valid), op)
    got = kernels.reduce_array(_t(arr), _t(valid), op)
    assert got.dim() == 0
    if op == "sum" and dtype == np.float64 and live == "some":
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-9, atol=0)
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.zeros(8, device="meta")
    i32 = meta.to(torch.int32)
    with pytest.raises(RuntimeError, match="unsupported device"):
        asof.seg_fill_forward(i32, meta.bool())
    with pytest.raises(RuntimeError, match="unsupported device"):
        asof.segment_bounds(meta.bool())
    with pytest.raises(RuntimeError, match="unsupported device"):
        asof.asof_probe([i32], i32, meta.long()[0], [i32], meta.bool(), True, 0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ts_execs.window_bounds(meta.long(), i32, i32, 5)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ts_execs.range_minmax(meta, i32, i32, "min")
