"""The port's observability plane (quokka_tpu_torch/obs) against the
reference's (quokka_tpu/obs) on the same inputs: the operator-statistics
ledger fed the same event sequences gives equal snapshots (but for the
wall clock) and the same EXPLAIN ANALYZE text; the roofline math, the
efficiency attachment and the summary agree; the calibration profile
persists, reloads and is rejected when foreign, corrupt or versioned
away.  At the slice level, TPC-H Q1 and Q3 on the CPU through both
packages give equal per-operator rows in, rows out and selectivity, and
every kernel-or-plain call on those paths is charged to devprof.

Tolerances: ledger figures exact; roofline figures exact (the same float
arithmetic).
"""

import json
import os
import threading

import pytest
import torch

import quokka_tpu
import quokka_tpu_torch
import tpch_data
from quokka_tpu import obs as ref_obs
from quokka_tpu.obs import devprof as ref_devprof
from quokka_tpu.obs import explain as ref_explain
from quokka_tpu.obs import opstats as ref_opstats
from quokka_tpu_torch import obs
from quokka_tpu_torch.obs import devprof, explain, opstats
from quokka_tpu_torch.runtime import scancache

from torch_port_util import fresh_aot  # noqa: F401
from test_torch_q1 import q1
from test_torch_q3q5 import q3

PKGS = {"ref": (ref_opstats, ref_devprof, ref_explain, ref_obs),
        "port": (opstats, devprof, explain, obs)}


class _Reader:
    def __init__(self, hint):
        self._hint = hint

    def size_hint(self):
        return self._hint


class _Actor:
    def __init__(self, kind, channels=2, targets=(), stage=0, reader=None):
        self.kind = kind
        self.channels = channels
        self.targets = {t: None for t in targets}
        self.stage = stage
        if reader is not None:
            self.reader = reader


class _Graph:
    """The TaskGraph surface register_plan reads."""

    def __init__(self, qid, actors, plan_fp="fp-test", decisions=()):
        self.query_id = qid
        self.actors = actors
        self.plan_fp = plan_fp
        self.planner_decisions = list(decisions)


def _graph(qid):
    return _Graph(qid, {
        0: _Actor("input", channels=2, targets=(1,), reader=_Reader(1 << 20)),
        1: _Actor("exec", channels=2, targets=(2,), stage=1),
        2: _Actor("exec", channels=1, stage=2),
    }, decisions=[{"kind": "adapt_mark", "joins": ["join a=b"], "skew_ratio": 2.0}])


class _Dev:
    """A deferred count, resolved with int() at the flush."""

    def __init__(self, n):
        self._n = n

    def __int__(self):
        return self._n


class _Valid:
    nbytes = 128


class _Batch:
    def __init__(self, nrows=None, nrows_dev=None, padded_len=0):
        self.nrows = nrows
        self.nrows_dev = nrows_dev
        self.padded_len = padded_len
        self.valid = _Valid()
        self.columns = {}


@pytest.fixture(autouse=True)
def _clean():
    for op, dp, _, _ in PKGS.values():
        dp.reset()
    yield
    for op, dp, _, _ in PKGS.values():
        dp.reset()
        if hasattr(op._CUR, "key"):
            del op._CUR.key


def _feed(s, mod, qid, dev):
    """A little run: 1000 scan rows (900 past the predicate), a skewed
    exchange onto a1, an aggregate down to 10 rows at a2, deferred counts,
    a note through the current operator, an adaptation record."""
    s.register_plan(_graph(qid), op_names={1: "PartialAgg", 2: "FinalAgg"})
    s.scan(qid, 0, 0, rows_raw=600, rows_out=500, nbytes=6000, padded=640)
    s.scan(qid, 0, 1, rows_raw=400, rows_out=dev(400), nbytes=4000, padded=512)
    s.edge(qid, 0, 1, 0, 900)
    s.edge(qid, 0, 1, 1, dev(0))  # every row on channel 0: ratio 2.0, skewed
    s.exec_in(qid, 1, 0, [_Batch(nrows=900, padded_len=1024), _Batch(nrows_dev=dev(30),
                                                                      padded_len=256)])
    s.exec_in(qid, 1, 1, [_Batch(padded_len=256)])  # unknown: never read
    with s.current_op(qid, 1, 0):
        mod.note(join_build_rows=40)
        mod.note(join_build_rows=2, join_probe_rows=7)
    mod.note(join_build_rows=999)  # outside a dispatch: dropped
    s.exec_out(qid, 1, 0, 900)
    s.exec_out(qid, 1, 1, 0)
    s.edge(qid, 1, 2, 0, dev(12))
    s.exec_in(qid, 2, 0, [_Batch(nrows=900, padded_len=1024)])
    s.exec_out(qid, 2, 0, dev(10))
    s.dispatch_time(qid, 1, 0, 0.3)
    s.dispatch_time(qid, 2, 0, 0.1)
    s.note_adaptation(qid, {"kind": "adapt_runtime", "edge": "a0->a1", "fat_channel": 0,
                            "fat_rows": 900, "mean_rows": 465, "total_rows": 930,
                            "ratio": 1.94, "action": "salt"})


def _both(fn):
    """fn(ledger, opstats module) under each package, with note() routed to
    that package's fresh ledger."""
    out = {}
    for name, (op, dp, ex, ob) in PKGS.items():
        s = op.OpStats()
        orig = op.OPSTATS
        op.OPSTATS = s
        try:
            out[name] = fn(s, op, dp, ex)
        finally:
            op.OPSTATS = orig
            s.reset()
    return out["ref"], out["port"]


def _no_clock(snap):
    snap = json.loads(json.dumps(snap))
    snap["wall_s"] = 0.0
    return snap


@pytest.mark.parametrize("dev", [_Dev, lambda n: torch.tensor(n, dtype=torch.int32)],
                         ids=["int", "tensor"])
def test_ledger_snapshots_and_render_equal_the_reference(dev):
    def run(s, op, dp, ex):
        _feed(s, op, "qfeed", dev if op is opstats else _Dev)
        snap = _no_clock(s.snapshot("qfeed"))
        return (snap, ex.render(snap), ex.operators_detail(snap), ex.efficiency_detail(snap),
                ex.skew_flags(snap), s.top_operator("qfeed"))

    ref, port = _both(run)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert "** SKEWED **" in port[1] and "RUNTIME adapt a0->a1" in port[1]
    assert port[2:] == ref[2:]
    ops = {o["actor"]: o for o in port[0]["operators"]}
    assert ops[0]["rows_out"] == 900 and ops[1]["rows_in"] == 930
    assert ops[1]["join_build_rows"] == 42 and ops[1]["rows_unknown"] == 1
    assert ops[2]["rows_out"] == 10


def test_gc_keeps_last_finished_and_drops_state():
    def run(s, op, dp, ex):
        _feed(s, op, "qgc", _Dev)
        snap = s.on_query_gc("qgc", plan_fp=None)
        s.scan("qgc", 0, 0, rows_raw=5, rows_out=5, nbytes=1, padded=8)  # straggler
        last = s.last_finished()
        reg = PKGS["ref" if op is ref_opstats else "port"][3].REGISTRY.snapshot()
        return (_no_clock(snap), _no_clock(last),
                any(k.startswith("opstats.rows_in.qgc") for k in reg),
                s.snapshot("qgc") is last, s.top_operator("qgc"))

    ref, port = _both(run)
    assert port == ref
    assert port[2] is False and port[3] is True


def test_unregistered_query_records_nothing():
    def run(s, op, dp, ex):
        s.scan("ghost", 0, 0, rows_raw=5, rows_out=5, nbytes=1, padded=8)
        s.edge("ghost", 0, 1, 0, 5)
        return s.snapshot("ghost"), s.top_operator("ghost"), s.last_finished()

    ref, port = _both(run)
    assert port == ref == (None, None, None)


def test_concurrent_recording_is_consistent():
    s = opstats.OpStats()
    s.register_plan(_graph("qrace"))

    def pump(ch):
        for _ in range(200):
            s.scan("qrace", 0, ch, rows_raw=3, rows_out=2, nbytes=10, padded=4)
            s.edge("qrace", 0, 1, ch, 2)
            s.exec_in("qrace", 1, ch, [_Batch(nrows=2, padded_len=4)])

    ts = [threading.Thread(target=pump, args=(ch,)) for ch in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    snap = s.snapshot("qrace")
    ops = {o["actor"]: o for o in snap["operators"]}
    assert ops[0]["rows_in"] == 1200 and ops[0]["rows_out"] == 800
    assert snap["edges"][0]["channel_rows"] == [400, 400]
    s.reset()


def test_cardinality_profile_roundtrip_and_rejection(tmp_path, monkeypatch):
    monkeypatch.setenv("QK_CARDPROFILE_DIR", str(tmp_path))
    s = opstats.OpStats()
    _feed(s, opstats, "qcard", _Dev)
    snap = s.on_query_gc("qcard", plan_fp="fp-test")
    assert opstats.measured_source_bytes("fp-test") == 10000 == sum(
        o["bytes_out"] for o in snap["operators"] if o["kind"] == "input")
    assert opstats.measured_calib_rows() == 900  # the largest rows_out
    assert opstats.measured_source_bytes("fp-other") is None
    path = opstats._profile_path()
    assert os.path.basename(path) == devprof.backend_fingerprint() + ".json"
    prof = json.load(open(path))
    prof["fingerprint"] = "cuda-8x-deadbeef"
    json.dump(prof, open(path, "w"))
    assert opstats.measured_source_bytes("fp-test") is None
    with open(path, "w") as f:
        f.write("{torn")
    assert opstats.measured_source_bytes("fp-test") is None
    monkeypatch.setenv("QK_CARDPROFILE_DIR", "")
    assert opstats.measured_calib_rows() is None
    s.reset()


GRID = [(f, b, t, pf, pb) for f in (0.0, 1e6, 1e9) for b in (0.0, 1e6, 1e9)
        for t in (None, 0.0, 1e-3, 1.0) for pf, pb in ((None, None), (1e12, 1e10), (6.7e13, 3.35e12))]


def test_roofline_equals_the_reference():
    for args in GRID:
        assert devprof.roofline(*args) == ref_devprof.roofline(*args), args


class _Compiled:
    def __init__(self, flops, nbytes, out):
        self._ca = {"flops": flops, "bytes accessed": nbytes, "bytes accessedout{}": out}

    def cost_analysis(self):
        return [self._ca]


@pytest.mark.parametrize("calibrated", [False, True])
def test_attach_and_summary_equal_the_reference(calibrated):
    def run(s, op, dp, ex):
        if calibrated:
            dp._install({"version": 1, "fingerprint": "test-fp", "peak_flops_s": 1e12,
                         "peak_bw_bytes_s": 1e10, "sources": {}})
        s.register_plan(_Graph("qeff", {0: _Actor("input", targets=(1,), reader=_Reader(0)),
                                        1: _Actor("exec", stage=1)}))
        if dp is devprof:
            dp.record_cost(("K9", 1), 1000.0, 500.0, 100.0)
        else:
            dp.record_cost(("K9", 1), _Compiled(1000.0, 500.0, 100.0))
        with s.current_op("qeff", 1, 0):
            dp.on_dispatch(("K9", 1))
            dp.on_dispatch(("K9", 1))
        dp.on_dispatch(("K9", 1))  # outside an operator: tallied, not attributed
        s.dispatch_time("qeff", 1, 0, 0.5)
        s.exec_out("qeff", 1, 0, 10)
        snap = _no_clock(s.snapshot("qeff"))
        summ = dict(dp.summary())
        costs = [{k: v for k, v in r.items() if k not in ("sig", "kernel", "device")}
                 for r in dp.costs_snapshot()]
        return snap, ex.render(snap), summ, costs

    ref, port = _both(run)
    assert port == ref
    row = port[0]["efficiency"]["operators"][0]
    assert row["flops"] == 2000.0 and row["program_dispatches"] == 2
    assert port[3][0]["dispatches"] == 3


def test_on_dispatch_records_a_cost_once():
    calls = []

    def cost():
        calls.append(1)
        return 0.0, 64.0, 16.0

    devprof.on_dispatch(("K0", "cpu", 8), cost)
    devprof.on_dispatch(("K0", "cpu", 8), cost)
    devprof.on_dispatch(("K0", "cpu", 9))  # uncosted, no formula: ignored
    (row,) = devprof.costs_snapshot()
    assert (row["kernel"], row["device"], row["bytes"], row["dispatches"], len(calls)) == \
        ("K0", "cpu", 64.0, 2, 1)


class TestCalibration:
    def test_calibrate_persists_and_reloads(self, tmp_path, monkeypatch):
        monkeypatch.setenv("QK_DEVPROF_DIR", str(tmp_path))
        prof = devprof.calibrate(device="cpu")
        assert prof["peak_flops_s"] > 0 and prof["peak_bw_bytes_s"] > 0
        assert prof["timings_s"]["matmul_s"] > 0 and prof["device"].startswith("cpu")
        assert prof["matmul_allow_tf32"] is bool(torch.backends.cuda.matmul.allow_tf32)
        path = os.path.join(str(tmp_path), f"{prof['fingerprint']}.json")
        assert os.path.exists(path)
        assert obs.REGISTRY.gauge("devprof.peak_flops").value == prof["peak_flops_s"]
        devprof.reset()
        p2 = devprof.peaks()
        assert p2 is not None and p2["peak_flops_s"] == prof["peak_flops_s"]

    def test_foreign_fingerprint_rejected_wholesale(self, tmp_path, monkeypatch):
        monkeypatch.setenv("QK_DEVPROF_DIR", str(tmp_path))
        prof = devprof.calibrate(device="cpu")
        path = os.path.join(str(tmp_path), f"{prof['fingerprint']}.json")
        data = json.load(open(path))
        data["fingerprint"] = "cuda-8x-deadbeef"
        json.dump(data, open(path, "w"))
        devprof.reset()
        assert devprof.peaks() is None

    def test_corrupt_or_versioned_away_profile_rejected(self, tmp_path, monkeypatch):
        monkeypatch.setenv("QK_DEVPROF_DIR", str(tmp_path))
        path = os.path.join(str(tmp_path), f"{devprof.backend_fingerprint()}.json")
        with open(path, "w") as f:
            f.write("{torn write")
        assert devprof.peaks() is None
        devprof.reset()
        json.dump({"version": -1, "fingerprint": devprof.backend_fingerprint(),
                   "peak_flops_s": 1.0, "peak_bw_bytes_s": 1.0, "sources": {}},
                  open(path, "w"))
        assert devprof.peaks() is None

    def test_ensure_calibrated_honors_skip_knob(self, tmp_path, monkeypatch):
        monkeypatch.setenv("QK_DEVPROF_DIR", str(tmp_path))
        monkeypatch.setenv("QK_DEVPROF_CALIBRATE", "0")
        assert devprof.ensure_calibrated(device="cpu") == {}
        assert devprof.peaks() is None

    def test_persistence_disabled_by_empty_dir(self, monkeypatch):
        monkeypatch.setenv("QK_DEVPROF_DIR", "")
        assert devprof._dir() is None
        assert devprof.calibrate(device="cpu")["peak_flops_s"] > 0
        devprof.reset()
        assert devprof.peaks() is None

    def test_query_gc_persists_observations(self, tmp_path, monkeypatch):
        monkeypatch.setenv("QK_DEVPROF_DIR", str(tmp_path))
        devprof.calibrate(device="cpu")
        s = opstats.OpStats()
        s.register_plan(_Graph("qobs", {0: _Actor("input", targets=(1,), reader=_Reader(0)),
                                        1: _Actor("exec", stage=1)}))
        devprof.on_dispatch(("K0", 1), lambda: (0.0, 1e6, 0.0))
        with s.current_op("qobs", 1, 0):
            devprof.on_dispatch(("K0", 1))
        s.dispatch_time("qobs", 1, 0, 0.25)
        s.on_query_gc("qobs")
        devprof.reset()
        assert devprof.peaks()["observed_bw_bytes_s"] == pytest.approx(4e6)
        s.reset()


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=7)
    root = tmp_path_factory.mktemp("tpch_obs")
    return tpch_data.write_parquet_dir(tables, str(root))


def _rows(snap):
    return {o["actor"]: (o["op"], o["kind"], o["rows_in"], o["rows_out"], o.get("selectivity"),
                         o["rows_unknown"]) for o in snap["operators"]}


# per kernel, the function called once per kernel-or-plain call on the CPU
CALLS = {"K1": ("ops.fuse", "predicate_plain"), "K2": ("ops.fuse", "SmallCall.plain"),
         "K3": ("ops.hashtable", "hash_groupby"), "K4": ("ops.kernels", "partition_split"),
         "K5": ("ops.fuse", "PreAggCall.plain"), "K11 build": ("ops.hashtable", "_build_insert"),
         "K11": ("ops.hashtable", "probe"), "K23": ("ops.pack", "decode_plain"),
         "K8": ("ops.bridge", "compact_concat_plain")}


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_slice_operator_rows_equal_the_reference(tpch, query, monkeypatch, fresh_aot):
    """Q1 and Q3 on the CPU: the explain() plans match, and so do the
    per-operator rows in, rows out and selectivity of last_finished(); every
    kernel-or-plain call is a devprof dispatch of that kernel."""
    import importlib

    def run(pkg, ctx):
        if query == "q1":
            return q1(ctx, tpch["lineitem"])
        return q3(pkg, ctx, tpch).collect()

    calls = {k: 0 for k in CALLS}
    lock = threading.Lock()  # K23's plain version runs on the engine's IO threads
    for kernel, (mod, attr) in CALLS.items():
        owner = importlib.import_module(f"quokka_tpu_torch.{mod}")
        if "." in attr:
            cls, attr = attr.split(".")
            owner = getattr(owner, cls)
        real = getattr(owner, attr)

        def counted(*a, _k=kernel, _real=real, **kw):
            with lock:
                calls[_k] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(owner, attr, counted)
    devprof.reset()
    scancache.clear()  # the scan lands its batches (K23) in this run
    port_ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    run(quokka_tpu_torch, port_ctx)
    port = obs.OPSTATS.last_finished()
    run(quokka_tpu, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2))
    ref = ref_obs.OPSTATS.last_finished()
    assert _rows(port) == _rows(ref)
    assert all(o["rows_unknown"] == 0 for o in port["operators"])
    charged = {}
    for r in devprof.costs_snapshot():
        assert r["device"] == "cpu"
        charged[r["kernel"]] = charged.get(r["kernel"], 0) + r["dispatches"]
    ran = {k: n for k, n in calls.items() if n}
    assert {k: charged.get(k, 0) for k in ran} == ran
    assert set(charged) == set(ran)
    assert {"K1", "K23"} <= set(ran)
    text = explain.render(port)
    assert text.startswith(f"EXPLAIN ANALYZE {port['query_id']}")
    assert "device efficiency" in text
