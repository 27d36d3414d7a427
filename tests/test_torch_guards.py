"""Guards of the PyTorch port: it never imports JAX or quokka_tpu, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "quokka_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "quokka_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_names_no_jax_or_reference(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quokka_tpu'] = None\n"
        "import quokka_tpu_torch\n"
        "from quokka_tpu_torch.ops import fuse, hashtable, kernels, bridge, native\n"
        "from quokka_tpu_torch.executors import sql_execs, output\n"
        "from quokka_tpu_torch.runtime import engine\n"
        "from quokka_tpu_torch.parallel import mesh, mesh_exec\n"
        "assert 'triton' not in sys.modules, 'triton imported at module import'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_planner_imports_with_jax_and_reference_blocked():
    """The adaptive exchange's modules (planner/, and the engine and
    optimizer that use them) import without JAX or quokka_tpu."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quokka_tpu'] = None\n"
        "from quokka_tpu_torch.planner import adapt, decide\n"
        "from quokka_tpu_torch import optimizer\n"
        "from quokka_tpu_torch.runtime import engine\n"
        "assert optimizer.decide is decide and engine.adapt_mod is adapt\n"
        "assert 'triton' not in sys.modules, 'triton imported at module import'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_context_defaults_to_cuda_and_raises_without_it():
    from quokka_tpu_torch import QuokkaContext

    if torch.cuda.is_available():
        assert QuokkaContext().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        QuokkaContext()
    with pytest.raises(RuntimeError, match="cuda"):
        QuokkaContext(device="cuda:0")
    assert QuokkaContext(device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from quokka_tpu_torch.ops import hashtable, kernels

    meta = torch.zeros(4, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        hashtable.hash_groupby([meta], [meta], ["sum"], meta.bool())
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.partition_split([meta], None, meta.bool(), 2)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (or outside a checkout) the smoke script exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path cannot be exercised")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("ev, want", [
    ({"k": (30.0, 3)}, {"k": 10.0}),  # every launch recorded
    ({"k": (10.0, 1)}, {"k": 10.0}),  # two of three dropped
    ({"a": (60.0, 6), "b": (5.0, 1)}, {"a": 20.0, "b": 5.0}),  # two launches a call
], ids=["all recorded", "two dropped", "two a call"])
def test_smoke_device_us_scales_by_the_recorded_launches(ev, want):
    """chip_smoke.py's device time per call over a window of three calls:
    a kernel's mean per recorded launch times its launches per call, so
    records the profiler drops do not lower it."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.per_call_us(ev, 3) == pytest.approx(want)


def test_new_modules_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quokka_tpu'] = None\n"
        "from quokka_tpu_torch import catalog, optimizer, logical, datastream, context\n"
        "from quokka_tpu_torch.ops import join, stagefuse, strategy\n"
        "assert 'triton' not in sys.modules, 'triton imported at module import'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("value", ["join_build=bogus", "nosuchop=sort", "join_build"])
def test_unknown_strategy_override_raises(value, monkeypatch):
    from quokka_tpu_torch.ops import strategy

    monkeypatch.setenv("QK_KERNEL_STRATEGY", value)
    with pytest.raises(strategy.StrategyError):
        strategy.choice("join_build")


def test_unported_join_paths_raise_naming_the_roadmap(monkeypatch):
    """Left and many-to-many joins run now (tests/test_torch_q4q13q19q7.py);
    what stays unported on the join path is the spill tier: a left join
    whose build passes SPILL_JOIN_BUILD_ROWS on a channel raises naming the
    roadmap item instead of truncating."""
    import pandas as pd
    from quokka_tpu_torch import QuokkaContext, config

    monkeypatch.setattr(config, "SPILL_JOIN_BUILD_ROWS", 300)
    ctx = QuokkaContext(io_channels=1, exec_channels=1, device="cpu")
    a = ctx.from_pandas(pd.DataFrame({"k": [1, 2], "v": [0.5, 1.5]}))
    b = ctx.from_pandas(pd.DataFrame({"k": list(range(400)) * 2, "w": [2.0] * 800}))
    with pytest.raises(NotImplementedError, match="The rest of the DataStream/SQL surface"):
        a.join(b, on="k", how="left").collect()


def test_join_build_past_the_spill_threshold_raises(monkeypatch):
    from quokka_tpu_torch import config
    from quokka_tpu_torch.executors.sql_execs import BuildProbeJoinExecutor
    from quokka_tpu_torch.ops import bridge
    import numpy as np

    monkeypatch.setattr(config, "SPILL_JOIN_BUILD_ROWS", 300)
    ex = BuildProbeJoinExecutor(["k"], ["k"])
    part = bridge.host_to_device(bridge.HostTable({"k": np.arange(200)}), "cpu")
    ex.execute([part], 1, 0)
    with pytest.raises(NotImplementedError, match="The rest of the DataStream/SQL surface"):
        ex.execute([part], 1, 0)


def test_stage_needing_fused_elementwise_raises(monkeypatch):
    """A filter the optimizer cannot push below a join stays inside the
    fused stage, which runs it through FusedElementwise (row 16, ported);
    the same stage under a forced groupby=sort (row 6 and the sort group-by,
    ported) gives the hashtable strategy's result."""
    import pandas as pd
    from quokka_tpu_torch import QuokkaContext, col
    from quokka_tpu_torch.ops import strategy

    ctx = QuokkaContext(device="cpu")
    a = ctx.from_pandas(pd.DataFrame({"k": [1, 2, 3], "v": [0.5, 1.5, 2.5]}))
    b = ctx.from_pandas(pd.DataFrame({"k": [1, 2], "w": [2.0, 1.0]}))
    q = a.join(b, on="k").filter(col("v") > col("w")).agg_sql("sum(v) as s")
    assert "FusedStage" in q.explain()
    assert q.collect().s[0] == 1.5

    def grouped():
        return a.join(b, on="k").filter(col("v") > col("w")).groupby("k").agg_sql(
            "sum(v) as s").collect().sort_values("k").reset_index(drop=True)

    hashed = grouped()
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "groupby=sort")
    strategy.reset_used()
    by_sort = grouped()
    assert strategy.used_snapshot()["groupby"] == "sort"
    pd.testing.assert_frame_equal(by_sort, hashed)


def _batch(device):
    from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol

    return DeviceBatch({"v": NumCol(torch.tensor([-1.5, 2.0], device=device), "f"),
                        "d": NumCol(torch.tensor([-400, 9000], dtype=torch.int32,
                                                 device=device), "d")},
                       torch.ones(2, dtype=torch.bool, device=device))


@pytest.mark.parametrize("expr", ["abs(v)", "d + interval '1' month"])
def test_stage_outside_k16_subset_raises_off_the_cpu(expr):
    """A fused-stage map the K16 generator does not take runs step by step
    on a CPU batch (the reference's per-step path) and raises on any other
    device, naming its ROADMAP item: the card never runs the plain version."""
    from quokka_tpu_torch import sqlparse
    from quokka_tpu_torch.ops import stagefuse

    stage = stagefuse.FusedElementwise([("map", [("u", sqlparse.parse_expression(expr))])])
    before = stagefuse.SEQUENTIAL
    assert stage(_batch("cpu")).columns["u"].data.shape == (2,)
    assert stagefuse.SEQUENTIAL == before + 1
    with pytest.raises(NotImplementedError, match="The rest of the DataStream/SQL surface"):
        stage(_batch("meta"))
    assert stagefuse.SEQUENTIAL == before + 1


def test_predicate_outside_k1_subset_raises_off_the_cpu():
    from quokka_tpu_torch import sqlparse
    from quokka_tpu_torch.ops import fuse

    pred = fuse.FusedPredicate(sqlparse.parse_expression("extract(year from d) = 1995"))
    before = fuse.FALLBACKS
    with pytest.raises(NotImplementedError, match="The rest of the DataStream/SQL surface"):
        pred(_batch("meta"))
    assert fuse.FALLBACKS == before


def test_new_kernel_wrappers_refuse_other_devices():
    from quokka_tpu_torch import sqlparse
    from quokka_tpu_torch.ops import fuse, hashtable, join
    from quokka_tpu_torch.ops.expr_compile import plan_aggregation

    meta = torch.zeros(4, device="meta")
    i32 = meta.to(torch.int32)
    with pytest.raises(RuntimeError, match="unsupported device"):
        hashtable.probe(i32, [i32], [i32], meta.bool(), 3)
    with pytest.raises(RuntimeError, match="unsupported device"):
        hashtable._build_insert((i32,), meta.bool(), 3)
    with pytest.raises(RuntimeError, match="unsupported device"):
        join.pk_probe_sorted([meta], i32, meta.long()[0], [meta], meta.bool())
    # K5 on the CUDA route refuses tensors that are not on the batch's device
    plan = plan_aggregation(sqlparse.parse_select_list("sum(a * 2) as s"))
    kern = fuse._PreAggKernel(dict(plan.pre), [plan.pre[0][0]], [("a", torch.float64)])
    cpu = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="does not match the batch"):
        fuse.pre_exprs_launch(kern, [cpu], torch.zeros(4, dtype=torch.bool, device="meta"),
                              [torch.float64])


def test_time_series_modules_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quokka_tpu'] = None\n"
        "from quokka_tpu_torch import windows\n"
        "from quokka_tpu_torch.ops import asof\n"
        "from quokka_tpu_torch.executors import ts_execs\n"
        "from quokka_tpu_torch.dataset import ordered\n"
        "from quokka_tpu_torch.datastream import OrderedStream\n"
        "assert 'triton' not in sys.modules, 'triton imported at module import'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_vector_tier_modules_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quokka_tpu'] = None\n"
        "from quokka_tpu_torch.ops import vector, linalg, tdigest\n"
        "from quokka_tpu_torch.executors import vector as ev, linalg as el\n"
        "from quokka_tpu_torch.dataset import vector as dv\n"
        "assert 'triton' not in sys.modules, 'triton imported at module import'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_vector_tier_kernels_refuse_other_devices():
    from quokka_tpu_torch.ops import linalg, vector

    meta = torch.zeros(4, device="meta")
    state = vector.empty_state(2, 3, "meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        vector.sims_topk(torch.zeros((2, 3), device="meta"), torch.zeros((4, 3), device="meta"),
                         meta.bool(), 3, *state, 0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        linalg.gramian([meta, meta], meta.bool())


def test_build_vector_index_defaults_to_cuda(tmp_path):
    """The index build is an entry point: without a card it raises unless
    the caller asks for the CPU."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    from quokka_tpu_torch.dataset.vector import build_vector_index, sidecar_path

    vecs = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    path = str(tmp_path / "v.parquet")
    pq.write_table(pa.table({"v": pa.FixedSizeListArray.from_arrays(
        pa.array(vecs.reshape(-1)), 4)}), path)
    if torch.cuda.is_available():
        build_vector_index(path, "v", n_cells=4)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_vector_index(path, "v", n_cells=4)
        build_vector_index(path, "v", n_cells=4, device="cpu")
    assert np.load(sidecar_path(path))["centroids"].shape == (4, 4)


def test_pack_and_obs_import_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quokka_tpu'] = None\n"
        "from quokka_tpu_torch.ops import pack\n"
        "from quokka_tpu_torch import obs\n"
        "from quokka_tpu_torch.obs import devprof, explain, metrics, opstats\n"
        "assert 'triton' not in sys.modules, 'triton imported at module import'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_wire_decode_refuses_other_devices():
    """K23's wrapper launches on CUDA tensors only; pack_put lands on the
    CPU (the plain decode) or CUDA, nowhere else."""
    import numpy as np
    from quokka_tpu_torch.ops import pack

    buf = torch.zeros(512, dtype=torch.uint8)
    staged = pack.Staged([("valid", 256)], buf, [buf[:4].view(torch.int32)],
                         [torch.zeros(256, dtype=torch.bool)], 256, 1, 256)
    with pytest.raises(RuntimeError, match="unsupported device"):
        pack.decode_launch(staged)
    with pytest.raises(RuntimeError, match="unsupported device"):
        pack.pack_put([pack.ValidCount(256, 3), np.zeros(256)], "meta")


def test_calibration_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """devprof.calibrate() measures the card; without one it raises rather
    than timing the CPU, which it does only when asked."""
    from quokka_tpu_torch.obs import devprof

    monkeypatch.setenv("QK_DEVPROF_DIR", "")
    devprof.reset()
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                devprof.calibrate()
            with pytest.raises(RuntimeError, match="cuda"):
                devprof.ensure_calibrated()
            assert devprof.peaks() is None
        prof = devprof.calibrate(device="cpu", force=True)
        assert prof["fingerprint"].startswith("cpu-") and prof["peak_flops_s"] > 0
    finally:
        devprof.reset()


def test_make_mesh_defaults_to_cuda_and_raises_without_it():
    """make_mesh() is an entry point: its shards lie on the card unless the
    caller asks for the CPU."""
    from quokka_tpu_torch import QuokkaContext
    from quokka_tpu_torch.parallel import make_mesh

    if torch.cuda.is_available():
        m = make_mesh()
        assert m.device.type == "cuda" and m.n_shards == 8
        assert QuokkaContext(mesh=m).device == m.device
        return
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    m = make_mesh(device="cpu")
    assert m.device.type == "cpu" and QuokkaContext(mesh=m).device.type == "cpu"
    with pytest.raises(ValueError, match="mesh lies on"):
        QuokkaContext(device="cpu:1", mesh=m)


def test_mesh_kernel_wrappers_refuse_other_devices():
    from quokka_tpu_torch.ops import join, kernels

    meta = torch.zeros(16, device="meta", dtype=torch.int32)
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.mesh_bucketize([meta], torch.zeros(16, device="meta", dtype=torch.bool),
                               (0,), 2)
    with pytest.raises(RuntimeError, match="unsupported device"):
        join.pk_match_ranks(meta.long(), torch.zeros(16, device="meta", dtype=torch.bool), 8)
