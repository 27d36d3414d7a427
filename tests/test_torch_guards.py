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


def test_unported_join_paths_raise_naming_the_roadmap():
    from quokka_tpu_torch import QuokkaContext
    from quokka_tpu_torch.ops import join

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        join.hash_join_general(None, None, ["k"], ["k"])
    ctx = QuokkaContext(device="cpu")
    a = ctx.from_pandas(__import__("pandas").DataFrame({"k": [1, 2], "v": [0.5, 1.5]}))
    b = ctx.from_pandas(__import__("pandas").DataFrame({"k": [1], "w": [2.0]}))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        a.join(b, on="k", how="left")


def test_join_build_past_the_spill_threshold_raises(monkeypatch):
    from quokka_tpu_torch import config
    from quokka_tpu_torch.executors.sql_execs import BuildProbeJoinExecutor
    from quokka_tpu_torch.ops import bridge
    import numpy as np

    monkeypatch.setattr(config, "SPILL_JOIN_BUILD_ROWS", 300)
    ex = BuildProbeJoinExecutor(["k"], ["k"])
    part = bridge.host_to_device(bridge.HostTable({"k": np.arange(200)}), "cpu")
    ex.execute([part], 1, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        ex.execute([part], 1, 0)


def test_stage_needing_fused_elementwise_raises():
    """A filter the optimizer cannot push below a join stays inside the
    fused stage, which would need FusedElementwise (row 16)."""
    import pandas as pd
    from quokka_tpu_torch import QuokkaContext, col

    ctx = QuokkaContext(device="cpu")
    a = ctx.from_pandas(pd.DataFrame({"k": [1, 2, 3], "v": [0.5, 1.5, 2.5]}))
    b = ctx.from_pandas(pd.DataFrame({"k": [1, 2], "w": [2.0, 1.0]}))
    q = a.join(b, on="k").filter(col("v") > col("w")).agg_sql("sum(v) as s")
    with pytest.raises(NotImplementedError, match="row 16"):
        q.collect()


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
