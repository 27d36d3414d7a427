"""Helpers for the PyTorch-port tests (tests/test_torch_*.py): carry a
reference (quokka_tpu, JAX) batch across to the port, and small data makers.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU, where every kernel takes its plain torch version.
"""

import atexit
import os
import shutil
import tempfile

import numpy as np
import pyarrow as pa
import pytest


def _private_aot_store() -> None:
    """Give this test process an AOT executable store of its own.

    The reference's compile plane persists every program it compiles to a
    store that all processes of a run share (under QUOKKA_JAX_CACHE_DIR).
    With the suite's 8 forced CPU devices, a single-device executable that
    one process wrote loads back in another as an 8-shard one and fails
    with "Expected args to execute_sharded_on_local_devices to have 8
    shards", so which reference tests pass depended on which pytest-xdist
    worker compiled a program first. Every worker collects this module
    before any test runs, so setting the store here covers the whole run;
    each process still writes, reloads and prewarms from its own store.
    An explicit QUOKKA_AOT_CACHE_DIR is left as it is."""
    if os.environ.get("QUOKKA_AOT_CACHE_DIR"):
        return
    d = tempfile.mkdtemp(prefix="qk-test-aot-")
    atexit.register(shutil.rmtree, d, True)
    os.environ["QUOKKA_AOT_CACHE_DIR"] = d


_private_aot_store()


@pytest.fixture
def fresh_aot(tmp_path, monkeypatch):
    """A fresh AOT executable store for the reference's compile plane: a
    store persisted by a run with another device count fails to load."""
    monkeypatch.setenv("QUOKKA_AOT_CACHE_DIR", str(tmp_path / "aot"))
    return tmp_path


def port_batch(ref_batch):
    """The port's DeviceBatch (CPU) holding a reference DeviceBatch's
    arrays, read back with np.asarray (vector columns included)."""
    from quokka_tpu.ops.batch import StrCol as RefStrCol
    from quokka_tpu.ops.batch import VecCol as RefVecCol
    from quokka_tpu_torch.ops import bridge

    cols, dicts, kinds = {}, {}, {}
    for name, c in ref_batch.columns.items():
        if isinstance(c, RefStrCol):
            cols[name] = np.asarray(c.codes)
            dicts[name] = c.dictionary.values
        elif isinstance(c, RefVecCol):
            cols[name] = np.asarray(c.data)  # [padded, dim]: the port's VecCol
        else:
            assert c.hi is None, "x64 reference batches carry no wide limbs"
            cols[name] = np.asarray(c.data)
            kinds[name] = c.kind
    return bridge.batch_from_numpy(cols, np.asarray(ref_batch.valid), dicts, kinds)


def mixed_table(n: int, seed: int, nulls: bool = True) -> pa.Table:
    """Strings, ints, floats (NaN, -0.0), dates and bools, with nulls."""
    r = np.random.default_rng(seed)

    def maybe_null(values):
        if not nulls:
            return values
        m = r.random(n) < 0.08
        return [None if k else v for v, k in zip(values.tolist(), m)]

    f = r.normal(size=n).round(3)
    f[r.random(n) < 0.05] = -0.0
    f[r.random(n) < 0.05] = np.nan
    return pa.table({
        "s": pa.array(maybe_null(np.array(["ab", "cd", "ef", "gh"], dtype=object)[
            r.integers(0, 4, n)]), type=pa.string()),
        "t": pa.array(np.array(["x", "y"], dtype=object)[r.integers(0, 2, n)],
                      type=pa.string()),
        "i": pa.array(maybe_null(r.integers(-50, 50, n)), type=pa.int64()),
        "f": pa.array(f, type=pa.float64()),
        "g": pa.array(maybe_null(r.uniform(0, 10, n).round(2)), type=pa.float64()),
        "d": pa.array(maybe_null(r.integers(9000, 10500, n).astype(np.int32)),
                      type=pa.int32()).cast(pa.date32()),
        "b": pa.array(r.random(n) < 0.5, type=pa.bool_()),
    })


def ref_batch_of(table):
    from quokka_tpu.ops import bridge as ref_bridge

    return ref_bridge.arrow_to_device(table)
