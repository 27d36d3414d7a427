"""The port's compacted shuffle (K17's plan, its windows and the split mode
choice) against the reference (quokka_tpu, JAX x64 on the CPU), on
numpy-seeded inputs handed to both packages.

The plan and the parts compare exactly, index for index: the permutation,
counts and offsets; each part's padded length, validity and row indices.
The forced ``shuffle=compacted`` queries compare keys exactly and floats to
rtol 1e-9 after a sort (summation order), against the reference and pandas.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import quokka_tpu
import quokka_tpu.optimizer as ref_optimizer
import quokka_tpu_torch
import quokka_tpu_torch.optimizer as port_optimizer
import tpch_data
from quokka_tpu import config as ref_config
from quokka_tpu.ops import bridge as ref_bridge
from quokka_tpu.ops import kernels as ref_kernels
from quokka_tpu_torch import config
from quokka_tpu_torch.ops import bridge, kernels, strategy

from test_torch_q3q5 import pandas_q3, pandas_q5, q3, q5, same_q3, same_q5
from torch_port_util import fresh_aot, port_batch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plan_inputs(n, n_parts, case, seed):
    r = np.random.default_rng(seed)
    if case == "empty_parts":  # only the first and the last part hold rows
        pids = np.where(r.random(n) < 0.5, 0, n_parts - 1).astype(np.int32)
    else:
        pids = r.integers(0, n_parts, n).astype(np.int32)
    valid = {"mixed": r.random(n) < 0.8, "empty_parts": r.random(n) < 0.9,
             "all_invalid": np.zeros(n, dtype=bool)}[case]
    return pids, valid


@pytest.mark.parametrize("case", ["mixed", "empty_parts", "all_invalid"])
@pytest.mark.parametrize("n_parts", [1, 2, 3, 7, 64])
def test_plan_matches_reference(n_parts, case):
    """K17's plain version against the reference's ``_partition_plan``:
    perm, counts and offsets exact."""
    pids, valid = _plan_inputs(5000, n_parts, case, seed=n_parts)
    r_perm, r_counts, r_offsets = ref_kernels._partition_plan(
        jnp.asarray(pids), jnp.asarray(valid), n_parts)
    perm, counts, offsets = kernels.partition_plan(torch.from_numpy(pids),
                                                   torch.from_numpy(valid), n_parts)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(r_perm))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(r_offsets))
    assert perm.dtype == counts.dtype == offsets.dtype == torch.int32


def _batch_pair(n, seed, invalid_frac=0.2, n_keys=50):
    r = np.random.default_rng(seed)
    table = pa.table({"k": r.integers(0, n_keys, n).astype(np.int64),
                      "t": np.arange(n, dtype=np.int64),
                      "v": r.normal(size=n)})
    ref_b = ref_bridge.arrow_to_device(table)
    if invalid_frac:
        keep = r.random(ref_b.padded_len) >= invalid_frac
        ref_b = ref_kernels.apply_mask(ref_b, jnp.asarray(keep))
    return ref_b, port_batch(ref_b)


def _same_parts(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.padded_len == e.padded_len
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(e.valid))
        np.testing.assert_array_equal(g.columns["t"].data.numpy(),
                                      np.asarray(e.columns["t"].data))
        assert g.count_valid() == e.count_valid()


@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("n_parts", [2, 3, 7])
def test_compacted_split_matches_reference(n_parts, skewed):
    """``split_by_partition(compact=True)`` parts against the reference's:
    padded length, validity and the row index of every slot (invalid slots
    included).  Uniform ids take one bucket; skewed ones over 7 parts take a
    bucket per part."""
    ref_b, b = _batch_pair(3000, seed=10 + n_parts)
    r = np.random.default_rng(n_parts)
    pids = (np.where(r.random(b.padded_len) < 0.9, 0, r.integers(0, n_parts, b.padded_len))
            if skewed else r.integers(0, n_parts, b.padded_len)).astype(np.int32)
    exp = ref_kernels.split_by_partition(ref_b, jnp.asarray(pids), n_parts, compact=True)
    got = kernels.split_by_partition(b, torch.from_numpy(pids), n_parts, compact=True)
    _same_parts(got, exp)
    if not skewed:
        assert len({p.padded_len for p in got}) == 1
    elif n_parts == 7:
        assert len({p.padded_len for p in got}) > 1


# -- tests/test_shuffle.py::TestMultiPartitionKernel, on the port --------------


def _rows(part):
    v = part.valid.numpy()
    return pd.DataFrame({k: c.data.numpy()[v] for k, c in part.columns.items()})


@pytest.mark.parametrize("n_parts", [2, 3, 4])
def test_masked_vs_compacted_equivalence(n_parts):
    """Both split modes deliver the same rows per partition, in source order."""
    _, b = _batch_pair(4000, seed=1)
    pids = kernels.partition_ids(b, ["k"], n_parts)
    masked = kernels.split_by_partition(b, pids, n_parts, compact=False)
    compacted = kernels.split_by_partition(b, pids, n_parts, compact=True)
    assert len(masked) == len(compacted) == n_parts
    total = 0
    for m, c in zip(masked, compacted):
        dm, dc = _rows(m), _rows(c)
        pd.testing.assert_frame_equal(dm.reset_index(drop=True), dc.reset_index(drop=True))
        total += len(dm)
    assert total == b.count_valid()


def test_empty_partitions():
    n = 3000
    b = bridge.host_to_device(bridge.HostTable({"k": np.zeros(n, dtype=np.int64),
                                                "v": np.arange(n, dtype=np.float64)}), "cpu")
    pids = kernels.partition_ids(b, ["k"], 4)
    for compact in (False, True):
        parts = kernels.split_by_partition(b, pids, 4, compact=compact)
        counts = [p.count_valid() for p in parts]
        assert sorted(counts)[:3] == [0, 0, 0]
        assert sum(counts) == n


def test_all_invalid_batch():
    _, b = _batch_pair(2000, seed=3, invalid_frac=1.0)
    assert b.count_valid() == 0
    pids = kernels.partition_ids(b, ["k"], 3)
    for compact in (False, True):
        parts = kernels.split_by_partition(b, pids, 3, compact=compact)
        assert [p.count_valid() for p in parts] == [0, 0, 0]
        for p in parts:
            assert len(_rows(p)) == 0


def test_n_parts_1_fast_path():
    _, b = _batch_pair(1000, seed=4)
    pids = kernels.partition_ids(b, ["k"], 1)
    for compact in (False, True):
        parts = kernels.split_by_partition(b, pids, 1, compact=compact)
        assert len(parts) == 1 and parts[0] is b


def test_compacted_uniform_buckets():
    _, b = _batch_pair(5000, seed=5, invalid_frac=0.0, n_keys=1024)
    pids = kernels.partition_ids(b, ["k"], 4)
    parts = kernels.split_by_partition(b, pids, 4, compact=True)
    assert len({p.padded_len for p in parts}) == 1


def test_masked_split_zero_host_syncs_and_compacted_one():
    """A masked split reads nothing back; a compacted split reads its counts
    once."""
    _, b = _batch_pair(3000, seed=6)
    pids = kernels.partition_ids(b, ["k"], 4)
    before = kernels.SHUFFLE_HOST_SYNCS
    kernels.split_by_partition(b, pids, 4, compact=False)
    assert kernels.SHUFFLE_HOST_SYNCS == before
    kernels.split_by_partition(b, pids, 4, compact=True)
    assert kernels.SHUFFLE_HOST_SYNCS == before + 1


def test_masked_counts_noted_async():
    _, b = _batch_pair(3000, seed=7)
    pids = kernels.partition_ids(b, ["k"], 2)
    for p in kernels.split_by_partition(b, pids, 2, compact=False):
        assert p.nrows is None and p.nrows_dev is not None
    for p in kernels.split_by_partition(b, pids, 2, compact=True):
        assert isinstance(p.nrows, int)


def test_order_preserved_within_partition():
    n = 4000
    b = bridge.host_to_device(bridge.HostTable({"k": (np.arange(n) % 3).astype(np.int64),
                                                "t": np.arange(n, dtype=np.int64)}), "cpu")
    pids = kernels.partition_ids(b, ["k"], 3)
    for compact in (False, True):
        for p in kernels.split_by_partition(b, pids, 3, compact=compact):
            t = _rows(p)["t"].to_numpy()
            assert (np.diff(t) > 0).all()


# -- the mode choice -------------------------------------------------------------


def test_auto_switch_under_lowered_cap(monkeypatch):
    """Past 2^16 padded rows, a split whose n_parts * padded_len passes
    SHUFFLE_MASKED_CAP takes the compacted mode, as in the reference, and
    gives the reference's parts; under the default cap it stays masked."""
    ref_b, b = _batch_pair(70_000, seed=8, invalid_frac=0.1)
    assert b.padded_len == 1 << 17
    pids = kernels.partition_ids(b, ["k"], 2)
    strategy.reset_used()
    before = kernels.SHUFFLE_HOST_SYNCS
    kernels.split_by_partition(b, pids, 2)
    assert kernels.SHUFFLE_HOST_SYNCS == before
    assert strategy.used_snapshot()["shuffle"] == "masked"
    monkeypatch.setattr(config, "SHUFFLE_MASKED_CAP", 1 << 17)
    monkeypatch.setattr(ref_config, "SHUFFLE_MASKED_CAP", 1 << 17)
    strategy.reset_used()
    got = kernels.split_by_partition(b, pids, 2)
    assert kernels.SHUFFLE_HOST_SYNCS == before + 1
    assert strategy.used_snapshot()["shuffle"] == "compacted"
    _same_parts(got, ref_kernels.split_by_partition(
        ref_b, jnp.asarray(pids.numpy()), 2))
    # hash_split (the engine's exchange) takes the same choice
    _same_parts(kernels.hash_split(b, ["k"], 2), ref_kernels.split_by_partition(
        ref_b, ref_kernels.partition_ids(ref_b, ["k"], 2), 2))


def test_forced_compacted_needs_more_than_2_16_rows(monkeypatch):
    """Forced shuffle=compacted compacts past 2^16 padded rows only (below,
    the counts readback costs more than it saves), as in the reference."""
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "shuffle=compacted")
    _, small = _batch_pair(3000, seed=9)
    big_ref, big = _batch_pair(70_000, seed=9)
    assert not kernels.compact_choice(small, 2)
    assert kernels.compact_choice(big, 2)
    before = kernels.SHUFFLE_HOST_SYNCS
    _same_parts(kernels.hash_split(big, ["k"], 3), ref_kernels.split_by_partition(
        big_ref, ref_kernels.partition_ids(big_ref, ["k"], 3), 3))
    assert kernels.SHUFFLE_HOST_SYNCS == before + 1


def test_masked_cap_env_read_at_import():
    env = dict(os.environ, QUOKKA_SHUFFLE_MASKED_CAP="1048576")
    out = subprocess.run([sys.executable, "-c", "from quokka_tpu_torch import config; "
                          "print(config.SHUFFLE_MASKED_CAP)"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1048576"


# -- forced shuffle=compacted end to end ---------------------------------------------


@pytest.fixture(scope="module")
def big_env(tmp_path_factory):
    """TPC-H at SF 0.012 in 2^17-row row groups: lineitem's batch pads to
    2^17 rows, past the compacted mode's 2^16."""
    tables = tpch_data.generate(sf=0.012, seed=11)
    root = tmp_path_factory.mktemp("tpch_compacted")
    paths = tpch_data.write_parquet_dir(tables, str(root), row_group_size=1 << 17)
    return paths, {k: t.to_pandas() for k, t in tables.items()}


@pytest.mark.parametrize("query", ["q3", "q5"])
def test_forced_compacted_queries_match_reference(big_env, query, monkeypatch, fresh_aot):
    """Q3 and Q5 with hash-partitioned joins under shuffle=compacted: the
    port compacts its lineitem exchanges (one counts read each) and equals
    the reference and pandas."""
    paths, dfs = big_env
    build, oracle, same = {"q3": (q3, pandas_q3, same_q3),
                           "q5": (q5, pandas_q5, same_q5)}[query]
    monkeypatch.setenv("QK_KERNEL_STRATEGY", "shuffle=compacted")
    monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", 100)
    monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", 100)
    calls = []
    real = kernels.compacted_parts
    monkeypatch.setattr(kernels, "compacted_parts",
                        lambda *a, **kw: calls.append(a[0].padded_len) or real(*a, **kw))
    strategy.reset_used()
    before = kernels.SHUFFLE_HOST_SYNCS
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = build(quokka_tpu_torch, ctx, paths).collect()
    assert calls and min(calls) > 1 << 16
    assert kernels.SHUFFLE_HOST_SYNCS - before == len(calls)
    assert "compacted" in strategy.used_snapshot()["shuffle"]
    ref = build(quokka_tpu, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2),
                paths).collect()
    same(got, oracle(dfs))
    same(got, ref)
