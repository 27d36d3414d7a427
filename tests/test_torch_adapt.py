"""The port's adaptive exchange (planner/adapt.py, planner/decide.py, the
engine's skew trigger and K26's routing) against the reference (quokka_tpu,
JAX x64 on the CPU), on numpy-seeded inputs handed to both packages.

K26's plain version equals the reference's ``_salt_pids`` and
``_replicate_masks`` bit for bit; the trigger predicate and the
eligibility pass agree with the reference's; the skew join's results are
exact integers, equal across the adaptive run, the static run and the
reference.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import quokka_tpu
import quokka_tpu.optimizer as ref_optimizer
import quokka_tpu_torch
import quokka_tpu_torch.optimizer as port_optimizer
from quokka_tpu.ops import kernels as ref_kernels
from quokka_tpu.planner import adapt as ref_adapt
from quokka_tpu_torch.ops import kernels
from quokka_tpu_torch.planner import adapt, decide
from quokka_tpu_torch.runtime import engine, scancache
from quokka_tpu_torch.target_info import HashPartitioner

from torch_port_util import fresh_aot  # noqa: F401


@pytest.fixture(autouse=True)
def cold_scans():
    """Every query here lands its batches anew (K26 and the bridge run)."""
    scancache.clear()
    yield
    scancache.clear()


def _pids(n, n_parts, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, n_parts, n).astype(np.int32), r.random(n) < 0.8


@pytest.mark.parametrize("n_parts", [2, 3, 7, 64])
def test_k26_plain_matches_reference(n_parts):
    """Salted ids, replicate masks and their counts, bit for bit, from given
    ids and from hashed key limbs."""
    pids, valid = _pids(5000, n_parts, seed=n_parts)
    fat = n_parts // 2
    tp, tv = torch.from_numpy(pids), torch.from_numpy(valid)
    exp_salt = np.asarray(ref_adapt._salt_pids(jnp.asarray(pids), fat, n_parts))
    np.testing.assert_array_equal(adapt.salt_pids(tp, fat, n_parts).numpy(), exp_salt)
    r_masks, r_counts = ref_adapt._replicate_masks(jnp.asarray(pids), jnp.asarray(valid),
                                                   fat, n_parts)
    _, masks, counts = kernels.adapt_split([], tp, tv, n_parts, fat, "replicate")
    np.testing.assert_array_equal(masks.numpy(), np.stack([np.asarray(m) for m in r_masks]))
    np.testing.assert_array_equal(counts.numpy(), np.array([int(c) for c in r_counts]))
    # salt mode's masks are the plain split of the salted ids
    salted, s_masks, s_counts = kernels.adapt_split([], tp, tv, n_parts, fat, "salt")
    np.testing.assert_array_equal(salted.numpy(), exp_salt)
    r_split, r_split_counts = ref_kernels._split_masks(jnp.asarray(exp_salt),
                                                       jnp.asarray(valid), n_parts)
    np.testing.assert_array_equal(s_masks.numpy(), np.stack([np.asarray(m) for m in r_split]))
    np.testing.assert_array_equal(s_counts.numpy(), np.array([int(c) for c in r_split_counts]))
    # hashed limbs: the reference's partition ids, then the same routing
    r = np.random.default_rng(n_parts + 100)
    limbs = [r.integers(-2**40, 2**40, 5000).astype(np.int64), r.normal(size=5000) * 1e3]
    r_ids = ref_kernels._partition_ids(tuple(jnp.asarray(l) for l in limbs), n_parts)
    got, _, _ = kernels.adapt_split([torch.from_numpy(l) for l in limbs], None, tv, n_parts,
                                    fat, "salt")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_adapt._salt_pids(r_ids, fat, n_parts)))


def test_replicate_parts_are_masked_views():
    from quokka_tpu_torch.ops import bridge

    b = bridge.host_to_device(bridge.HostTable({"k": np.arange(1000, dtype=np.int64)}), "cpu")
    pids = kernels.partition_ids(b, ["k"], 3)
    parts = adapt.replicate_parts(b, pids, 1, 3)
    assert [p.count_valid() for p in parts] == [
        int((((pids == c) | (pids == 1)) & b.valid).sum()) for c in range(3)]
    assert all(p.columns["k"].data is b.columns["k"].data for p in parts)


HISTS = [({}, 2), ({0: 30000, 1: 10}, 2), ({0: 30000}, 2), ({0: 40000, 1: 30000}, 2),
         ({0: 100, 1: 50}, 2), ({2: 50000}, 4), ({0: 20000, 1: 20000, 2: 1}, 3),
         ({0: 40000, 1: 1}, 1), ({1: 25000, 0: 24000}, 2)]


@pytest.mark.parametrize("ratio", [1.5, 2.0])
@pytest.mark.parametrize("hist,n", HISTS)
def test_skewed_channel_matches_reference(hist, n, ratio):
    assert adapt.skewed_channel(hist, n, ratio) == ref_adapt.skewed_channel(hist, n, ratio)


def test_skewed_channel_min_rows(monkeypatch):
    monkeypatch.setenv("QK_ADAPT_MIN_ROWS", "100")
    assert adapt.skewed_channel({0: 90, 1: 11}, 2, 1.5) == 0
    assert ref_adapt.skewed_channel({0: 90, 1: 11}, 2, 1.5) == 0
    assert adapt.skewed_channel({0: 80, 1: 10}, 2, 1.5) is None
    assert adapt.build_records(1, {0: 3, 1: 2}) == ref_adapt.build_records(1, {0: 3, 1: 2})


# -- eligibility (tests/test_planner.py::TestQK026, on the port) --------------------


@pytest.fixture(scope="module")
def pq_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapt_planner")
    r = np.random.default_rng(7)
    n = 20_000
    fp, dp = str(root / "fact.parquet"), str(root / "dim.parquet")
    pq.write_table(pa.table({"fk": r.integers(0, 100, n).astype(np.int64),
                             "x": r.integers(0, 1000, n).astype(np.int64)}), fp,
                   row_group_size=2048)
    pq.write_table(pa.table({"pk": np.arange(100, dtype=np.int64),
                             "w": np.arange(100, dtype=np.int64) * 10}), dp)
    return fp, dp


def _optimized_joins(pkg, pq_env, how="inner"):
    fp, dp = pq_env
    ctx = (pkg.QuokkaContext(device="cpu") if pkg is quokka_tpu_torch
           else pkg.QuokkaContext())
    q = ctx.read_parquet(fp).join(ctx.read_parquet(dp), left_on="fk", right_on="pk",
                                  how=how)
    sub, sid = ctx._prepare_plan(q.node_id)
    joins = []
    for node in sub.values():
        members = getattr(node, "members", [node])
        joins += [m for m in members if type(m).__name__ == "JoinNode"]
    return sub, sid, joins


@pytest.mark.parametrize("how", ["inner", "left", "semi"])
def test_eligibility_matches_reference(pq_env, how, monkeypatch, fresh_aot):
    """Under a zero broadcast threshold, the inner hash join is armed and
    the left and semi joins are not, in both packages."""
    monkeypatch.setenv("QK_BROADCAST_BYTES", "1")
    monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", 0)
    monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", 0)
    _, _, port = _optimized_joins(quokka_tpu_torch, pq_env, how)
    _, _, ref = _optimized_joins(quokka_tpu, pq_env, how)
    assert [j.adapt_salt for j in port] == [getattr(j, "adapt_salt", False) for j in ref]
    assert [j.adapt_salt for j in port] == [how == "inner"]


def _armed(pq_env, monkeypatch):
    monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", 0)
    sub, sid, joins = _optimized_joins(quokka_tpu_torch, pq_env)
    assert joins[0].adapt_salt
    joins[0].adapt_salt = False
    return sub, sid, joins[0]


@pytest.mark.parametrize("change", ["left", "broadcast", "ordered", "salt_column"])
def test_ineligible_joins_are_not_armed(pq_env, change, monkeypatch):
    sub, sid, join = _armed(pq_env, monkeypatch)
    if change == "left":
        join.how = "left"
    elif change == "broadcast":
        join.broadcast = True
    elif change == "ordered":
        join.sorted_by = ["fk"]
    else:
        join.schema = list(join.schema) + [decide.SALT_COLUMN]
    decide.plan_adaptive_exchanges(sub, sid)
    assert not join.adapt_salt


def test_adapt_off_never_arms(pq_env, monkeypatch):
    monkeypatch.setenv("QK_ADAPT", "0")
    monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", 0)
    _, _, joins = _optimized_joins(quokka_tpu_torch, pq_env)
    assert joins and not any(j.adapt_salt for j in joins)


def test_default_threshold_broadcasts_and_never_arms(pq_env):
    """At the default threshold the 100-row build is broadcast: no edge."""
    _, _, joins = _optimized_joins(quokka_tpu_torch, pq_env)
    assert joins and all(j.broadcast and not j.adapt_salt for j in joins)


# -- the skew join (bench.py's skewjoin at a CPU size) ------------------------------

SKEW_BUILD_ROWS = 20_000
SKEW_KEYS = 200
SKEW_BATCH = 1024


@pytest.fixture(scope="module")
def skew_env(tmp_path_factory):
    r = np.random.default_rng(20260807)
    keys = r.integers(1, SKEW_KEYS, SKEW_BUILD_ROWS).astype(np.int64)
    keys[r.random(SKEW_BUILD_ROWS) < 0.9] = 0
    build = pa.table({"k": keys,
                      "v": r.integers(0, 1000, SKEW_BUILD_ROWS).astype(np.int64)})
    probe = pa.table({"pk": np.arange(SKEW_KEYS, dtype=np.int64),
                      "g": np.arange(SKEW_KEYS, dtype=np.int64) % 50})
    root = tmp_path_factory.mktemp("skewjoin")
    paths = {"probe": str(root / "probe.parquet"), "build": str(root / "build.parquet")}
    pq.write_table(probe, paths["probe"])
    pq.write_table(build, paths["build"], row_group_size=SKEW_BATCH)
    m = probe.to_pandas().merge(build.to_pandas(), left_on="pk", right_on="k")
    exp = m.groupby("g").agg(sv=("v", "sum"), n=("v", "size")).reset_index()
    return paths, exp


def skewjoin(pkg, ctx, paths):
    """bench.py's build_skewjoin."""
    probe = ctx.read_parquet(paths["probe"])
    build = ctx.read_parquet(paths["build"])
    return (probe.join(build, left_on="pk", right_on="k")
            .groupby("g").agg_sql("sum(v) as sv, count(*) as n"))


def _sorted(df):
    return df[["g", "sv", "n"]].sort_values("g").reset_index(drop=True).astype("int64")


def _run_port(paths, monkeypatch):
    """The skew join on the port, with the rows each build channel received
    counted at the batch cache; (result, ADT records, rows per channel)."""
    rows = {}
    real_put = engine.BatchCache.put

    def put(self, name, batch):
        src, _sch, _seq, tgt, _, tch = name
        rows[(src, tgt, tch)] = rows.get((src, tgt, tch), 0) + batch.count_valid()
        return real_put(self, name, batch)

    monkeypatch.setattr(engine.BatchCache, "put", put)
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = skewjoin(quokka_tpu_torch, ctx, paths).collect()
    g = ctx.latest_graph
    return got, dict(g.store.titems("ADT")), rows, g


@pytest.fixture
def skew_knobs(monkeypatch):
    monkeypatch.setenv("QK_SKEW_RATIO", "1.5")
    monkeypatch.setenv("QK_ADAPT_MIN_ROWS", "4000")
    monkeypatch.setattr(ref_optimizer, "BROADCAST_THRESHOLD", 1000)
    monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", 1000)


def test_skewjoin_adaptive_fires_and_matches(skew_env, skew_knobs, monkeypatch, fresh_aot):
    """The trigger fires once: a salt record on the build edge (the fat
    channel, from the next sequence of each build channel) and a replicate
    record on the probe edge; after it, no channel holds more than the
    trigger's ratio of the mean; the result equals pandas and the
    reference's exactly."""
    paths, exp = skew_env
    got, adt, rows, g = _run_port(paths, monkeypatch)
    assert len(adt) == 2
    modes = sorted(rec["mode"] for rec in adt.values())
    assert modes == ["replicate", "salt"]
    (build_edge, salt), = [(e, r) for e, r in adt.items() if r["mode"] == "salt"]
    (probe_edge, rep), = [(e, r) for e, r in adt.items() if r["mode"] == "replicate"]
    assert salt["fat"] == rep["fat"] and build_edge[1] == probe_edge[1]
    assert g.adapt_edges[build_edge]["probe_src"] == probe_edge[0]
    assert sum(salt["from_seq"].values()) > 0  # some batches shipped before it fired
    build_rows = [rows.get((build_edge[0], build_edge[1], ch), 0) for ch in range(2)]
    assert sum(build_rows) == SKEW_BUILD_ROWS
    assert max(build_rows) / (sum(build_rows) / 2) < 1.5
    pd.testing.assert_frame_equal(_sorted(got), _sorted(exp))
    ref = skewjoin(quokka_tpu, quokka_tpu.QuokkaContext(io_channels=2, exec_channels=2),
                   paths).collect()
    pd.testing.assert_frame_equal(_sorted(got), _sorted(ref))


def test_skewjoin_static_does_not_fire(skew_env, skew_knobs, monkeypatch):
    """QK_ADAPT=0: no edge armed, no record, the fat channel keeps the skew;
    the same result."""
    paths, exp = skew_env
    monkeypatch.setenv("QK_ADAPT", "0")
    got, adt, rows, g = _run_port(paths, monkeypatch)
    assert adt == {} and g.adapt_edges == {}
    per_channel = {}
    for (src, tgt, ch), n in rows.items():
        per_channel.setdefault((src, tgt), [0, 0])[ch] += n
    build = [v for v in per_channel.values() if sum(v) == SKEW_BUILD_ROWS]
    assert build and max(build[0]) / (SKEW_BUILD_ROWS / 2) >= 1.5
    pd.testing.assert_frame_equal(_sorted(got), _sorted(exp))


def test_too_late_guard_disarms(skew_env, skew_knobs, monkeypatch):
    """A probe batch that already shipped under plain hashing makes the
    trigger disarm the edge instead of replicating (exactly-once)."""
    paths, exp = skew_env
    real = engine.Engine._adapt_consider

    def consider(self, edge, src_channels, n_tgt):
        probe = self.g.adapt_edges[edge]["probe_src"]
        self._push_seqs[(probe, 0)] = 0  # as if the probe side had pushed
        return real(self, edge, src_channels, n_tgt)

    monkeypatch.setattr(engine.Engine, "_adapt_consider", consider)
    got, adt, _rows, g = _run_port(paths, monkeypatch)
    assert adt == {} and g.adapt_edges == {}
    pd.testing.assert_frame_equal(_sorted(got), _sorted(exp))


def test_engine_arms_the_fused_stage_edge(skew_env, skew_knobs):
    """The skew join fuses as join -> partial agg: the eligible edge is the
    build source's edge into the fused stage actor."""
    paths, _ = skew_env
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    q = skewjoin(quokka_tpu_torch, ctx, paths)
    assert "FusedStage" in q.explain()
    q.collect()
    g = ctx.latest_graph
    ((src, tgt), rec), = g.adapt_edges.items()
    assert g.actors[src].kind == "input" and g.actors[rec["probe_src"]].kind == "input"
    assert "FusedStageExecutor" in repr(g.actors[tgt].executor_factory)
    assert isinstance(g.store.tget("PFT", (src, tgt)).partitioner, HashPartitioner)


def test_tpch_partitioned_joins_arm_but_do_not_fire(monkeypatch, tmp_path):
    """Default-on adaptation changes nothing where it does not fire: Q3
    with hash-partitioned joins at SF 0.003 arms its inner join's build
    edge, never reaches the trigger (fewer than QK_ADAPT_MIN_ROWS rows, and
    no channel at twice the mean), and launches no K26."""
    import tpch_data
    from test_torch_q3q5 import pandas_q3, q3, same_q3

    tables = tpch_data.generate(sf=0.003, seed=7)
    paths = tpch_data.write_parquet_dir(tables, str(tmp_path))
    monkeypatch.setattr(port_optimizer, "BROADCAST_THRESHOLD", 100)
    calls = []
    real = kernels.adapt_split
    monkeypatch.setattr(kernels, "adapt_split", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ctx = quokka_tpu_torch.QuokkaContext(io_channels=2, exec_channels=2, device="cpu")
    got = q3(quokka_tpu_torch, ctx, paths).collect()
    g = ctx.latest_graph
    assert g.adapt_edges, "the hash-partitioned inner join should be armed"
    assert g.store.titems("ADT") == [] and not calls
    same_q3(got, pandas_q3({k: t.to_pandas() for k, t in tables.items()}))
