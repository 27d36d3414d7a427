"""The port's PK join (K11 hash build + probe, K12 sorted probe, and
``hash_join_pk`` / ``build_keys_unique`` around them) against the reference
(quokka_tpu, JAX x64 on the CPU), on identical inputs made from a numpy
seed.  The port runs each kernel's plain torch version here (the tensors
lie on the CPU); tests/test_torch_cuda.py holds the kernels against those
plain versions on a card.

Tolerances: masks, build indices, keys and counts exact; payload values
exact (a gather moves them unchanged).
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from quokka_tpu.ops import hashtable as ref_hashtable
from quokka_tpu.ops import join as ref_join
from quokka_tpu_torch.ops import hashtable, join, strategy
from quokka_tpu_torch.ops.batch import StrCol

from torch_port_util import fresh_aot, port_batch, ref_batch_of  # noqa: F401

KEY_KINDS = ["int64", "composite", "date", "float64"]


def _key_columns(kind, n, r):
    """n unique build keys of one kind, as {column: pyarrow array}."""
    if kind == "int64":
        return {"k": pa.array(r.permutation(n * 3)[:n].astype(np.int64) * 7 - 50)}
    if kind == "composite":
        flat = r.permutation(n * 10)[:n]
        names = np.array(["ab", "cd", "ef", "gh", "ij"], dtype=object)
        return {"k": pa.array((flat // 5).astype(np.int64)),
                "k2": pa.array(names[flat % 5].tolist(), type=pa.string())}
    if kind == "date":
        days = r.permutation(np.arange(9000, 9000 + n * 3))[:n].astype(np.int32)
        return {"k": pa.array(days, type=pa.int32()).cast(pa.date32())}
    vals = r.permutation(np.arange(-n, 2 * n))[:n].astype(np.float64) / 4
    vals[vals == 0.0] = -0.0  # a build -0.0 must match a probe +0.0
    return {"k": pa.array(vals)}


def _tables(kind, seed, n_build=300, n_probe=2000, nulls=True, empty_build=False):
    """A unique-key build table with payload and a probe table whose keys
    are drawn from the build keys, unmatched keys and nulls."""
    r = np.random.default_rng(seed)
    bk = _key_columns(kind, n_build, r)
    build = dict(bk)
    keys = list(bk)
    build["pay_f"] = pa.array(r.normal(size=n_build))
    build["pay_s"] = pa.array(np.array(["x", "y", "z"], dtype=object)[
        r.integers(0, 3, n_build)].tolist(), type=pa.string())
    if nulls:
        m = r.random(n_build) < 0.05
        build[keys[0]] = pa.array([None if x else v for v, x in
                                   zip(build[keys[0]].to_pylist(), m)], type=build[keys[0]].type)
    other = _key_columns(kind, n_build, np.random.default_rng(seed + 100))
    pick = r.integers(0, n_build, n_probe)
    from_build = r.random(n_probe) < 0.7
    probe = {}
    for k in keys:
        bv = np.array(bk[k].to_pylist(), dtype=object)
        ov = np.array(other[k].to_pylist(), dtype=object)
        v = np.where(from_build, bv[pick], ov[pick])
        if kind == "float64" and k == "k":
            v = np.where(v == 0.0, 0.0, v)  # +0.0 probes
        if nulls and k == keys[0]:
            v[r.random(n_probe) < 0.05] = None
        probe["p" + k] = pa.array(v.tolist(), type=bk[k].type)
    probe["val"] = pa.array(r.integers(0, 1000, n_probe))
    bt = pa.table(build)
    if empty_build:
        bt = bt.slice(0, 0)
    return bt, pa.table(probe), keys


def _run_both(bt, pt, keys, how, monkeypatch, join_build):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"join_build={join_build}")
    rb, rp = ref_batch_of(bt), ref_batch_of(pt)
    b, p = port_batch(rb), port_batch(rp)
    pkeys = ["p" + k for k in keys]
    payload = ["pay_f", "pay_s"]
    ref = ref_join.hash_join_pk(rp, rb, pkeys, keys, how, payload)
    strategy.reset_used()
    got = join.hash_join_pk(p, b, pkeys, keys, how, payload)
    assert strategy.used_snapshot()["join_build"] == join_build
    return ref, got


def _values(col, valid):
    if isinstance(col, StrCol):
        codes = col.codes.numpy()[valid]
        return [col.dictionary.values[c] if c >= 0 else None for c in codes]
    return col.data.numpy()[valid]


def _ref_values(col, valid):
    from quokka_tpu.ops.batch import StrCol as RefStrCol

    if isinstance(col, RefStrCol):
        codes = np.asarray(col.codes)[valid]
        return [col.dictionary.values[c] if c >= 0 else None for c in codes]
    return np.asarray(col.data)[valid]


def _same(ref, got):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert got.count_valid() == ref.count_valid()
    assert set(got.columns) == set(ref.columns)
    for name in ref.columns:
        a, b = _values(got.columns[name], valid), _ref_values(ref.columns[name], valid)
        if isinstance(b, list):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("join_build", ["hashtable", "sort"])
@pytest.mark.parametrize("how", ["inner", "semi", "anti"])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_hash_join_pk_matches_reference(kind, how, join_build, monkeypatch, fresh_aot):
    bt, pt, keys = _tables(kind, seed=len(kind) * 3 + len(how))
    ref, got = _run_both(bt, pt, keys, how, monkeypatch, join_build)
    assert 0 < got.count_valid() < pt.num_rows
    _same(ref, got)


@pytest.mark.parametrize("join_build", ["hashtable", "sort"])
@pytest.mark.parametrize("how", ["inner", "semi", "anti"])
def test_hash_join_pk_empty_build(how, join_build, monkeypatch, fresh_aot):
    bt, pt, keys = _tables("int64", seed=3, empty_build=True)
    ref, got = _run_both(bt, pt, keys, how, monkeypatch, join_build)
    assert got.count_valid() == (0 if how != "anti" else pt.num_rows)
    _same(ref, got)


def _unique_case(case, seed):
    r = np.random.default_rng(seed)
    k = r.permutation(500)[:200].astype(np.float64)
    if case == "dup":
        k[7] = k[100]
    elif case == "two_nulls":
        k[[3, 9]] = np.nan
    elif case == "one_null":
        k[3] = np.nan
    elif case == "signed_zero":  # -0.0 == +0.0: a duplicate key
        k[3], k[9] = 0.0, -0.0
    return pa.table({"k": pa.array(k), "c": pa.array(np.arange(200) % 7)})


@pytest.mark.parametrize("join_build", ["hashtable", "sort"])
@pytest.mark.parametrize("case", ["unique", "dup", "two_nulls", "one_null", "signed_zero"])
def test_build_keys_unique_matches_reference(case, join_build, monkeypatch, fresh_aot):
    monkeypatch.setenv("QK_KERNEL_STRATEGY", f"join_build={join_build}")
    rb = ref_batch_of(_unique_case(case, seed=5))
    b = port_batch(rb)
    want = case in ("unique", "one_null")
    assert ref_join.build_keys_unique(rb, ["k"]) is want
    assert join.build_keys_unique(b, ["k"]) is want
    # a composite key made unique by its second column
    assert join.build_keys_unique(b, ["k", "c"]) == ref_join.build_keys_unique(rb, ["k", "c"])


def test_diverged_build_takes_the_sorted_probe(monkeypatch, fresh_aot):
    """A build whose hash insert cannot converge is remembered on the batch
    (_DIVERGED) and every probe takes the sorted path (K12), with the
    reference's result; it never raises."""
    bt, pt, keys = _tables("int64", seed=9, nulls=False)
    rb, rp = ref_batch_of(bt), ref_batch_of(pt)
    ref = ref_join.hash_join_pk(rp, rb, ["pk"], keys, "inner", ["pay_f", "pay_s"])
    monkeypatch.setattr(hashtable, "capbits_for", lambda n: 2)  # 4 slots
    b, p = port_batch(rb), port_batch(rp)
    strategy.reset_used()
    assert join.build_keys_unique(b, keys)
    for _ in range(2):
        _same(ref, join.hash_join_pk(p, b, ["pk"], keys, "inner", ["pay_f", "pay_s"]))
    assert b._ht_cache[tuple(keys)] is hashtable._DIVERGED
    assert strategy.used_snapshot()["join_build"] == "sort"
    with pytest.raises(hashtable.HashTableConvergenceError):
        hashtable.build_table(b, keys, lambda *a: None, lambda: None)


def _raw_limbs(kind, n, r):
    """Raw key limbs (numpy) of one kind, with unique build rows."""
    if kind == "int64":
        return [r.permutation(4 * n)[:n].astype(np.int64) - 2 * n]
    if kind == "composite":
        flat = r.permutation(40 * n)[:n]
        return [(flat // 40).astype(np.int64), (flat % 40).astype(np.int32) - 20]
    if kind == "date":
        return [r.permutation(3 * n)[:n].astype(np.int32) + 9000]
    v = r.permutation(np.arange(-2 * n, 2 * n))[:n].astype(np.float64) / 8
    v[v == 0.0] = -0.0
    v[r.random(n) < 0.05] = np.nan  # never matches, sorts last
    return [v]


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_k12_sort_and_probe_match_reference(kind, fresh_aot):
    """K12's plain version at the function level: the build sort (stable,
    invalid rows last, -0.0 equal to +0.0, NaN last) and the lexicographic
    lower bound, exact against the reference's programs."""
    r = np.random.default_rng(len(kind))
    nb, p = 512, 3000
    build = _raw_limbs(kind, nb, r)
    bvalid = r.random(nb) < 0.9
    pick = r.integers(0, nb, p)
    other = _raw_limbs(kind, nb, np.random.default_rng(77))
    hit = r.random(p) < 0.6
    probe = [np.where(hit, b[pick], o[pick]).astype(b.dtype) for b, o in zip(build, other)]
    if kind == "float64":
        probe[0] = np.where(probe[0] == 0.0, 0.0, probe[0])
    pok = r.random(p) < 0.95
    r_sorted, r_perm, r_nv = ref_join._sort_build_keys(
        tuple(jnp.asarray(b) for b in build), jnp.asarray(bvalid))
    sorted_limbs, perm, nv = join._sort_build_keys(
        [torch.from_numpy(b) for b in build], torch.from_numpy(bvalid))
    assert int(nv) == int(r_nv)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(r_perm))
    for a, b in zip(sorted_limbs, r_sorted):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    steps = int(np.ceil(np.log2(nb))) + 1
    r_idx, r_m = ref_join._pk_probe_sorted(r_sorted, r_perm, r_nv,
                                           tuple(jnp.asarray(x) for x in probe),
                                           jnp.asarray(pok), steps)
    idx, m = join.pk_probe_sorted(sorted_limbs, perm, nv, [torch.from_numpy(x) for x in probe],
                                  torch.from_numpy(pok))
    np.testing.assert_array_equal(m.numpy(), np.asarray(r_m))
    np.testing.assert_array_equal(idx.numpy()[m.numpy()], np.asarray(r_idx)[np.asarray(r_m)])
    assert 0 < int(m.sum()) < p


@pytest.mark.parametrize("kind", KEY_KINDS)
def test_k11_build_and_probe_match_reference(kind, fresh_aot):
    """K11's plain version: the table built from a unique build's limbs and
    the probe walk give the reference's (build_idx, matched) exactly."""
    r = np.random.default_rng(10 + len(kind))
    nb, p = 700, 4000
    build = _raw_limbs(kind, nb, r)
    bvalid = r.random(nb) < 0.9
    pick = r.integers(0, nb, p)
    other = _raw_limbs(kind, nb, np.random.default_rng(78))
    hit = r.random(p) < 0.6
    probe = [np.where(hit, b[pick], o[pick]).astype(b.dtype) for b, o in zip(build, other)]
    pok = r.random(p) < 0.95

    class _B:
        padded_len = nb

    ref_t = ref_hashtable.build_table(
        _B(), ["k"], lambda b, k: [jnp.asarray(x) for x in build], lambda: jnp.asarray(bvalid))
    t = hashtable.build_table(_B(), ["k"], lambda b, k: [torch.from_numpy(x) for x in build],
                              lambda: torch.from_numpy(bvalid))
    r_idx, r_m = ref_hashtable.pk_probe(ref_t, [jnp.asarray(x) for x in probe], jnp.asarray(pok))
    idx, m = hashtable.pk_probe(t, [torch.from_numpy(x) for x in probe], torch.from_numpy(pok))
    np.testing.assert_array_equal(m.numpy(), np.asarray(r_m))
    np.testing.assert_array_equal(idx.numpy()[m.numpy()], np.asarray(r_idx)[np.asarray(r_m)])
    assert 0 < int(m.sum()) < p


def test_probe_keys_colliding_in_the_hash():
    """Keys that share a start slot still resolve to their own build rows:
    a build whose keys crowd a tiny table, probed with every key."""
    keys = torch.arange(0, 200, dtype=torch.int64) * (1 << 20)
    ok = torch.ones(200, dtype=torch.bool)

    class _B:
        padded_len = 200

    t = hashtable.build_table(_B(), ["k"], lambda b, k: [keys], lambda: ok)
    probe = torch.cat([keys.flip(0), keys + 1])
    idx, m = hashtable.pk_probe(t, [probe], torch.ones(400, dtype=torch.bool))
    assert bool(m[:200].all()) and not bool(m[200:].any())
    assert torch.equal(idx[:200].long(), torch.arange(199, -1, -1))


@pytest.mark.parametrize("build", ["no batch", "empty batch"])
@pytest.mark.parametrize("how", ["inner", "semi", "anti"])
def test_join_executor_with_an_empty_build(how, build, fresh_aot):
    """A build source that emitted no batch, or only a batch without live
    rows: inner and semi joins emit nothing, an anti join passes the probe
    rows through, as the reference's executor does."""
    from quokka_tpu.executors.sql_execs import BuildProbeJoinExecutor as RefJoin
    from quokka_tpu_torch.executors.sql_execs import BuildProbeJoinExecutor

    bt, pt, keys = _tables("int64", seed=4, empty_build=True)
    rb, rp = ref_batch_of(bt), ref_batch_of(pt)
    outs = []
    for ex, b, probe in ((RefJoin(["pk"], keys, how), rb, rp),
                         (BuildProbeJoinExecutor(["pk"], keys, how), port_batch(rb),
                          port_batch(rp))):
        if build == "empty batch":
            assert ex.execute([b], 1, 0) is None
        assert ex.source_done(1, 0) is None
        outs.append(ex.execute([probe], 0, 0))
    ref, got = outs
    if how == "anti":
        _same(ref, got)
    else:
        assert ref is None and got is None
