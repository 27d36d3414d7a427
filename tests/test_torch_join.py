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


# ---------------------------------------------------------------------------
# the general join: many-to-many and left (plan T, expand K13)
# ---------------------------------------------------------------------------


def _mm_tables(kind, seed, n_build=400, n_probe=1500, empty_build=False):
    """A build whose keys repeat (a few hot keys), and a probe table whose
    keys are drawn from the build keys, unmatched keys and nulls (NaN for
    float64, with -0.0 build keys met by +0.0 probes)."""
    r = np.random.default_rng(seed)
    pool = _key_columns(kind, 60, r)
    keys = list(pool)
    hot = np.where(r.random(n_build) < 0.3, r.integers(0, 3, n_build),
                   r.integers(0, 60, n_build))
    build = {k: pa.array(np.array(pool[k].to_pylist(), dtype=object)[hot].tolist(),
                         type=pool[k].type) for k in keys}
    build["pay_f"] = pa.array(r.normal(size=n_build))
    build["pay_i"] = pa.array(r.integers(-9, 9, n_build))
    build["pay_d"] = pa.array(r.integers(9000, 9100, n_build).astype(np.int32)).cast(pa.date32())
    build["pay_b"] = pa.array(r.random(n_build) < 0.5)
    build["pay_s"] = pa.array(np.array(["x", "y", "z"], dtype=object)[
        r.integers(0, 3, n_build)].tolist(), type=pa.string())
    m = r.random(n_build) < 0.05
    k0 = build[keys[0]].to_pylist()
    build[keys[0]] = pa.array([None if x else v for v, x in zip(k0, m)], type=pool[keys[0]].type)
    other = _key_columns(kind, 60, np.random.default_rng(seed + 100))
    pick = r.integers(0, 60, n_probe)
    from_build = r.random(n_probe) < 0.7
    probe = {}
    for k in keys:
        bv = np.array(pool[k].to_pylist(), dtype=object)
        ov = np.array(other[k].to_pylist(), dtype=object)
        v = np.where(from_build, bv[pick], ov[pick])
        if kind == "float64":
            v = np.where(v == 0.0, 0.0, v)
            v[r.random(n_probe) < 0.03] = np.nan
        if k == keys[0]:
            v[r.random(n_probe) < 0.05] = None
        probe["p" + k] = pa.array(v.tolist(), type=pool[k].type)
    probe["val"] = pa.array(r.integers(0, 1000, n_probe))
    bt = pa.table(build)
    return (bt.slice(0, 0) if empty_build else bt), pa.table(probe), keys


MM_PAYLOAD = ["pay_f", "pay_i", "pay_d", "pay_b", "pay_s"]


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_hash_join_general_matches_reference(kind, how, fresh_aot):
    """Output rows index for index (probe row first, then the key's build
    rows in row order), left-join null payloads included."""
    bt, pt, keys = _mm_tables(kind, seed=len(kind) + len(how))
    rb, rp = ref_batch_of(bt), ref_batch_of(pt)
    pkeys = ["p" + k for k in keys]
    ref = ref_join.hash_join_general(rp, rb, pkeys, keys, how, MM_PAYLOAD)
    got = join.hash_join_general(port_batch(rp), port_batch(rb), pkeys, keys, how, MM_PAYLOAD)
    assert got.padded_len == ref.padded_len
    assert 0 < got.count_valid()
    _same(ref, got)
    if how == "left":
        # unmatched probe rows carry nulls: NaN, the int sentinels, code -1
        # and bools upcast to int32
        assert got.columns["pay_b"].data.dtype == torch.int32
        nulls = got.valid & (got.columns["pay_s"].codes < 0)
        assert 0 < int(nulls.sum()) < got.count_valid()
        assert bool(torch.isnan(got.columns["pay_f"].data[nulls]).all())
        assert bool((got.columns["pay_i"].data[nulls] == -(2**63)).all())
        assert bool((got.columns["pay_d"].data[nulls] == -(2**31)).all())


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_hash_join_general_empty_build(how, fresh_aot):
    bt, pt, keys = _mm_tables("int64", seed=8, empty_build=True)
    rb, rp = ref_batch_of(bt), ref_batch_of(pt)
    ref = ref_join.hash_join_general(rp, rb, ["pk"], keys, how, MM_PAYLOAD)
    got = join.hash_join_general(port_batch(rp), port_batch(rb), ["pk"], keys, how,
                                 MM_PAYLOAD)
    assert got.count_valid() == (0 if how in ("inner", "semi") else pt.num_rows)
    _same(ref, got)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("skew", [False, True], ids=["spread", "one_hot_key"])
def test_k13_plain_matches_reference_index_for_index(how, skew, fresh_aot):
    """K13's plain version against the reference's _mm_expand and
    mm_unmatched at every output row, the padding rows past the total
    included."""
    r = np.random.default_rng(31 + skew)
    p, b = 700, 3000
    bk = r.integers(0, 40, b).astype(np.int64)
    if skew:
        bk[: b // 2] = 7  # one probe key matches 1500 build rows
    pk = r.integers(0, 60, p).astype(np.int64)
    lv = [np.concatenate([pk, bk])]
    valid = np.concatenate([r.random(p) < 0.9, r.random(b) < 0.95])
    probe_valid = np.ones(p, dtype=bool)
    r_mc, r_total, r_off, r_bps, r_rp = ref_join.mm_plan_for(
        [jnp.asarray(lv[0])], jnp.asarray(valid), p, how, probe_valid=jnp.asarray(probe_valid))
    mc, total, off, bps, rp_, unm = join.mm_plan_for(
        [torch.from_numpy(lv[0])], torch.from_numpy(valid), p, how, torch.from_numpy(probe_valid))
    assert int(total) == int(r_total) > 0
    np.testing.assert_array_equal(mc.numpy(), np.asarray(r_mc))
    out_padded = int(2 ** np.ceil(np.log2(int(total) + 100)))
    r_pi, r_bi, r_ov = ref_join._mm_expand(r_mc, r_off, r_bps, r_rp, r_total, out_padded)
    pi, bi, ov, u = join.mm_expand(mc, off, bps, rp_, total, out_padded, unm)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(r_pi))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(r_bi))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(r_ov))
    if how == "left":
        r_u = ref_join.mm_unmatched([jnp.asarray(lv[0])], jnp.asarray(valid), p, r_pi, r_mc)
        np.testing.assert_array_equal(u.numpy(), np.asarray(r_u))
        assert 0 < int(u[ov].sum())
    else:
        assert u is None


def test_left_join_over_a_build_source_with_no_batch(fresh_aot):
    """A left join whose build source emitted no batch at all keeps every
    probe row with all-null (float) payloads from the plan's schema; the
    reference's executor fails on this path (its output list is only bound
    after a raise), so pandas is the oracle."""
    import pandas as pd
    from quokka_tpu_torch.executors.sql_execs import BuildProbeJoinExecutor

    _bt, pt, keys = _mm_tables("int64", seed=4, empty_build=True)
    probe = port_batch(ref_batch_of(pt))
    ex = BuildProbeJoinExecutor(["pk"], keys, "left",
                                out_schema=list(pt.column_names) + MM_PAYLOAD)
    assert ex.source_done(1, 0) is None
    out = ex.execute([probe], 0, 0)
    assert out.count_valid() == pt.num_rows
    assert list(out.columns) == list(pt.column_names) + MM_PAYLOAD
    for c in MM_PAYLOAD:
        assert bool(torch.isnan(out.columns[c].data[out.valid]).all())
    df = pt.to_pandas()
    np.testing.assert_array_equal(out.columns["val"].data.numpy()[out.valid.numpy()],
                                  pd.Series(df.val).to_numpy())
