"""K18's run table and two-level search, and the build cache's headers.

K18 (``csrc/asof.cu``) searches the quotes' runs of equal keys, then the
time inside the probe key's run; K12 (``csrc/join.cu``) and K18 share
``csrc/search.cuh``.  The kernels run only on a card (tests/test_torch_cuda.py,
chip_smoke.py hold them against the plain versions bit for bit); here:

- ``_ss_key_runs`` against a run table written in numpy (keys, starts, ends);
- the two-level identity: the search over the runs and then over the time
  inside the run, written in numpy below, gives ``_asof_probe_plain``'s
  (quote_idx, matched) on every row, both directions, with probe keys
  before the first run, between runs and after the last, NaN and -0.0 keys
  and times, and ties;
- ``native._target`` changes when a header's bytes change.

Every output is an index or a flag: the comparisons are exact.
"""

import shutil

import numpy as np
import pytest
import torch

from quokka_tpu_torch.ops import asof, native

CSRC = native.CSRC_DIR


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _keys(kind, code):
    """Key limbs (numpy) for integer codes of one kind."""
    if kind == "none":
        return []
    if kind == "str":  # two int32 hash limbs
        return [(code % 5 * 7 - 3).astype(np.int32), (code * 7919 - 3).astype(np.int32)]
    if kind == "int":
        return [code.astype(np.int64) * 3]
    v = (code.astype(np.float64) - 5) / 2  # float: -0.0, +0.0 and NaN keys
    v[code == 5] = np.where(np.arange((code == 5).sum()) % 2 == 0, -0.0, 0.0)
    v[code % 11 == 7] = np.nan
    return [v]


def _times(kind, n, t_hi, r):
    x = r.integers(0, t_hi, n)
    if kind == "int64":
        return x.astype(np.int64)
    if kind == "int32":
        return (x - t_hi // 2).astype(np.int32)
    if kind == "float32":
        return (x / 4).astype(np.float32)
    v = x.astype(np.float64) / 4
    v[r.random(n) < 0.05] = np.nan
    v[v == 0] = -0.0
    return v


def _quotes(kind, time_kind, nq, n_keys, t_hi, valid_share, seed):
    """Quotes sorted by ``_ss_sort_quotes``, and their key codes (odd: a
    probe's even code falls between two runs)."""
    r = np.random.default_rng(seed)
    code = r.integers(0, n_keys, nq) * 2 + 1
    ops = [_t(a) for a in _keys(kind, code) + [_times(time_kind, nq, t_hi, r)]]
    valid = _t(r.random(nq) < valid_share)
    return asof._ss_sort_quotes(ops, valid), code


def _np_runs(sorted_ops, n_valid, nkey):
    """The run table in numpy: a run starts at row 0 and wherever a key limb
    differs (``!=``) from the row before, inside the valid prefix."""
    keys = [o.numpy() for o in sorted_ops[:nkey]]
    if nkey == 0:
        return [], np.array([0]), np.array([n_valid])
    starts = [i for i in range(n_valid)
              if i == 0 or any(k[i] != k[i - 1] for k in keys)]
    ends = starts[1:] + [n_valid] if starts else []
    return [k[starts] for k in keys], np.array(starts, dtype=np.int64), np.array(ends)


RUN_CASES = {  # kind, n_keys, valid share
    "no key": ("none", 30, 0.8),
    "one key": ("str", 1, 0.8),
    "every quote its own key": ("int", 10**6, 1.0),
    "all quotes invalid": ("str", 30, 0.0),
    "float keys with NaN and -0.0": ("float", 12, 0.8),
    "string keys": ("str", 40, 0.8),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_key_runs_match_numpy(case):
    kind, n_keys, share = RUN_CASES[case]
    (so, perm, nv), _ = _quotes(kind, "int64", 600, n_keys, 50, share, seed=len(case))
    nkey = len(so) - 1
    runs = asof._ss_key_runs(so, nv, nkey)
    keys, starts, ends = _np_runs(so, int(nv), nkey)
    assert runs.bounds.dtype == torch.int32
    assert len(runs.keys) == nkey
    np.testing.assert_array_equal(runs.starts.numpy(), starts)
    np.testing.assert_array_equal(runs.ends.numpy(), ends)
    for got, want, s in zip(runs.keys, keys, so):
        assert got.dtype == s.dtype
        np.testing.assert_array_equal(got.numpy(), want)  # NaN equals NaN here
    if case == "every quote its own key":
        assert len(starts) == int(nv) == 600
    if case == "all quotes invalid":
        assert len(starts) == 0 and runs.bounds.tolist() == [0]
    if case == "float keys with NaN and -0.0":
        k = so[0].numpy()[:int(nv)]
        assert (k == 0).sum() > 1 and np.isnan(k).sum() > 1
        zero = np.flatnonzero(keys[0] == 0)
        assert len(zero) == 1 and ends[zero[0]] - starts[zero[0]] == (k == 0).sum()
        assert np.isnan(keys[0]).sum() == np.isnan(k).sum()  # each NaN row a run


def _lex(a, b):
    """Lexicographic (a < b, a == b) of two limb tuples, IEEE per limb."""
    lt, eq = False, True
    for x, y in zip(a, b):
        lt = lt or (eq and bool(x < y))
        eq = eq and bool(x == y)
    return lt, eq


def _two_level(keys, starts, ends, n_valid, times, perm, probe_ops, probe_valid, upper):
    """K18's search in numpy: count the runs whose key is below the probe's
    (their number is the lower bound, the predicate being monotone); if
    that run's key equals the probe's, count its times <= t (backward) or <
    t (forward), else stop at the run's first row."""
    nq, nkey, n_runs = len(perm), len(keys), len(starts)
    idx = np.zeros(len(probe_valid), dtype=np.int32)
    matched = np.zeros(len(probe_valid), dtype=bool)
    for i in range(len(probe_valid)):
        x = [o[i] for o in probe_ops[:nkey]]
        t = probe_ops[nkey][i]
        r = sum(_lex([k[j] for k in keys], x)[0] for j in range(n_runs))
        keq = r < n_runs and _lex([k[r] for k in keys], x)[1]
        lo = starts[r] if r < n_runs else n_valid
        pos, hit = lo, False
        if keq:
            seg = times[lo:ends[r]]
            below = (seg < t) | (seg == t) if upper else seg < t
            pos = lo + int(below.sum())
            hit = pos > lo if upper else pos < ends[r]
        at = pos - 1 if upper else pos
        idx[i] = min(max(perm[min(max(at, 0), nq - 1)], 0), nq - 1)
        matched[i] = probe_valid[i] and hit
    return idx, matched


IDENTITY_CASES = {  # kind, time kind, n_keys, t_hi
    "string keys, int64 times, ties": ("str", "int64", 6, 40),
    "int keys, float64 times with NaN and -0.0": ("int", "float64", 6, 400),
    "float keys with NaN and -0.0, int32 times": ("float", "int32", 6, 60),
    "no key, float32 times": ("none", "float32", 1, 50),
    "int keys, every quote its own key": ("int", "int64", 10**6, 10**6),
}


@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("case", list(IDENTITY_CASES))
def test_two_level_search_gives_the_plain_probe(case, direction):
    kind, time_kind, n_keys, t_hi = IDENTITY_CASES[case]
    r = np.random.default_rng(len(case) + len(direction))
    (so, perm, nv), q_code = _quotes(kind, time_kind, 400, n_keys, t_hi, 0.85,
                                     seed=len(case))
    nkey = len(so) - 1
    # probe keys: the quotes' own, between two runs (even codes), below the
    # first run and above the last
    code = q_code[r.integers(0, 400, 300)]
    code[:60] -= 1
    code[60:75] = q_code.min() - 3
    code[75:90] = q_code.max() + 3
    probe = [_t(a) for a in _keys(kind, code) + [_times(time_kind, 300, t_hi, r)]]
    probe_valid = _t(r.random(300) < 0.9)
    upper = direction == "backward"
    want_idx, want_m = asof._asof_probe_plain(so, perm, nv, probe, probe_valid, upper, nkey)
    keys, starts, ends = _np_runs(so, int(nv), nkey)
    idx, matched = _two_level(keys, starts, ends, int(nv), so[nkey].numpy(), perm.numpy(),
                              [o.numpy() for o in probe], probe_valid.numpy(), upper)
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(matched, want_m.numpy())
    assert matched.sum() > 0
    if nkey:
        assert not matched[:90].any()


def test_build_digest_covers_every_header(tmp_path, monkeypatch):
    """An edit to a shared header (csrc/search.cuh) rebuilds every library:
    the target path hashes the source, every csrc/*.cuh and the flags."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(native, "CSRC_DIR", csrc)
    before = {n: native._target(n) for n in native.SOURCES}
    assert all(p.name.startswith(f"lib{n}-") for n, p in before.items())
    assert {n: native._target(n) for n in native.SOURCES} == before
    header = csrc / "search.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: native._target(n) for n in native.SOURCES}
    assert all(after[n] != before[n] for n in native.SOURCES)
    (csrc / "extra.cuh").write_bytes(b"#pragma once\n")
    assert all(native._target(n) != after[n] for n in native.SOURCES)


@pytest.mark.parametrize("name", ["asof", "join"])
def test_sorted_searches_share_one_header(name):
    """K18 and K12 search through csrc/search.cuh and keep no copy of it."""
    src = (CSRC / f"{name}.cu").read_text()
    assert '#include "search.cuh"' in src
    for symbol in ("struct TypedLimbs", "void qk_cmp_limb(", "void qk_lex("):
        assert symbol not in src
        assert symbol in (CSRC / "search.cuh").read_text()
