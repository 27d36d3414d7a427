"""The port's narrowed wire (quokka_tpu_torch/ops/pack.py) against the
reference's (quokka_tpu/ops/pack.py, JAX x64 on the CPU): the same numpy
leaves through both ``pack_put``s decode bit for bit (floats compared as
integers), with the same wire layout per batch and the same sticky plans
along a sequence of batches under one signature.  On the CPU the port runs
K23's plain version.  Both keep the input's bits: -0.0 and NaN payloads
survive either wire.  Also: TPC-H Q1 and Q3 landed through the new bridge
equal the reference's results.

Tolerances: decoded leaves exact; query results as in test_torch_q1 /
test_torch_q3q5 (floats rtol 1e-9, summation order).
"""

import threading

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import quokka_tpu
import quokka_tpu_torch
import tpch_data
from quokka_tpu import QuokkaContext as RefContext
from quokka_tpu.ops import pack as ref_pack
from quokka_tpu_torch import QuokkaContext
from quokka_tpu_torch.ops import pack
from quokka_tpu_torch.runtime import scancache
from quokka_tpu_torch.runtime.engine import Engine

from torch_port_util import fresh_aot  # noqa: F401
from test_torch_q1 import pandas_q1, q1, same
from test_torch_q3q5 import pandas_q3, q3, same_q3

NULL_I64 = np.iinfo(np.int64).min
NULL_I32 = np.iinfo(np.int32).min


class _ThisThread(dict):
    """A module-wide plan or program cache that also records the keys the
    test's own threads set: the test's thread and the IO threads of the
    engines it started (``owners``), which land the port's batches.  The
    caches are shared by every thread of the process: a query that another
    test left running (a service's or a stream's thread) lands its batches
    through them too, so the checks read only the entries of the calls
    under test (``mine``).  ``_own_caches`` installs them for each test and
    puts the module's own back after it."""

    def __init__(self, owners=None):
        super().__init__()
        self.owners = {threading.get_ident()} if owners is None else owners
        self.own = []

    def _note(self, key):
        if threading.get_ident() in self.owners and key not in self.own:
            self.own.append(key)

    def setdefault(self, key, default=None):
        self._note(key)
        return super().setdefault(key, default)

    def __setitem__(self, key, value):
        self._note(key)
        super().__setitem__(key, value)

    def clear(self):
        self.own = []
        super().clear()

    def mine(self) -> dict:
        return {k: self[k] for k in self.own}


@pytest.fixture(autouse=True)
def _own_caches(monkeypatch):
    monkeypatch.setattr(ref_pack, "_PLANS", _ThisThread())
    monkeypatch.setattr(ref_pack, "_DECODE_PROGRAMS", _ThisThread())
    # the port's engines started in the test, and the threads that landed
    # batches for them (their IO pools')
    owners, engines = {threading.get_ident()}, set()
    real_pool, real_read = Engine._ensure_prefetch_pool, Engine._read_and_bridge

    def ensure_pool(self):
        engines.add(self)
        return real_pool(self)

    def read_and_bridge(self, *a):
        if self in engines:
            owners.add(threading.get_ident())
        return real_read(self, *a)

    monkeypatch.setattr(Engine, "_ensure_prefetch_pool", ensure_pool)
    monkeypatch.setattr(Engine, "_read_and_bridge", read_and_bridge)
    monkeypatch.setattr(pack, "_PLANS", _ThisThread(owners))
    # a warm scan lands nothing: every query here reads its files anew
    scancache.clear()
    yield
    scancache.clear()


def _clear():
    ref_pack._PLANS.clear()
    ref_pack._DECODE_PROGRAMS.clear()
    pack._PLANS.clear()


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


def _plans(plans):
    return [None if p is None else (type(p).__name__, getattr(p, "wire", None),
                                    getattr(p, "mode", None), getattr(p, "tlen", None))
            for p in plans]


def _put_both(leaves):
    """(reference outputs, port outputs, reference layout, port layout)."""
    ref_pack._DECODE_PROGRAMS.clear()
    ref = [np.asarray(a) for a in ref_pack.pack_put(
        [ref_pack.ValidCount(x.padded, x.nrows) if isinstance(x, pack.ValidCount) else x
         for x in leaves])]
    (ref_layout,) = list(ref_pack._DECODE_PROGRAMS.mine())
    seen = []
    real = pack.decode_plain

    def spy(layout, wires):
        seen.append(tuple(layout))
        return real(layout, wires)

    pack.decode_plain = spy
    try:
        got = [t.numpy() for t in pack.pack_put(leaves, "cpu")]
    finally:
        pack.decode_plain = real
    return ref, got, ref_layout, seen[0]


def _check(leaves):
    ref, got, ref_layout, port_layout = _put_both(leaves)
    assert port_layout == ref_layout
    for leaf, r, g in zip(leaves, ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape, port_layout
        np.testing.assert_array_equal(_bits(g), _bits(r))
        if isinstance(leaf, pack.ValidCount):
            np.testing.assert_array_equal(g, np.arange(leaf.padded) < leaf.nrows)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(np.asarray(leaf)))
    assert len(ref_pack._PLANS.mine()) == len(pack._PLANS.mine()) == 1
    (rp,), (pp,) = ref_pack._PLANS.mine().values(), pack._PLANS.mine().values()
    assert _plans(pp) == _plans(rp)
    return port_layout


def _int_leaf(r, n, dtype, width, sentinel):
    lo = int(r.integers(-1000, 1000))
    a = (lo + r.integers(0, width + 1, n)).astype(dtype)
    if sentinel and n:
        a[r.random(n) < 0.05] = NULL_I64 if dtype == np.int64 else NULL_I32
    return a


def _float_leaf(r, n, distinct, specials):
    pool = np.round(r.uniform(-100, 100, distinct), 2)
    if specials:
        pool[: min(2, distinct)] = [-0.0, np.nan][: min(2, distinct)]
    return r.choice(pool, n) if distinct else r.normal(size=n)


LEAF_KINDS = ["int32", "int64", "float64", "float32", "bool", "vector"]


@settings(max_examples=40, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1),
       n=st.sampled_from([100, 4095, 4096, 5000, 1 << 14]),
       kinds=st.lists(st.sampled_from(LEAF_KINDS), min_size=1, max_size=5),
       widths=st.lists(st.sampled_from([0, 1, 255, 256, 65535, 65536, 2**33]),
                       min_size=5, max_size=5),
       distinct=st.lists(st.sampled_from([0, 1, 11, 200, 201, 257]), min_size=5, max_size=5),
       live=st.sampled_from(["none", "all", "some"]))
def test_pack_put_matches_reference(seed, n, kinds, widths, distinct, live):
    """Ints across the 8- and 16-bit edges, below and above 4096 elements,
    with null sentinels; floats with NaN and -0.0 at 1 to 257 distinct
    values or high cardinality; bools; 2-D vectors; ValidCount at 0 and
    full rows."""
    _clear()
    r = np.random.default_rng(seed)
    nrows = {"none": 0, "all": n, "some": int(r.integers(0, n + 1))}[live]
    leaves = [pack.ValidCount(n, nrows)]
    for i, kind in enumerate(kinds):
        if kind in ("int32", "int64"):
            w = widths[i] if kind == "int64" else min(widths[i], 2**31)
            leaves.append(_int_leaf(r, n, np.dtype(kind), w, sentinel=widths[i] == 2**33))
        elif kind == "float64":
            leaves.append(_float_leaf(r, n, distinct[i], specials=True))
        elif kind == "float32":
            leaves.append(_float_leaf(r, n, distinct[i], specials=True).astype(np.float32))
        elif kind == "bool":
            leaves.append(r.random(n) < 0.5)
        else:
            leaves.append(r.choice(np.round(r.normal(size=8), 1), (n, 3)))
    _check(leaves)


def test_negative_zero_and_nan_keep_their_bits():
    """Both wires ship -0.0 and NaN as their own dictionary entries: the
    decoded bits equal the input's in both packages."""
    _clear()
    n = 8192
    f = np.random.default_rng(3).choice(np.array([0.0, -0.0, np.nan, 1.5]), n)
    layout = _check([pack.ValidCount(n, n), f])
    assert [s[0] for s in layout] == ["valid", "dict"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_uint16_codes(dtype):
    """A dictionary plan whose table grows past 256 entries ships uint16
    codes (the sample's 200-distinct cutoff decides on the first batch)."""
    _clear()
    r = np.random.default_rng(16)
    n = 1 << 14
    pool = np.round(r.uniform(0, 1000, 300), 3).astype(dtype)
    for k in (150, 257, 300):
        layout = _check([pack.ValidCount(n, n), r.choice(pool[:k], n)])
        assert layout[1][0] == "dict"
    (plans,) = pack._PLANS.mine().values()
    assert (plans[1].mode, plans[1].tlen) == ("dict", 512)


def test_plans_widen_then_degrade_like_the_reference():
    """One signature: ints widen uint8 -> uint16 -> full and stay full;
    floats grow their table, then degrade to full width for good."""
    _clear()
    r = np.random.default_rng(9)
    n = 1 << 13
    seq = [
        (r.integers(0, 200, n), r.choice(np.arange(10) / 10, n)),
        (r.integers(0, 60000, n), r.choice(np.arange(180) / 7, n)),
        (r.integers(0, 200, n), r.choice(np.arange(180) / 7, n)),
        (r.integers(-2**40, 2**40, n), r.normal(size=n)),
        (r.integers(0, 200, n), r.choice(np.arange(10) / 10, n)),
    ]
    kinds, plans = [], []
    for ints, floats in seq:
        layout = _check([pack.ValidCount(n, n), ints, floats])
        kinds.append([s[0] for s in layout])
        (p,) = pack._PLANS.mine().values()
        plans.append(_plans(p))
    assert kinds == [["valid", "widen", "dict"], ["valid", "widen", "dict"],
                     ["valid", "widen", "dict"], ["valid", "pass", "pass"],
                     ["valid", "pass", "pass"]]
    assert [p[1][1] for p in plans] == ["uint8", "uint16", "uint16", "full", "full"]
    assert [p[2][2:] for p in plans] == [("dict", 16), ("dict", 256), ("dict", 256),
                                         ("full", 0), ("full", 0)]


def test_empty_and_small_batches():
    _clear()
    _check([pack.ValidCount(256, 0), np.zeros(256, dtype=np.int64), np.zeros(256)])
    _clear()
    assert pack.pack_put([], "cpu") == []


@pytest.fixture(scope="module")
def tpch(tmp_path_factory):
    tables = tpch_data.generate(sf=0.003, seed=11)
    root = tmp_path_factory.mktemp("tpch_pack")
    paths = tpch_data.write_parquet_dir(tables, str(root))
    return paths, {k: t.to_pandas() for k, t in tables.items()}


def test_q1_through_the_narrowed_wire_matches_reference(tpch, fresh_aot):
    paths, dfs = tpch
    _clear()
    got = q1(QuokkaContext(device="cpu"), paths["lineitem"])
    assert pack._PLANS.mine(), "the bridge did not land through pack_put"
    same(got, pandas_q1(dfs["lineitem"]))
    same(got, q1(RefContext(), paths["lineitem"]))


def test_q3_through_the_narrowed_wire_matches_reference(tpch, fresh_aot):
    paths, dfs = tpch
    _clear()
    got = q3(quokka_tpu_torch, QuokkaContext(device="cpu"), paths).collect()
    assert pack._PLANS.mine(), "the bridge did not land through pack_put"
    same_q3(got, pandas_q3(dfs))
    same_q3(got, q3(quokka_tpu, RefContext(), paths).collect())
