"""The port's compact-concat (K8's plain version, ``compact_concat_plain``,
reached through ``bridge.concat_batches`` on the CPU) against the
reference's ``quokka_tpu.ops.bridge.concat_batches`` (JAX x64 on the CPU):
its fused program ``_fused_concat_kernel`` where every column concatenates
as it is, its general path where a column's dtype differs between parts.

The parts are made with numpy from a seed and handed to both packages with
their live counts known, so both compact.  Everything compares exactly:
the live count, the validity, every padded row of every column (floats as
their bits, NaN and -0.0 included), the column kinds, units and dtypes, and
the merged string dictionaries; the rows past the live ones are zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quokka_tpu.ops import batch as ref_batch
from quokka_tpu.ops import bridge as ref_bridge
from quokka_tpu_torch import config
from quokka_tpu_torch.ops import bridge
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, StrCol, StringDict, VecCol

import torch_port_util  # noqa: F401  (each test process gets its own reference AOT store)

WORDS = np.array(["apple", "kiwi", "fig", "plum", "pear", "lime"], dtype=object)

# the columns of each case: name -> kind ("i" int64, "f" float64 with NaN
# and -0.0, "n" int32, "d" date32 days, "t" timestamp ms, "b" bool, "s" a
# string column with its own dictionary a part and nulls, "v" a 4-wide
# vector, "m" int32 in the first part and int64 in the others)
COLUMNS = {
    "numbers": {"i": "i", "f": "f", "n": "n", "d": "d", "t": "t", "b": "b"},
    "strings": {"s": "s", "k": "i"},
    "vectors": {"v": "v", "f": "f"},
    "dtype_differs_between_parts": {"m": "m", "s": "s", "f": "f"},
}
# each part: (padded rows, live rows: a share, or an exact count)
LIVE = {
    "mixed": [(1024, 0.6), (256, 0.3), (4096, 0.8)],
    "a_part_with_no_live_row": [(256, 0), (1024, 0.5), (256, 0)],
    "fully_live": [(1024, 1.0), (4096, 1.0)],
    "one_live_row": [(256, 0), (1024, 1)],
    "total_equal_to_the_bucket": [(768, 1.0), (256, 1.0)],
}


def _column(r, kind, m, part):
    """(numpy data, port kind, unit, dictionary values or None)."""
    if kind == "i":
        return r.integers(-10**15, 10**15, m), "i", None, None
    if kind == "f":
        x = r.normal(size=m).round(2)
        x[r.random(m) < 0.1] = np.nan
        x[r.random(m) < 0.1] = -0.0
        return x, "f", None, None
    if kind == "n":
        return r.integers(-1000, 1000, m).astype(np.int32), "i", None, None
    if kind == "m":
        x = r.integers(-1000, 1000, m)
        return (x.astype(np.int32) if part == 0 else x), "i", None, None
    if kind == "d":
        return r.integers(-3000, 20_000, m).astype(np.int32), "d", None, None
    if kind == "t":
        return r.integers(0, 2 * 10**12, m), "t", "ms", None
    if kind == "b":
        return r.random(m) < 0.5, "b", None, None
    if kind == "s":
        vals = WORDS[r.permutation(len(WORDS))[: 3 + part]]
        return r.integers(-1, len(vals), m).astype(np.int32), "s", None, vals
    return r.normal(size=(m, 4)), "v", None, None


def _parts(columns, live, seed):
    """The same parts for both packages: (reference batches, port batches)."""
    r = np.random.default_rng(seed)
    ref, port = [], []
    for part, (m, share) in enumerate(live):
        valid = np.zeros(m, dtype=bool)
        if isinstance(share, int) and share > 0:
            valid[r.choice(m, share, replace=False)] = True
        elif isinstance(share, float):
            valid = r.random(m) < share
        rcols, pcols = {}, {}
        for name, kind in columns.items():
            data, pkind, unit, vals = _column(r, kind, m, part)
            if pkind == "s":
                rcols[name] = ref_batch.StrCol(jnp.asarray(data), ref_batch.StringDict(vals))
                pcols[name] = StrCol(torch.from_numpy(data), StringDict(vals))
            elif pkind == "v":
                rcols[name] = ref_batch.VecCol(jnp.asarray(data))
                pcols[name] = VecCol(torch.from_numpy(data))
            else:
                rcols[name] = ref_batch.NumCol(jnp.asarray(data), pkind, unit=unit)
                pcols[name] = NumCol(torch.from_numpy(data), pkind, unit)
        n = int(valid.sum())
        ref.append(ref_batch.DeviceBatch(rcols, jnp.asarray(valid), nrows=n))
        port.append(DeviceBatch(pcols, torch.from_numpy(valid), n))
    return ref, port


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("live", list(LIVE))
@pytest.mark.parametrize("columns", list(COLUMNS))
def test_compact_concat_matches_reference(columns, live):
    ref_parts, port_parts = _parts(COLUMNS[columns], LIVE[live], seed=len(columns) + len(live))
    exp = ref_bridge.concat_batches(ref_parts)
    got = bridge.concat_batches(port_parts)
    total = sum(b.nrows for b in port_parts)
    assert got.nrows == exp.nrows == total
    assert got.padded_len == config.bucket_size(total)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(exp.valid))
    assert list(got.columns) == list(exp.columns)
    for name, c in got.columns.items():
        e = exp.columns[name]
        if isinstance(c, StrCol):
            assert isinstance(e, ref_batch.StrCol)
            data, want = c.codes.numpy(), np.asarray(e.codes)
            assert list(c.dictionary.values) == list(e.dictionary.values)
        elif isinstance(c, VecCol):
            assert isinstance(e, ref_batch.VecCol)
            data, want = c.data.numpy(), np.asarray(e.data)
        else:
            assert (c.kind, c.unit) == (e.kind, e.unit)
            data, want = c.data.numpy(), np.asarray(e.data)
        assert data.dtype == want.dtype and data.shape == want.shape, name
        np.testing.assert_array_equal(_bits(data), _bits(want), err_msg=name)
        assert not data[total:].any(), name
    if live == "total_equal_to_the_bucket":
        assert total == got.padded_len


def test_compact_concat_charges_one_dispatch_a_call():
    """On the CPU, one plain call is one devprof dispatch of K8, charged the
    validity of every part row, each live row of each column and the
    written bucket of each column and of the validity."""
    from quokka_tpu_torch.obs import devprof

    _, parts = _parts(COLUMNS["numbers"], LIVE["mixed"], seed=3)
    devprof.reset()
    bridge.concat_batches(parts)
    (row,) = [r for r in devprof.costs_snapshot() if r["kernel"] == "K8"]
    total = sum(b.nrows for b in parts)
    padded = config.bucket_size(total)
    widths = 8 + 8 + 4 + 4 + 8 + 1
    assert row["device"] == "cpu" and row["dispatches"] == 1
    assert row["bytes"] == sum(b.padded_len for b in parts) + total * widths + padded * (widths + 1)
