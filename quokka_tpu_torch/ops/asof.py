"""As-of join kernels (PyTorch port of ``quokka_tpu/ops/asof.py``).

Two strategies (``ops/strategy`` op ``asof``), each recorded as it runs:

- ``searchsorted``, the default on both rows of the port's matrix: the
  quotes are sorted once by (key limbs, time) with stable torch sorts
  (Queue 2 row 18's sort, T), cached on the quote batch so repeated
  flushes against an unchanged buffer pay it once, with the run table of
  its keys (``_ss_key_runs``: one run per distinct key, built once per
  buffer), and kernel K18 (``asof_probe``, ``csrc/asof.cu``) resolves
  every trade row with a search of the runs, then of the time inside its
  key's run: the upper bound minus one for backward asof, the lower bound
  for forward.
- ``sort``: both sides concatenated, dense-ranked by key (row 10), one
  stable sort by (validity, rank, time, side, tie), then kernel K19
  (``seg_fill_forward``, ``csrc/asof.cu``), a segmented running max that
  carries the latest quote position forward onto every trade row.

The reference's third strategy, ``host`` (its native O(n+m) merge), is
CPU-only there (``strategy.py:316-330``) and is not ported: asking for it
raises.  Times and keys keep native dtypes (int64 times, int32 string
hash limbs): the reference's two-limb wide times (``ops/timewide.py``)
are not needed.  Direction 'backward' matches quotes with time <= trade
time; 'forward' quotes with time >= trade time.  Among quotes sharing
(key, time), backward takes the last by original row and forward the
first, as pandas' merge_asof does.

Each kernel has its plain torch version beside it (``_asof_probe_plain``,
``_seg_fill_forward_plain``); the wrappers take them for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import kernels, native
from quokka_tpu_torch.ops import strategy as kstrategy
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, key_limbs, with_nulls

# launches of the K18 and K19 CUDA kernels; K18's launches that took the
# runtime-dispatch kernel (a key or time signature csrc/asof.cu does not
# compile typed) are also counted apart
ASOF_PROBE_LAUNCHES = 0
ASOF_PROBE_DISPATCH_LAUNCHES = 0
FILL_FORWARD_LAUNCHES = 0

_LIMB_DT = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3,
            torch.bool: 4}
_SCAN_BLOCK = 1024  # rows per block of K19's passes


def _lib():
    lib = native.library("asof")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        PP, PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.qk_asof_probe.argtypes = [PP, PP, PI, I, I, P, L, P, P, L, P, L, P, P, PI, P]
        lib.qk_asof_probe.restype = I
        lib.qk_seg_fill_forward.argtypes = [P, P, L, P, P, P, P, P, P]
        lib.qk_seg_fill_forward.restype = I
        lib.qk_bound = True
    return lib


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# K19: segmented fill-forward
# ---------------------------------------------------------------------------


def _seg_fill_forward_plain(values: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Plain version of K19: within each segment (``seg_start`` marks its
    first row; rows before the first mark form one segment), the running max
    of int32 ``values``.  Each segment is lifted above every earlier one by
    2^33 per segment start, so one unsegmented cummax never carries across
    a start."""
    seg = torch.cumsum(seg_start.to(torch.int64), 0) << 33
    lifted = values.to(torch.int64) + seg
    return (torch.cummax(lifted, 0).values - seg).to(values.dtype)


def _seg_fill_forward_cuda(values: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    global FILL_FORWARD_LAUNCHES
    _require_cuda(values, "seg_fill_forward")
    lib = _lib()
    dev = values.device
    n = values.shape[0]
    if values.dtype != torch.int32 or seg_start.dtype != torch.bool \
            or seg_start.device != dev or seg_start.shape[0] != n:
        raise TypeError(f"seg_fill_forward: needs int32 values and bool starts of one "
                        f"length on one device, got {values.dtype}/{seg_start.dtype}")
    values = values.contiguous()
    starts = seg_start.contiguous().view(torch.uint8)
    nb = max(1, (n + _SCAN_BLOCK - 1) // _SCAN_BLOCK)
    agg_v = torch.empty(nb, dtype=torch.int32, device=dev)
    carry_v = torch.empty(nb, dtype=torch.int32, device=dev)
    agg_s = torch.empty(nb, dtype=torch.uint8, device=dev)
    carry_s = torch.empty(nb, dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    native.check(lib.qk_seg_fill_forward(
        values.data_ptr(), starts.data_ptr(), n, agg_v.data_ptr(), agg_s.data_ptr(),
        carry_v.data_ptr(), carry_s.data_ptr(), out.data_ptr(), native.stream_ptr(dev)),
        "qk_seg_fill_forward")
    FILL_FORWARD_LAUNCHES += 1
    return out


def seg_fill_forward(values: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """K19: segmented running max of int32 ``values`` (the reference's
    ``_seg_fill_forward``).  CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    n = values.shape[0]
    devprof.on_dispatch(("K19", values.device.type, n), lambda: (0.0, float(9 * n), float(4 * n)))
    if values.device.type == "cpu":
        return _seg_fill_forward_plain(values, seg_start)
    return _seg_fill_forward_cuda(values, seg_start)


# ---------------------------------------------------------------------------
# K18: the sorted-quote probe
# ---------------------------------------------------------------------------


def _lex_lt_eq(a, b):
    """Elementwise lexicographic (a < b, a == b) over limb tuples."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt, eq


def _ss_sort_quotes(ops: Sequence[torch.Tensor], valid: torch.Tensor):
    """Sort the quote side once by (validity, key limbs..., time): returns
    (sorted ops, perm int32, n_valid int64 device scalar).  Invalid rows
    sort last; ties keep row order, so among equal (key, time) quotes the
    sorted order is the original order, the tie-break both directions rely
    on (the reference's ``_ss_sort_quotes``; stable torch sorts, T)."""
    perm = kernels.lexsort_perm([(~valid).to(torch.int32), *ops])
    sorted_ops = tuple(o[perm].contiguous() for o in ops)
    return sorted_ops, perm.to(torch.int32), valid.sum(dtype=torch.int64)


class KeyRuns(NamedTuple):
    """The run table of quotes sorted by ``_ss_sort_quotes``: one run per
    distinct key tuple inside the valid prefix.  ``keys`` holds each run's
    key limbs (R rows each); run r is the sorted rows [bounds[r],
    bounds[r + 1]) of ``bounds`` (int32, R + 1 entries), and bounds[R] is
    the number of valid quotes."""

    keys: Tuple[torch.Tensor, ...]
    bounds: torch.Tensor

    @property
    def starts(self) -> torch.Tensor:
        return self.bounds[:-1]

    @property
    def ends(self) -> torch.Tensor:
        return self.bounds[1:]


def _ss_key_runs(sorted_ops: Sequence[torch.Tensor], n_valid: torch.Tensor,
                 nkey: int) -> KeyRuns:
    """K18's run table over the first ``nkey`` limbs of quotes sorted by
    ``_ss_sort_quotes`` (T: a compare of neighbours, one ``nonzero``,
    gathers).  A run starts at row 0 and wherever a key limb differs from
    the row before under ``!=`` (a NaN limb starts a run of its own, -0.0
    continues a run of +0.0), inside the valid prefix.  With no key limb
    the valid prefix is one run.  The ``nonzero`` reads the run count to
    the host: one read per quote buffer (``_ss_quote_sorted`` caches the
    table beside the sort), never one per flush."""
    n_valid = n_valid.reshape(1).to(torch.int32)
    dev = n_valid.device
    if nkey == 0:
        return KeyRuns((), torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), n_valid]))
    keys = tuple(sorted_ops[:nkey])
    nq = keys[0].shape[0]
    start = torch.zeros(nq, dtype=torch.bool, device=dev)
    start[0] = True
    for k in keys:
        start[1:] |= k[1:] != k[:-1]
    start &= torch.arange(nq, device=dev) < n_valid
    rows = torch.nonzero(start).flatten()
    return KeyRuns(tuple(k[rows] for k in keys), torch.cat([rows.to(torch.int32), n_valid]))


def _asof_probe_plain(sorted_ops, perm, n_valid, probe_ops, probe_valid, upper: bool,
                      nkey: int):
    """Plain version of K18: a vectorised lexicographic binary search, one
    gather per limb per halving (the reference's ``_ss_probe``).  Returns
    (original quote row int32, matched)."""
    p = probe_valid.shape[0]
    nq = perm.shape[0]
    dev = probe_valid.device
    lo = torch.zeros(p, dtype=torch.int64, device=dev)
    hi = n_valid.to(torch.int64).expand(p).clone()
    for _ in range(max(1, nq.bit_length()) + 1):
        mid = (lo + hi) >> 1
        midc = torch.clamp(mid, 0, nq - 1)
        lt, eq = _lex_lt_eq(tuple(l[midc] for l in sorted_ops), probe_ops)
        cond = (lt | eq) if upper else lt
        go = lo < hi
        lo = torch.where(go & cond, mid + 1, lo)
        hi = torch.where(go & ~cond, mid, hi)
    pos = lo - 1 if upper else lo
    in_range = (pos >= 0) & (pos < n_valid)
    cpos = torch.clamp(pos, 0, nq - 1)
    keq = torch.ones(p, dtype=torch.bool, device=dev)
    for s, q in zip(sorted_ops[:nkey], probe_ops[:nkey]):
        keq = keq & (s[cpos] == q)
    matched = probe_valid & in_range & keq
    idx = torch.clamp(perm[cpos].long(), 0, nq - 1).to(torch.int32)
    return idx, matched


def _asof_probe_cuda(sorted_ops, perm, n_valid, probe_ops, probe_valid, upper: bool,
                     nkey: int, runs: Optional[KeyRuns]):
    global ASOF_PROBE_LAUNCHES, ASOF_PROBE_DISPATCH_LAUNCHES
    _require_cuda(probe_valid, "asof_probe")
    if runs is None:
        raise ValueError("asof_probe: the CUDA route takes the quotes' run table "
                         "(_ss_key_runs)")
    lib = _lib()
    dev = probe_valid.device
    p = probe_valid.shape[0]
    nq = perm.shape[0]
    if not 1 <= len(sorted_ops) <= 16 or len(probe_ops) != len(sorted_ops) \
            or nkey != len(sorted_ops) - 1 or len(runs.keys) != nkey:
        raise ValueError("asof_probe: 1 to 16 limbs, the key limbs then the time limb, and "
                         "the run table of the key limbs")
    if nq >= 1 << 31 or p >= 1 << 31:
        raise ValueError("asof_probe: 32-bit positions take fewer than 2^31 quotes and "
                         "probe rows")
    probe_ops = [l.contiguous() for l in probe_ops]
    run_keys = [k.contiguous() for k in runs.keys]
    for s, l in zip(sorted_ops, probe_ops):
        if (s.dtype not in _LIMB_DT or l.dtype != s.dtype or s.device != dev
                or l.device != dev or l.shape[0] != p or s.shape[0] != nq):
            raise TypeError(f"asof_probe: unsupported limbs {s.dtype}/{l.dtype} "
                            f"on {s.device}/{l.device}")
    bounds = runs.bounds
    if (bounds.dtype != torch.int32 or bounds.device != dev
            or any(k.dtype != s.dtype or k.device != dev or k.shape[0] != bounds.shape[0] - 1
                   for k, s in zip(run_keys, sorted_ops))):
        raise TypeError("asof_probe: the run table does not match the sorted limbs")
    quote_idx = torch.empty(p, dtype=torch.int32, device=dev)
    matched = torch.empty(p, dtype=torch.bool, device=dev)
    typed = ctypes.c_int(0)

    def arg(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t

    # the contiguous copies live in locals until the launch has been issued
    bounds = bounds.contiguous()
    times = arg(sorted_ops[nkey]).contiguous()
    perm = perm.contiguous()
    pv8 = probe_valid.contiguous().view(torch.uint8)
    native.check(lib.qk_asof_probe(
        native.ptr_array([arg(k).data_ptr() for k in run_keys]),
        native.ptr_array([arg(l).data_ptr() for l in probe_ops]),
        native.int_array([_LIMB_DT[s.dtype] for s in sorted_ops]), nkey, 1 if upper else 0,
        bounds.data_ptr(), bounds.shape[0] - 1, times.data_ptr(), perm.data_ptr(), nq,
        pv8.data_ptr(), p, quote_idx.data_ptr(),
        matched.view(torch.uint8).data_ptr(), ctypes.byref(typed), native.stream_ptr(dev)),
        "qk_asof_probe")
    ASOF_PROBE_LAUNCHES += 1
    if not typed.value:
        ASOF_PROBE_DISPATCH_LAUNCHES += 1
    return quote_idx, matched


def asof_probe(sorted_ops, perm, n_valid, probe_ops, probe_valid, upper: bool, nkey: int,
               runs: Optional[KeyRuns] = None):
    """K18: per probe row, the quote the as-of join takes from quotes sorted
    by ``_ss_sort_quotes``: ``upper`` (backward) the last with key == k and
    time <= t, else (forward) the first with key == k and time >= t.  The
    first ``nkey`` limbs are keys, the last is time; probe limbs carry the
    sorted limbs' dtypes.  Returns (original quote row int32, matched).
    CUDA tensors launch the kernel, which takes the quotes' run table
    ``runs`` (``_ss_key_runs``); CPU tensors take the plain version, which
    does not need it."""
    p = probe_valid.shape[0]
    devprof.on_dispatch(
        ("K18", probe_valid.device.type, p, perm.shape[0], tuple(str(o.dtype) for o in probe_ops), upper, nkey),
        lambda: (0.0, float(devprof.nbytes(*sorted_ops, perm, *probe_ops, probe_valid) + 5 * p),
                 float(5 * p)))
    if probe_valid.device.type == "cpu":
        return _asof_probe_plain(sorted_ops, perm, n_valid, probe_ops, probe_valid, upper,
                                 nkey)
    return _asof_probe_cuda(sorted_ops, perm, n_valid, probe_ops, probe_valid, upper, nkey,
                            runs)


def _ss_quote_sorted(quotes: DeviceBatch, right_on: str, right_by: Sequence[str],
                     time_dtype: torch.dtype):
    """(sorted ops, perm, n_valid, nkey, run table) for a quote batch,
    cached on the batch: the streaming executor probes the same buffer on
    every flush until new quotes concatenate into a fresh batch, so the
    sort and the run table's one host read are paid once per buffer.  Both
    directions share the entry.  The quote time is cast to the trade side's dtype before the
    sort, so mixed-dtype comparisons and the order within ties are those of
    the sort strategy."""
    cache = getattr(quotes, "_asof_ss_cache", None)
    if cache is None:
        cache = quotes._asof_ss_cache = {}
    key = (tuple(right_by), right_on, str(time_dtype))
    hit = cache.get(key)
    if hit is None:
        ql = key_limbs(quotes, list(right_by)) if right_by else []
        ops = tuple(ql) + (quotes.columns[right_on].data.to(time_dtype),)
        sorted_ops, perm, n_valid = _ss_sort_quotes(ops, quotes.valid)
        runs = _ss_key_runs(sorted_ops, n_valid, len(ql))
        hit = cache[key] = (sorted_ops, perm, n_valid, len(ql), runs)
    return hit


def _asof_match_searchsorted(trades: DeviceBatch, quotes: DeviceBatch, left_on: str,
                             right_on: str, left_by: Sequence[str],
                             right_by: Sequence[str], direction: str):
    """(quote row, matched) aligned to trade rows, on the batches' device."""
    tt = trades.columns[left_on].data
    sorted_ops, perm, n_valid, nkey, runs = _ss_quote_sorted(quotes, right_on,
                                                             list(right_by), tt.dtype)
    lt = key_limbs(trades, list(left_by)) if left_by else []
    if len(lt) != nkey:
        raise ValueError("asof by-key column types must match")
    probe_ops = [l.to(s.dtype) for l, s in zip(list(lt) + [tt], sorted_ops)]
    return asof_probe(sorted_ops, perm, n_valid, probe_ops, trades.valid,
                      direction == "backward", nkey, runs)


# ---------------------------------------------------------------------------
# the sort strategy: dense rank, one sort, K19
# ---------------------------------------------------------------------------


def _asof_match(limbs: Sequence[torch.Tensor], times: Sequence[torch.Tensor],
                is_trade: torch.Tensor, valid: torch.Tensor, t: int,
                forward_ties: bool = False):
    """Per trade row, (concat row of its quote, matched), over the
    concatenation [trades | quotes] of key limbs, times, side and validity
    (the reference's ``_asof_match``).  Rows sort by (validity, key rank,
    time, side, tie): quotes before trades at equal times, so backward asof
    includes same-time quotes.  The fill-forward takes the quote at the
    largest sorted position, so the tie key orders equal quotes by row:
    ascending for backward (the last tied quote wins) and descending with
    ``forward_ties``, on the caller's negated times (the first wins)."""
    n = valid.shape[0]
    dev = valid.device
    ranks, _ = kernels.dense_rank(limbs, valid)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    side = is_trade.to(torch.int32)
    tie = -iota if forward_ties else iota
    perm = kernels.lexsort_perm([(~valid).to(torch.int32), ranks, *times, side, tie])
    valid_s = valid[perm]
    ranks_s = ranks[perm]
    side_s = side[perm]
    seg_start = (ranks_s != torch.roll(ranks_s, 1)) | (iota == 0)
    quote_pos = torch.where(valid_s & (side_s == 0), iota, torch.full_like(iota, -1))
    last_quote_pos = seg_fill_forward(quote_pos, seg_start)
    quote_orig = perm[torch.clamp(last_quote_pos, 0, n - 1).long()].to(torch.int32)
    matched_s = valid_s & (side_s == 1) & (last_quote_pos >= 0)
    match_orig = torch.zeros(n, dtype=torch.int32, device=dev)
    match_orig[perm] = quote_orig
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    matched[perm] = matched_s
    return match_orig[:t], matched[:t]


def _asof_match_sort(trades: DeviceBatch, quotes: DeviceBatch, left_on: str,
                     right_on: str, left_by: Sequence[str], right_by: Sequence[str],
                     direction: str):
    t, q = trades.padded_len, quotes.padded_len
    dev = trades.device
    lt = key_limbs(trades, list(left_by)) if left_by else []
    lq = key_limbs(quotes, list(right_by)) if right_by else []
    if len(lt) != len(lq):
        raise ValueError("asof by-key column types must match")
    if left_by:
        limbs = [torch.cat([a, b.to(a.dtype)]) for a, b in zip(lt, lq)]
    else:
        limbs = [torch.zeros(t + q, dtype=torch.int32, device=dev)]
    t_time = trades.columns[left_on].data
    q_time = quotes.columns[right_on].data.to(t_time.dtype)
    if direction == "forward":
        t_time, q_time = -t_time, -q_time
    is_trade = torch.cat([torch.ones(t, dtype=torch.bool, device=dev),
                          torch.zeros(q, dtype=torch.bool, device=dev)])
    valid = torch.cat([trades.valid, quotes.valid])
    match_orig, matched = _asof_match(limbs, [torch.cat([t_time, q_time])], is_trade, valid,
                                      t, forward_ties=(direction == "forward"))
    return torch.clamp(match_orig - t, 0, q - 1), matched


def asof_join(trades: DeviceBatch, quotes: DeviceBatch, left_on: str, right_on: str,
              left_by: Sequence[str], right_by: Sequence[str], payload: Sequence[str],
              direction: str = "backward", strategy: Optional[str] = None) -> DeviceBatch:
    """Probe-aligned as-of join: each trade row gains the payload of its
    quote (per key) and ``__asof_matched__``.  Unmatched trades keep null
    payload; no mask is applied (the executor drops them unless asked to
    keep them).  ``strategy`` forces "sort" or "searchsorted"; None
    consults the strategy matrix."""
    if direction not in ("backward", "forward"):
        raise ValueError(direction)
    pick = strategy or kstrategy.choice("asof")
    if pick == "host":
        raise NotImplementedError(
            "asof=host (the reference's native CPU merge) is not in quokka_tpu_torch: "
            "ROADMAP Queue 1, \"The rest of the time-series tier\"; use asof=searchsorted "
            "or asof=sort")
    match = _asof_match_searchsorted if pick == "searchsorted" else _asof_match_sort
    quote_idx, matched = match(trades, quotes, left_on, right_on, left_by, right_by,
                               direction)
    kstrategy.note_used("asof", pick)
    cols = dict(trades.columns)
    idx = quote_idx.long()
    for name in payload:
        cols[name] = with_nulls(quotes.columns[name].take(idx), ~matched)
    cols["__asof_matched__"] = NumCol(matched, "b")
    return DeviceBatch(cols, trades.valid, trades.nrows, trades.sorted_by)
