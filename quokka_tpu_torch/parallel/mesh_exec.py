"""Mesh execution: a logical plan run over the shards of a mesh (PyTorch port
of ``quokka_tpu/parallel/mesh_exec.py``).

Channels are mesh shards.  On one card (``parallel/mesh.py``) a shard is a
row range of one global batch:

- a source lands as ONE global batch (one dictionary per string column,
  so codes compare across shards), split into ``n_shards`` row ranges;
- elementwise nodes ignore shard boundaries and run once over the whole
  batch, through the port's generated kernels: K1 for a predicate, K16 for
  a map or an aggregate's pre-expressions;
- group-bys, joins, as-of joins, windows and shifts run as per-shard local
  work with the same kernels the engine uses (``kernels.sorted_groupby``,
  ``join._pk_match``, ``asof._asof_match``, the sliding-window kernels),
  with a key shuffle (K24, ``mesh.collective_hash_shuffle``) between them;
- small root-level work (final aggregates with having / order / limit,
  window finals, top-k, a single-input stateful tail) finishes on the
  materialized result through the real executors.

Every shuffle multiplies the rows per shard by the shard count (the
reference's static design: P frames of N rows), so a join's output is
compacted back to its live rows (``_compact_reshard``).  The host reads
are the reference's own: the many-to-many join's overflow count, the live
count of ``_compact_reshard`` and ``_materialize``'s round trip.

Plans with nodes outside this set raise ``MeshUnsupported`` and the caller
falls back to the engine.  The reference's rebase of wide times onto int32
(``_rebase_time``) has no counterpart: the port's times are int64 and are
taken as they are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from quokka_tpu_torch import config, logical
from quokka_tpu_torch.ops import asof as asof_ops
from quokka_tpu_torch.ops import bridge, kernels
from quokka_tpu_torch.ops import join as join_ops
from quokka_tpu_torch.ops import strategy as kstrategy
from quokka_tpu_torch.ops.batch import (
    DeviceBatch,
    NumCol,
    StrCol,
    VecCol,
    int_sentinel,
    key_limbs,
    with_nulls,
)
from quokka_tpu_torch.parallel.mesh import Mesh, collective_hash_shuffle, shard_map


class MeshUnsupported(Exception):
    """A plan shape the mesh does not cover: the caller falls back."""


class _EmptyResult(Exception):
    """A root stateful operator legitimately produced no rows: the collect
    is empty, not a fallback (an engine re-run would repeat the executor's
    side effects)."""


MM_CAPACITY_FACTOR = 4  # per-shard output cap of a many-to-many join = factor x probe rows


# ---------------------------------------------------------------------------
# sharding, flattening and elementwise helpers
# ---------------------------------------------------------------------------


def _shard_batch(batch: DeviceBatch, mesh: Mesh) -> DeviceBatch:
    """A batch as ``n_shards`` row ranges: on one device, a check that its
    padded length divides into the shards (padded lengths are powers of
    two), and nothing to move."""
    if batch.padded_len % mesh.n_shards:
        raise MeshUnsupported(f"padded len {batch.padded_len} not divisible by "
                              f"{mesh.n_shards}")
    return batch


def _materialize(batch: DeviceBatch) -> DeviceBatch:
    """The live rows of a sharded batch as one compact batch (a host round
    trip through the narrowed wire, as the reference gathers shards)."""
    return bridge.reland(batch)


def _col_value_arrays(c) -> List[torch.Tensor]:
    if isinstance(c, StrCol):
        return [c.codes]
    if isinstance(c, VecCol):
        raise MeshUnsupported("vector column as shuffle payload")
    return [c.data]


def _rebuild_col(template, arrays: Sequence[torch.Tensor]):
    if isinstance(template, StrCol):
        return StrCol(arrays[0], template.dictionary)
    return NumCol(arrays[0], template.kind, template.unit)


def _flatten_cols(batch: DeviceBatch, names: Sequence[str]):
    """The columns' arrays in one list and each name's (name, lo, hi) slice
    of it."""
    arrays: List[torch.Tensor] = []
    slices: List[Tuple[str, int, int]] = []
    for n in names:
        a = _col_value_arrays(batch.columns[n])
        slices.append((n, len(arrays), len(arrays) + len(a)))
        arrays.extend(a)
    return arrays, slices


def _agg_col(arr: torch.Tensor) -> NumCol:
    return NumCol(arr, "f" if arr.is_floating_point() else "i")


def _agg_values(batch: DeviceBatch, partials) -> List[torch.Tensor]:
    return [batch.columns[c].data if c is not None
            else torch.zeros(batch.padded_len, dtype=torch.int32, device=batch.device)
            for (_, _, c) in partials]


def _filter(batch: DeviceBatch, predicate) -> DeviceBatch:
    """A predicate over the whole sharded batch: K1."""
    from quokka_tpu_torch.ops.fuse import FusedPredicate

    return FusedPredicate(predicate)(batch)


def _with_exprs(batch: DeviceBatch, exprs) -> DeviceBatch:
    """Map expressions over the whole batch: one K16 pass."""
    from quokka_tpu_torch.ops.stagefuse import FusedElementwise

    exprs = list(exprs)
    if not exprs:
        return batch
    return FusedElementwise([("map", exprs)])(batch)


def _iota(n: int, device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# mesh group-by: local partial -> K24 shuffle -> local final
# ---------------------------------------------------------------------------


def _grouped(nlimb: int, ncarry: int, ops):
    """Per-shard step: the sort group-by of the key limbs over the
    value arrays; returns the group limbs, carried columns and outputs."""

    def step(*arrs):
        lb = tuple(arrs[:nlimb])
        ca = arrs[nlimb:nlimb + ncarry]
        va = arrs[nlimb + ncarry:-1]
        valid = arrs[-1]
        outs, _, rep, num = kernels.sorted_groupby(lb, va, ops, valid)
        rep = rep.long()
        gvalid = _iota(valid.shape[0], valid.device) < num
        return tuple(l[rep] for l in lb) + tuple(c[rep] for c in ca) + tuple(outs) + (gvalid,)

    return step


def mesh_groupby(mesh: Mesh, batch: DeviceBatch, keys: List[str],
                 partials: List[Tuple[str, str, Optional[str]]],
                 recombine_ops: List[str]) -> DeviceBatch:
    """partials: (out_name, op, input column or None).  Returns a sharded
    batch of unique groups carrying the key columns and the partial
    outputs, recombined across shards."""
    kstrategy.note_used("groupby", "sort")  # the mesh groups by the sort kernel
    limbs = key_limbs(batch, keys)  # hash limbs: consistent across dictionaries
    nlimb = len(limbs)
    carried, slices = _flatten_cols(batch, keys)
    ncarry = len(carried)
    vals = _agg_values(batch, partials)
    local = shard_map(_grouped(nlimb, ncarry, tuple(op for _, op, _ in partials)), mesh)(
        *limbs, *carried, *vals, batch.valid)
    shuf, svalid = collective_hash_shuffle(local[:-1], local[-1], tuple(range(nlimb)), mesh)
    fin = shard_map(_grouped(nlimb, ncarry, tuple(recombine_ops)), mesh)(*shuf, svalid)
    fcarry = fin[nlimb:nlimb + ncarry]
    fvals = fin[nlimb + ncarry:-1]
    cols = {name: _rebuild_col(batch.columns[name], fcarry[lo:hi]) for name, lo, hi in slices}
    for (pname, _, _), arr in zip(partials, fvals):
        cols[pname] = _agg_col(arr)
    return DeviceBatch(cols, fin[-1], None, None)


# ---------------------------------------------------------------------------
# mesh join: both sides shuffled -> per-shard rank join
# ---------------------------------------------------------------------------


def mesh_join(mesh: Mesh, probe: DeviceBatch, build: DeviceBatch, left_on: List[str],
              right_on: List[str], how: str, payload: List[str],
              unique: bool = True) -> DeviceBatch:
    """Join over the mesh: both sides key-shuffled (K24), then the engine's
    rank joins per shard.  ``unique`` (and every semi / anti join) takes the
    probe-aligned PK match (``join._pk_match``: dense rank, K14); otherwise
    the many-to-many plan and K13 with a static per-shard output capacity,
    whose overflow raises MeshUnsupported so the caller falls back (the
    reference's shapes inside shard_map cannot depend on the data)."""
    kstrategy.note_used("join_build", "sort")  # mesh joins are rank-based
    pl = key_limbs(probe, left_on)
    bl = key_limbs(build, right_on)
    if len(pl) != len(bl):
        raise MeshUnsupported("join key column types differ")
    nlimb = len(pl)
    p_carry, p_slices = _flatten_cols(probe, probe.names)
    b_carry, b_slices = _flatten_cols(build, payload)
    npc, nbc = len(p_carry), len(b_carry)
    keys = tuple(range(nlimb))
    ps, pv = collective_hash_shuffle(pl + p_carry + [join_ops._nonnull_valid(probe, left_on)],
                                     probe.valid, keys, mesh)
    bs, bv = collective_hash_shuffle(bl + b_carry + [join_ops._nonnull_valid(build, right_on)],
                                     build.valid, keys, mesh)
    mm = not (unique or how in ("semi", "anti"))

    def step(*arrs):
        i = 0
        spl = arrs[i:i + nlimb]; i += nlimb  # noqa: E702
        spc = arrs[i:i + npc]; i += npc  # noqa: E702
        spok, pv_s = arrs[i], arrs[i + 1]; i += 2  # noqa: E702
        sbl = arrs[i:i + nlimb]; i += nlimb  # noqa: E702
        sbc = arrs[i:i + nbc]; i += nbc  # noqa: E702
        sbok, bv_s = arrs[i], arrs[i + 1]
        p = pv_s.shape[0]
        dev = pv_s.device
        limbs = [torch.cat([a, b.to(a.dtype)]) for a, b in zip(spl, sbl)]
        valid = torch.cat([pv_s & spok, bv_s & sbok])
        if not mm:
            # semi / anti need only per-probe match existence: the PK match
            # is right for repeated build keys too
            build_idx, matched = join_ops._pk_match(limbs, valid, p)
            idx = build_idx.long()
            return (tuple(spc) + tuple(c[idx] for c in sbc)
                    + (pv_s, matched, torch.zeros(1, dtype=torch.int64, device=dev)))
        mc, total, offsets, bps, rp, unmatched = join_ops.mm_plan_for(
            limbs, valid, p, how, probe_valid=pv_s)
        cap = p * MM_CAPACITY_FACTOR
        overflow = torch.clamp(total - cap, min=0).reshape(1)
        # a left join's output rows with no real build match: the plan's
        # per-probe flags gathered by K13 (the reference's mm_unmatched)
        probe_idx, build_idx, out_valid, unm = join_ops.mm_expand(
            mc, offsets, bps, rp, torch.clamp(total, max=cap), cap, unmatched)
        pidx, bidx = probe_idx.long(), build_idx.long()
        matched = ~unm if how == "left" else torch.ones(cap, dtype=torch.bool, device=dev)
        return (tuple(c[pidx] for c in spc) + tuple(c[bidx] for c in sbc)
                + (out_valid, matched, overflow))

    outs = shard_map(step, mesh)(*ps, pv, *bs, bv)
    spc, pay = outs[:npc], outs[npc:npc + nbc]
    pvalid, matched, overflow = outs[-3], outs[-2], outs[-1]
    if mm and int(overflow.max()) > 0:
        raise MeshUnsupported(
            "mm join overflowed the static per-shard capacity "
            f"({MM_CAPACITY_FACTOR}x local probe rows) — engine fallback")
    cols = {name: _rebuild_col(probe.columns[name], spc[lo:hi]) for name, lo, hi in p_slices}
    if how == "semi":
        return DeviceBatch(cols, pvalid & matched, None, None)
    if how == "anti":
        return DeviceBatch(cols, pvalid & ~matched, None, None)
    if how not in ("inner", "left"):
        raise MeshUnsupported(f"join how={how}")
    for name, lo, hi in b_slices:
        col = _rebuild_col(build.columns[name], pay[lo:hi])
        cols[name] = with_nulls(col, ~matched) if how == "left" else col
    if how == "inner" and not mm:
        return DeviceBatch(cols, pvalid & matched, None, None)
    return DeviceBatch(cols, pvalid, None, None)


# ---------------------------------------------------------------------------
# mesh as-of join: both sides shuffled by the by-keys -> per-shard sort + K19
# ---------------------------------------------------------------------------


def mesh_asof(mesh: Mesh, trades: DeviceBatch, quotes: DeviceBatch, left_on: str,
              right_on: str, left_by: List[str], right_by: List[str], payload: List[str],
              direction: str) -> DeviceBatch:
    """As-of join over the mesh: both sides key-shuffled by their by-keys
    (each key's rows land whole on one shard), then the engine's sort
    strategy per shard (``asof._asof_match``: dense rank, one sort, K19).
    Unmatched trades are dropped, as the streaming executor does by
    default; each shard's output is ascending in trade time, invalid rows
    last."""
    kstrategy.note_used("asof", "sort")
    if not left_by:
        raise MeshUnsupported("by-less asof join on mesh (no shuffle key)")
    tl = key_limbs(trades, left_by)
    ql = key_limbs(quotes, right_by)
    if len(tl) != len(ql):
        raise MeshUnsupported("asof by-key column types differ")
    nlimb = len(tl)
    t_time = trades.columns[left_on].data
    q_time = quotes.columns[right_on].data.to(t_time.dtype)
    forward = direction == "forward"
    if forward:
        t_time, q_time = -t_time, -q_time
    t_carry, t_slices = _flatten_cols(trades, trades.names)
    q_carry, q_slices = _flatten_cols(quotes, payload)
    ntc, nqc = len(t_carry), len(q_carry)
    # the trade time's position among the carried arrays: each shard's
    # output is re-sorted on the raw (not negated) times
    t_time_at = next(lo for (name, lo, _) in t_slices if name == left_on)
    keys = tuple(range(nlimb))
    ts, tv = collective_hash_shuffle(tl + [t_time] + t_carry, trades.valid, keys, mesh)
    qs, qv = collective_hash_shuffle(ql + [q_time] + q_carry, quotes.valid, keys, mesh)

    def step(*arrs):
        i = 0
        stl = arrs[i:i + nlimb]; i += nlimb  # noqa: E702
        stt = arrs[i]; i += 1  # noqa: E702
        stc = arrs[i:i + ntc]; i += ntc  # noqa: E702
        tv_s = arrs[i]; i += 1  # noqa: E702
        sql = arrs[i:i + nlimb]; i += nlimb  # noqa: E702
        sqt = arrs[i]; i += 1  # noqa: E702
        sqc = arrs[i:i + nqc]; i += nqc  # noqa: E702
        qv_s = arrs[i]
        p, q = tv_s.shape[0], qv_s.shape[0]
        dev = tv_s.device
        limbs = [torch.cat([a, b.to(a.dtype)]) for a, b in zip(stl, sql)]
        is_trade = torch.cat([torch.ones(p, dtype=torch.bool, device=dev),
                              torch.zeros(q, dtype=torch.bool, device=dev)])
        match_orig, matched = asof_ops._asof_match(
            limbs, [torch.cat([stt, sqt.to(stt.dtype)])], is_trade,
            torch.cat([tv_s, qv_s]), p, forward_ties=forward)
        quote_idx = torch.clamp(match_orig.long() - p, 0, q - 1)
        ovalid = tv_s & matched
        perm = kernels.lexsort_perm([(~ovalid).to(torch.int32), stc[t_time_at]])
        out = tuple(stc) + tuple(c[quote_idx] for c in sqc)
        return tuple(c[perm] for c in out) + (ovalid[perm],)

    outs = shard_map(step, mesh)(*ts, tv, *qs, qv)
    cols = {name: _rebuild_col(trades.columns[name], outs[lo:hi]) for name, lo, hi in t_slices}
    for name, lo, hi in q_slices:
        cols[name] = _rebuild_col(quotes.columns[name], outs[ntc + lo:ntc + hi])
    return DeviceBatch(cols, outs[-1], None, None)


# ---------------------------------------------------------------------------
# mesh windows
# ---------------------------------------------------------------------------


def mesh_window_agg(mesh: Mesh, batch: DeviceBatch, by: List[str], time_data: torch.Tensor,
                    size: int, hop: int, partials: List[Tuple[str, str, Optional[str]]],
                    recombine_ops: List[str]) -> DeviceBatch:
    """Tumbling / hopping windows over the mesh: in a bounded batch a time
    window is a computed group key.  Each shard replicates its rows onto
    the size // hop windows covering them (the engine's mask), partially
    aggregates by (by..., window id), the partials are key-shuffled (K24)
    and each shard aggregates them finally: the mesh group-by's
    discipline.  Returns groups carrying the by-columns, "__wid" and the
    partial outputs."""
    k = max(1, size // hop)
    limbs = key_limbs(batch, by) if by else []
    nlimb = len(limbs)
    carried, slices = _flatten_cols(batch, by)
    ncarry = len(carried)
    vals = _agg_values(batch, partials)
    pops = tuple(op for _, op, _ in partials)

    def replicate(*arrs):
        lb = arrs[:nlimb]
        t = arrs[nlimb]
        ca = arrs[nlimb + 1:nlimb + 1 + ncarry]
        va = arrs[nlimb + 1 + ncarry:-1]
        valid = arrs[-1]
        base = torch.div(t, hop, rounding_mode="floor")
        wids, oks = [], []
        for j in range(k):
            wid = base - j
            start = wid * hop
            wids.append(wid)
            oks.append(valid & (wid >= 0) & (t < start + size) & (t >= start))
        rep = lambda xs: tuple(torch.cat([x] * k) for x in xs)  # noqa: E731
        return _grouped(nlimb + 1, ncarry, pops)(
            *(rep(lb) + (torch.cat(wids),)), *rep(ca), *rep(va), torch.cat(oks))

    local = shard_map(replicate, mesh)(*limbs, time_data, *carried, *vals, batch.valid)
    shuf, svalid = collective_hash_shuffle(local[:-1], local[-1], tuple(range(nlimb + 1)),
                                           mesh)
    fin = shard_map(_grouped(nlimb + 1, ncarry, tuple(recombine_ops)), mesh)(*shuf, svalid)
    fcarry = fin[nlimb + 1:nlimb + 1 + ncarry]
    cols = {name: _rebuild_col(batch.columns[name], fcarry[lo:hi]) for name, lo, hi in slices}
    cols["__wid"] = NumCol(fin[nlimb], "i")
    for (pname, _, _), arr in zip(partials, fin[nlimb + 1 + ncarry:-1]):
        cols[pname] = _agg_col(arr)
    return DeviceBatch(cols, fin[-1], None, None)


def _sort_segments(klimbs: Sequence[torch.Tensor], tlimbs: Sequence[torch.Tensor],
                   valid: torch.Tensor):
    """The per-shard preamble of every per-key ordered mesh operator
    (session, sliding, shift): a stable sort by (validity, key limbs, time
    limbs) and the segment-start flags.  The flags include the change from
    valid rows to padding: the shuffle zero-fills padding, so a last key
    whose limbs are all zero would otherwise run on into the padding rows.
    Returns (perm, valid_s, klimbs_s, tlimbs_s, seg_flag)."""
    inv = (~valid).to(torch.int32)
    perm = kernels.lexsort_perm([inv, *klimbs, *tlimbs])
    n = valid.shape[0]
    iota = _iota(n, valid.device)
    inv_s = inv[perm]
    klimbs_s = tuple(l[perm] for l in klimbs)
    changed = iota == 0
    for l in (inv_s,) + klimbs_s:
        changed = changed | (l != torch.roll(l, 1))
    return perm, inv_s == 0, klimbs_s, tuple(l[perm] for l in tlimbs), changed


def _seg_start(seg_flag: torch.Tensor) -> torch.Tensor:
    """Each row's segment start (K19)."""
    iota = torch.arange(seg_flag.shape[0], dtype=torch.int32, device=seg_flag.device)
    return asof_ops.seg_fill_forward(torch.where(seg_flag, iota, torch.full_like(iota, -1)),
                                     seg_flag)


def mesh_session_window(mesh: Mesh, batch: DeviceBatch, by: List[str],
                        time_data: torch.Tensor, timeout: int,
                        partials: List[Tuple[str, str, Optional[str]]]) -> DeviceBatch:
    """Gap-based session windows over the mesh: rows key-shuffle (K24), each
    shard sorts its whole key groups by time, starts a session where the gap
    exceeds the timeout (the engine's rule) and aggregates per (key,
    session id); sessions are whole per shard, so no second shuffle.
    Returns groups carrying the by-columns, "__first_t" / "__last_t" and the
    partial outputs."""
    limbs = key_limbs(batch, by) if by else []
    nlimb = len(limbs)
    carried, slices = _flatten_cols(batch, by)
    ncarry = len(carried)
    vals = _agg_values(batch, partials)
    pops = tuple(op for _, op, _ in partials) + ("min", "max")
    shuf, svalid = collective_hash_shuffle(limbs + [time_data] + carried + vals, batch.valid,
                                           tuple(range(nlimb)), mesh)

    def step(*arrs):
        lb = arrs[:nlimb]
        t = arrs[nlimb]
        ca = arrs[nlimb + 1:nlimb + 1 + ncarry]
        va = arrs[nlimb + 1 + ncarry:-1]
        valid = arrs[-1]
        perm, valid_s, klimbs_s, (t_s,), seg_flag = _sort_segments(lb, (t,), valid)
        gap = t_s - torch.roll(t_s, 1)
        sess_id = torch.cumsum((seg_flag | (gap > timeout)).to(torch.int64), 0) - 1
        glimbs = klimbs_s + (sess_id,)
        va_s = tuple(a[perm] for a in va) + (t_s, t_s)
        ca_s = tuple(c[perm] for c in ca)
        outs, _, rep, num = kernels.sorted_groupby(glimbs, va_s, pops, valid_s)
        rep = rep.long()
        gvalid = _iota(valid_s.shape[0], valid_s.device) < num
        return tuple(c[rep] for c in ca_s) + tuple(outs) + (gvalid,)

    outs = shard_map(step, mesh)(*shuf, svalid)
    cols = {name: _rebuild_col(batch.columns[name], outs[lo:hi]) for name, lo, hi in slices}
    pouts = outs[ncarry:-1]
    for (pname, _, _), arr in zip(partials, pouts[:-2]):
        cols[pname] = _agg_col(arr)
    cols["__first_t"] = NumCol(pouts[-2], "i")
    cols["__last_t"] = NumCol(pouts[-1], "i")
    return DeviceBatch(cols, outs[-1], None, None)


def mesh_sliding_window(mesh: Mesh, batch: DeviceBatch, by: List[str],
                        time_data: torch.Tensor, size: int,
                        partials: List[Tuple[str, str, Optional[str]]]) -> DeviceBatch:
    """Per-event trailing windows [t - size, t] over the mesh: key-shuffle
    (K24), then per shard the engine's rolling kernels over whole key
    groups: segment starts (K19), window bounds (K20a), range min / max
    (K20b), prefix sums for sum and count.  Returns the per-event batch in
    per-shard key-major order with the partial outputs."""
    from quokka_tpu_torch.executors import ts_execs

    if not by:
        raise MeshUnsupported("by-less sliding window on mesh")
    for _, op, _ in partials:
        if op not in ("sum", "count", "min", "max"):
            raise MeshUnsupported(f"sliding window op {op!r} on mesh")
    limbs = key_limbs(batch, by)
    nlimb = len(limbs)
    carried, slices = _flatten_cols(batch, batch.names)
    ncarry = len(carried)
    # value columns are already carried: index them there (count: -1)
    val_idx = []
    for (_, op, tmp) in partials:
        if tmp is None:
            val_idx.append(-1)
            continue
        if isinstance(batch.columns[tmp], (StrCol, VecCol)):
            raise MeshUnsupported(f"sliding window over non-numeric column {tmp!r} on mesh")
        val_idx.append(next(lo for (n2, lo, _) in slices if n2 == tmp))
    shuf, svalid = collective_hash_shuffle(limbs + [time_data] + carried, batch.valid,
                                           tuple(range(nlimb)), mesh)

    def step(*arrs):
        lb = arrs[:nlimb]
        t_in = arrs[nlimb]
        ca = arrs[nlimb + 1:nlimb + 1 + ncarry]
        valid = arrs[-1]
        perm, valid_s, _, (t_s,), seg_flag = _sort_segments(lb, (t_in,), valid)
        p = valid_s.shape[0]
        iota = torch.arange(p, dtype=torch.int32, device=valid_s.device)
        seg_start = _seg_start(seg_flag)
        seg_end = iota + ts_execs._rows_from_segment_end(iota, seg_flag, p)
        left, right = ts_execs.window_bounds(t_s, seg_start, seg_end, size)
        outs = []
        for (_, op, _), j in zip(partials, val_idx):
            if op in ("min", "max"):
                x = ca[j][perm]
                fill = kernels.max_sentinel(x.dtype) if op == "min" \
                    else kernels.min_sentinel(x.dtype)
                x = torch.where(valid_s, x, torch.full((), fill, dtype=x.dtype, device=x.device))
                outs.append(ts_execs.range_minmax(x, left, right, op))
                continue
            if op == "count":
                x = valid_s.to(torch.float64)
            else:
                x = ca[j][perm]
                x = torch.where(valid_s, x, torch.zeros((), dtype=x.dtype, device=x.device))
            cs = torch.cumsum(x, 0)
            lft = left.long()
            before = torch.where(lft > 0, cs[torch.clamp(lft - 1, min=0)],
                                 torch.zeros((), dtype=cs.dtype, device=cs.device))
            outs.append(cs[right.long()] - before)
        return tuple(c[perm] for c in ca) + tuple(outs) + (valid_s,)

    outs = shard_map(step, mesh)(*shuf, svalid)
    cols = {name: _rebuild_col(batch.columns[name], outs[lo:hi]) for name, lo, hi in slices}
    for (pname, _, _), arr in zip(partials, outs[ncarry:-1]):
        cols[pname] = NumCol(arr, "f")
    return DeviceBatch(cols, outs[-1], None, None)


# ---------------------------------------------------------------------------
# mesh shift: key-shuffle -> per-shard sort + segment lag
# ---------------------------------------------------------------------------


def mesh_shift(mesh: Mesh, batch: DeviceBatch, by: List[str], time_col: str,
               columns: List[str], n_lag: int) -> DeviceBatch:
    """Per-key lag over the mesh: rows key-shuffle (K24), each shard sorts
    its whole key groups by (key, time) and takes the value n rows earlier
    within the key's segment (segment starts by K19).  Rows with no history
    get null (NaN for floats, the int sentinel otherwise); each shard's
    output is key-major."""
    if not by:
        raise MeshUnsupported("by-less shift on mesh (no shuffle key)")
    limbs = key_limbs(batch, by)
    nlimb = len(limbs)
    carried, slices = _flatten_cols(batch, batch.names)
    ncarry = len(carried)
    shift_idx, shift_float = [], []
    for c in columns:
        col = batch.columns[c]
        if isinstance(col, (StrCol, VecCol)):
            raise MeshUnsupported(f"shift of non-numeric column {c!r} on mesh")
        if col.kind == "b":
            raise MeshUnsupported(f"shift of bool column {c!r} on mesh")
        shift_idx.append(next(lo for (n2, lo, _) in slices if n2 == c))
        shift_float.append(col.data.is_floating_point())
    shuf, svalid = collective_hash_shuffle(
        limbs + [batch.columns[time_col].data] + carried, batch.valid, tuple(range(nlimb)), mesh)

    def step(*arrs):
        lb = arrs[:nlimb]
        t = arrs[nlimb]
        ca = arrs[nlimb + 1:nlimb + 1 + ncarry]
        valid = arrs[-1]
        perm, valid_s, _, _, seg_flag = _sort_segments(lb, (t,), valid)
        p = valid_s.shape[0]
        src = _iota(p, valid_s.device) - n_lag
        ok = src >= _seg_start(seg_flag).long()
        src = torch.clamp(src, 0, p - 1)
        out_ca = tuple(c[perm] for c in ca)
        shifted = []
        for j, is_f in zip(shift_idx, shift_float):
            v = out_ca[j][src]
            null = float("nan") if is_f else int_sentinel(v.dtype)
            shifted.append(torch.where(ok, v, torch.full((), null, dtype=v.dtype,
                                                         device=v.device)))
        return out_ca + tuple(shifted) + (valid_s,)

    outs = shard_map(step, mesh)(*shuf, svalid)
    cols = {name: _rebuild_col(batch.columns[name], outs[lo:hi]) for name, lo, hi in slices}
    for c, arr in zip(columns, outs[ncarry:-1]):
        src = batch.columns[c]
        cols[f"{c}_shifted_{n_lag}"] = NumCol(arr, src.kind, src.unit)
    return DeviceBatch(cols, outs[-1], None, None)


# ---------------------------------------------------------------------------
# plan walker
# ---------------------------------------------------------------------------


def _dedup(names: Sequence[str]) -> List[str]:
    return list(dict.fromkeys(names))


class MeshExecutor:
    """Runs a plan over a mesh; ``run`` returns the collected host columns
    (``bridge.device_to_host``), or None for a legitimately empty result."""

    SUPPORTED = (
        logical.SourceNode, logical.FilterNode, logical.ProjectionNode, logical.MapNode,
        logical.AggNode, logical.JoinNode, logical.TopKNode, logical.SinkNode,
        logical.AsofJoinNode, logical.WindowAggNode, logical.ShiftNode, logical.StatefulNode,
    )
    MAX_WINDOW_REPLICATION = 16

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def check_plan(self, sub: Dict[int, logical.Node]) -> None:
        """Refuse, before any work runs, the node types and shapes the mesh
        does not cover (data-dependent bailouts, like a many-to-many join's
        overflow, can still abort mid-run)."""
        from quokka_tpu_torch import windows as W

        for node in sub.values():
            if not isinstance(node, self.SUPPORTED):
                raise MeshUnsupported(f"node {type(node).__name__} on mesh")
            if isinstance(node, logical.AsofJoinNode) and not node.left_by:
                raise MeshUnsupported("by-less asof join on mesh")
            if isinstance(node, logical.ShiftNode) and not node.by:
                raise MeshUnsupported("by-less shift on mesh")
            if type(node) is logical.StatefulNode and len(node.parents) != 1:
                # generic stateful operators run as a single-device tail
                # over the sharded upstream: one input only
                raise MeshUnsupported("multi-input stateful operator on mesh")
            if isinstance(node, logical.WindowAggNode):
                self._check_window(node, W)
            if isinstance(node, logical.JoinNode) and node.how not in (
                    "inner", "left", "semi", "anti"):
                raise MeshUnsupported(f"join how={node.how} on mesh")

    def _check_window(self, node, W) -> None:
        win = node.window
        if isinstance(win, W.SessionWindow):
            if not node.by:
                raise MeshUnsupported("by-less session window on mesh (global timeline)")
        elif isinstance(win, W.SlidingWindow):
            if not node.by:
                raise MeshUnsupported("by-less sliding window on mesh (global timeline)")
            if any(op not in ("sum", "count", "min", "max") for _, op, _ in node.plan.partials):
                raise MeshUnsupported("sliding window op on mesh")
        elif not isinstance(win, (W.TumblingWindow, W.HoppingWindow)):
            raise MeshUnsupported(f"{type(win).__name__} on mesh")
        else:
            # the replication factor is a static blowup of the whole sharded
            # dataset: fine hops go to the engine
            hop = win.size if isinstance(win, W.TumblingWindow) else win.hop
            if win.size // max(1, hop) > self.MAX_WINDOW_REPLICATION:
                raise MeshUnsupported(f"hopping replication factor {win.size // hop} > "
                                      f"{self.MAX_WINDOW_REPLICATION} on mesh")

    def run(self, sub: Dict[int, logical.Node], sink_id: int):
        from quokka_tpu_torch.optimizer import unfuse_stages

        # whole-stage fusion regroups actors of the engine; the mesh lowers
        # logical nodes itself (a copy: an engine fallback runs the fused plan)
        sub = unfuse_stages(sub)
        self.check_plan(sub)
        node = sub[sink_id]
        schema = list(node.schema)
        if isinstance(node, logical.SinkNode):
            sink_id = node.parents[0]
        self._root_nid = sink_id
        try:
            out = self._exec(sub, sink_id)
        except _EmptyResult:
            return None
        out = out.select([c for c in schema if c in out.columns])
        return bridge.device_to_host(out)

    def _compact_reshard(self, batch: DeviceBatch) -> DeviceBatch:
        """A shuffle pads each shard's rows by the shard count, so chained
        stages would grow P-fold each: compact back to the live rows (one
        host read of their count) when the batch is more than twice their
        bucket."""
        n = batch.count_valid()
        if batch.padded_len <= 2 * config.bucket_size(max(n, 1)):
            return batch
        return _shard_batch(kernels.compact(batch), self.mesh)

    def _exec(self, sub, nid) -> DeviceBatch:
        node = sub[nid]
        if isinstance(node, logical.SourceNode):
            return self._source(node)
        if isinstance(node, logical.FilterNode):
            return _filter(self._exec(sub, node.parents[0]), node.predicate)
        if isinstance(node, logical.ProjectionNode):
            b = self._exec(sub, node.parents[0])
            return b.select([c for c in node.schema if c in b.columns])
        if isinstance(node, logical.MapNode):
            b = self._exec(sub, node.parents[0])
            if node.exprs is not None:
                b = _with_exprs(b, node.exprs.items())
                return b.select([c for c in node.schema if c in b.columns])
            return node.fn(b)
        if isinstance(node, logical.AggNode):
            return self._agg(sub, node)
        if isinstance(node, logical.AsofJoinNode):
            return self._asof(sub, node)
        if isinstance(node, logical.ShiftNode):
            b = self._exec(sub, node.parents[0])
            out = mesh_shift(self.mesh, b, list(node.by), node.time_col, list(node.columns),
                             node.n)
            return self._compact_reshard(out.select([c for c in node.schema
                                                     if c in out.columns]))
        if isinstance(node, logical.WindowAggNode):
            return self._window(sub, node)
        if isinstance(node, logical.JoinNode):
            return self._join(sub, node)
        if isinstance(node, logical.TopKNode):
            # root-level order / limit: small after aggregation, finished on
            # the materialized result
            b = _materialize(self._exec(sub, node.parents[0]))
            return kernels.top_k(b, node.by, node.k, node.descending)
        if type(node) is logical.StatefulNode:
            return self._stateful_tail(sub, nid, node)
        raise MeshUnsupported(f"node {type(node).__name__} on mesh")

    def _stateful_tail(self, sub, nid, node) -> DeviceBatch:
        """A generic stateful operator runs once over the materialized
        upstream (the single-device tail of root sort and top-k, the same
        as exec_channels=1 on the engine), with the engine's driving
        contract: execute, then source_done, then done."""
        b = _materialize(self._exec(sub, node.parents[0]))
        parent_sorted = getattr(sub[node.parents[0]], "sorted_by", None)
        if parent_sorted:
            # shuffles leave shard-major order; a sorted stateful executor
            # gets time order from the engine's ordered delivery
            b = kernels.sort_batch(b, list(parent_sorted), [False] * len(parent_sorted))
        executor = node.executor_factory()
        parts = []
        out = executor.execute([b], 0, 0)
        if out is not None:
            parts.append(out)
        sd = executor.source_done(0, 0) if hasattr(executor, "source_done") else None
        if sd is not None:
            parts.append(sd)
        fin = executor.done(0)
        if fin is not None:
            parts.extend([fin] if isinstance(fin, DeviceBatch) else [x for x in fin if x is not None])
        if not parts:
            if nid == self._root_nid:
                raise _EmptyResult()
            raise MeshUnsupported("empty mid-plan stateful output")
        out = parts[0] if len(parts) == 1 else bridge.concat_batches(parts)
        return out.select([c for c in node.schema if c in out.columns])

    def _source(self, node: logical.SourceNode) -> DeviceBatch:
        """Every lineage of the reader, landed (K23 per table) and
        concatenated into one global batch, then the pushed-down predicate
        (K1) over it."""
        reader = node.reader
        if node.predicate is not None and hasattr(reader, "predicate"):
            reader.predicate = node.predicate  # row-group pruning
        if node.projection is not None and hasattr(reader, "columns"):
            reader.columns = list(node.projection)
        needed = set(node.schema)
        if node.predicate is not None:
            needed |= set(node.predicate.required_columns())
        dev = self.mesh.device
        batches = []
        for lineage in reader.get_own_state(1).get(0, []):
            table = reader.execute(0, lineage)
            if table is None:
                continue
            table = table.select([c for c in table.column_names if c in needed])
            if isinstance(table, bridge.HostTable):
                batches.append(bridge.host_to_device(table, dev, sorted_by=node.sorted_by))
            else:
                batches.append(bridge.arrow_to_device(table, dev, sorted_by=node.sorted_by))
        if not batches:
            raise MeshUnsupported("source produced no batches")
        batch = _shard_batch(bridge.concat_batches(batches), self.mesh)
        if node.predicate is not None:
            batch = _filter(batch, node.predicate)
        return batch.select([c for c in node.schema if c in batch.columns])

    def _agg(self, sub, node: logical.AggNode) -> DeviceBatch:
        from quokka_tpu_torch.executors.sql_execs import FinalAggExecutor

        b = _with_exprs(self._exec(sub, node.parents[0]), node.plan.pre)
        plan = node.plan
        partials = list(plan.partials)
        if not node.keys:
            # a whole-table aggregate: one reduction per partial over the
            # sharded arrays (row 9)
            cols = {}
            for (pname, op, _), arr in zip(partials, _agg_values(b, partials)):
                cols[pname] = _agg_col(kernels.reduce_array(arr, b.valid, op).reshape(1))
            g = DeviceBatch(cols, torch.ones(1, dtype=torch.bool, device=b.device), 1, None)
        else:
            g = mesh_groupby(self.mesh, b, list(node.keys), partials,
                             [op for _, op in plan.recombine])
        # finals / having / order / limit through the real executor on the
        # materialized groups: recombining unique groups is the identity
        fin = FinalAggExecutor(list(node.keys), plan, self.mesh.device, having=node.having,
                               order_by=node.order_by, limit=node.limit)
        parts = [x for x in (fin.execute([_materialize(g)], 0, 0), fin.done(0))
                 if x is not None]
        if not parts:
            raise MeshUnsupported("aggregation produced no output")
        return parts[0] if len(parts) == 1 else bridge.concat_batches(parts)

    def _asof(self, sub, node: logical.AsofJoinNode) -> DeviceBatch:
        trades = self._exec(sub, node.parents[0])
        quotes = self._exec(sub, node.parents[1])
        # payload naming of OrderedStream.join_asof: quote columns other
        # than the by-keys and the time, suffixed on a clash
        rpayload = [c for c in quotes.names
                    if c not in set(node.right_by) and c != node.right_on]
        rename = {c: c + node.suffix for c in rpayload if c in set(trades.names)}
        if rename:
            quotes = quotes.rename(rename)
            rpayload = [rename.get(c, c) for c in rpayload]
        out = mesh_asof(self.mesh, trades, quotes, node.left_on, node.right_on,
                        list(node.left_by), list(node.right_by), rpayload, node.direction)
        return self._compact_reshard(out.select([c for c in node.schema if c in out.columns]))

    def _time_col(self, b: DeviceBatch, name: str, what: str) -> NumCol:
        col = b.columns[name]
        if col.data.is_floating_point():
            raise MeshUnsupported(f"float time column in mesh {what}")
        return col

    def _window(self, sub, node: logical.WindowAggNode) -> DeviceBatch:
        from quokka_tpu_torch import windows as W

        b = _with_exprs(self._exec(sub, node.parents[0]), node.plan.pre)
        win = node.window
        if isinstance(win, W.SessionWindow):
            return self._session_window(node, b)
        if isinstance(win, W.SlidingWindow):
            return self._sliding_window(node, b)
        plan = node.plan
        size = win.size
        hop = size if isinstance(win, W.TumblingWindow) else win.hop
        col = self._time_col(b, node.time_col, "window")
        g = mesh_window_agg(self.mesh, b, list(node.by), col.data, size, hop,
                            list(plan.partials), [op for _, op in plan.recombine])
        host = _materialize(g)
        start = host.columns["__wid"].data * hop
        host = host.with_column("window_start", NumCol(start, col.kind, col.unit))
        host = host.with_column("window_end", NumCol(start + size, col.kind, col.unit))
        host = _with_exprs(host, plan.finals)
        out_cols = _dedup(list(node.by) + ["window_start", "window_end"]
                          + [n for n, _ in plan.finals])
        # windows emit in start order, as the streaming executors do
        return kernels.sort_batch(host.select(out_cols), ["window_start"], [False])

    def _session_window(self, node: logical.WindowAggNode, b: DeviceBatch) -> DeviceBatch:
        plan = node.plan
        col = self._time_col(b, node.time_col, "session window")
        g = mesh_session_window(self.mesh, b, list(node.by), col.data,
                                int(node.window.timeout), list(plan.partials))
        host = _materialize(g)
        host = host.rename({"__first_t": "session_start", "__last_t": "session_end"})
        for c in ("session_start", "session_end"):
            host = host.with_column(c, NumCol(host.columns[c].data, col.kind, col.unit))
        host = _with_exprs(host, plan.finals)
        out_cols = _dedup(list(node.by) + ["session_start", "session_end"]
                          + [n for n, _ in plan.finals])
        return kernels.sort_batch(host.select(out_cols), ["session_start"], [False])

    def _sliding_window(self, node: logical.WindowAggNode, b: DeviceBatch) -> DeviceBatch:
        plan = node.plan
        col = self._time_col(b, node.time_col, "sliding window")
        out = mesh_sliding_window(self.mesh, b, list(node.by), col.data,
                                  int(node.window.size_before), list(plan.partials))
        out = _with_exprs(out, plan.finals)
        return self._compact_reshard(out.select([c for c in node.schema if c in out.columns]))

    def _join(self, sub, node: logical.JoinNode) -> DeviceBatch:
        probe = self._exec(sub, node.parents[0])
        build = self._exec(sub, node.parents[1])
        unique = join_ops._sorted_build_unique(build, node.right_on)
        payload = [c for c in build.names if c not in set(node.right_on)]
        rename = node.rename or {c: c + node.suffix for c in payload if c in probe.columns}
        rename = {c: n for c, n in rename.items() if c in payload}
        if rename:
            build = build.rename(rename)
            payload = [rename.get(c, c) for c in payload]
        out = mesh_join(self.mesh, probe, build, list(node.left_on), list(node.right_on),
                        node.how, payload, unique=unique)
        if node.how not in ("semi", "anti"):
            out = out.select([c for c in node.schema if c in out.columns])
        return self._compact_reshard(out)

