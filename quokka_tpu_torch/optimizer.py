"""Logical-plan optimizer (port of ``quokka_tpu/optimizer.py``).

1. push_filters      -- predicate pushdown per conjunct, through stacked
                        filters and joins into source readers.
2. early_projection  -- column-requirement analysis; prunes the column set
                        each source actually reads.
3. choose_broadcast  -- a build side the catalog estimates at no more than
                        BROADCAST_THRESHOLD rows becomes a broadcast join.
4. plan_adaptive_exchanges -- marks the inner hash joins whose build
                        exchange the engine may salt mid-query
                        (planner/decide.py; QK_ADAPT=0 disables it).
5. push_ann          -- an opted-in approximate nearest_neighbors over an
                        IVF-indexed Parquet source prunes its row groups.
6. fuse_stages       -- whole-stage fusion of single-consumer chains
                        (QK_STAGE_FUSE=0 disables it).

The reference's pass line runs its cost-fed passes from
``planner/decide.py`` instead of 3 (``choose_broadcast_cost``, which falls
back to this same sampled-rows threshold without a measurement) and adds
``reorder_joins``; those come later (ROADMAP Queue 1, the planner item),
so the port keeps the join order the user wrote.  Channel counts are the
context's ``exec_channels``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

from quokka_tpu_torch import logical
from quokka_tpu_torch.expression import Expr, conjoin, rename_columns, split_conjuncts
from quokka_tpu_torch.planner import decide

BROADCAST_THRESHOLD = 65_536  # build rows at or below this skip the probe-side shuffle


def optimize(sub: Dict[int, logical.Node], sink_id: int) -> int:
    for fn in (push_filters, early_projection, choose_broadcast,
               decide.plan_adaptive_exchanges, push_ann, fuse_stages):
        fn(sub, sink_id)
        live = _reachable(sub, sink_id)
        for nid in set(sub) - set(live):
            del sub[nid]
        _recompute_schemas(sub, live)
    return sink_id


def _consumers(sub: Dict[int, logical.Node], sink_id: int) -> Dict[int, List[int]]:
    cons: Dict[int, List[int]] = {nid: [] for nid in _reachable(sub, sink_id)}
    for nid in list(cons):
        for p in sub[nid].parents:
            cons[p].append(nid)
    return cons


def _reachable(sub: Dict[int, logical.Node], sink_id: int) -> List[int]:
    out, seen = [], set()

    def rec(nid):
        if nid in seen:
            return
        seen.add(nid)
        for p in sub[nid].parents:
            rec(p)
        out.append(nid)

    rec(sink_id)
    return out


def _relink(sub, sink_id, old: int, new: int) -> None:
    """Point every consumer of `old` at `new`."""
    for nid in _reachable(sub, sink_id):
        node = sub[nid]
        node.parents = [new if p == old else p for p in node.parents]


def push_filters(sub: Dict[int, logical.Node], sink_id: int) -> None:
    changed = True
    rounds = 0
    while changed and rounds < 100:
        changed = False
        rounds += 1
        for nid in _reachable(sub, sink_id):
            node = sub.get(nid)
            if not isinstance(node, logical.FilterNode):
                continue
            cons = _consumers(sub, sink_id)
            if not cons.get(nid):
                continue  # a root filter cannot be removed after its push
            if _try_push_one(sub, sink_id, nid, node, cons):
                changed = True
                break


def _try_push_one(sub, sink_id, fid: int, fnode: logical.FilterNode, cons) -> bool:
    pid = fnode.parents[0]
    parent = sub[pid]
    parent_shared = len(cons.get(pid, [])) > 1
    if isinstance(parent, logical.FilterNode):
        if parent_shared:
            return False
        fnode.predicate = conjoin([parent.predicate, fnode.predicate])
        fnode.parents = list(parent.parents)
        return True
    if isinstance(parent, logical.SourceNode):
        if parent_shared:
            return False
        parent.predicate = (fnode.predicate if parent.predicate is None
                            else conjoin([parent.predicate, fnode.predicate]))
        _relink(sub, sink_id, fid, pid)
        return True
    if isinstance(parent, logical.JoinNode):
        # each conjunct goes to the side that holds all its columns: the
        # probe side for every join kind the port lowers, the build side
        # (under the build's own column names) for inner joins
        left_schema = set(sub[parent.parents[0]].schema)
        right = sub[parent.parents[1]]
        rename = parent.rename or {}
        unsuffix = {rename.get(c, c): c for c in right.schema
                    if c not in set(parent.right_on)}
        remaining = []
        pushed = False
        for conj in split_conjuncts(fnode.predicate):
            req = conj.required_columns()
            if req <= left_schema and parent.how in ("inner", "left", "semi", "anti"):
                _insert_filter_above(sub, parent, 0, conj)
                pushed = True
            elif req <= set(unsuffix) and parent.how == "inner":
                _insert_filter_above(sub, parent, 1, rename_columns(conj, unsuffix))
                pushed = True
            else:
                remaining.append(conj)
        if not pushed:
            return False
        if remaining:
            fnode.predicate = conjoin(remaining)
        else:
            _relink(sub, sink_id, fid, pid)
        return True
    return False


def _insert_filter_above(sub, join_node: logical.JoinNode, side: int, conj: Expr) -> None:
    parent_id = join_node.parents[side]
    new_id = max(sub) + 1
    sub[new_id] = logical.FilterNode([parent_id], list(sub[parent_id].schema), conj)
    join_node.parents[side] = new_id


def early_projection(sub: Dict[int, logical.Node], sink_id: int) -> None:
    order = _reachable(sub, sink_id)
    req: Dict[int, Set[str]] = {nid: set() for nid in order}
    req[sink_id] = set(sub[sink_id].schema)
    for nid in reversed(order):
        node = sub[nid]
        need = set(node.schema) if isinstance(node, logical.SinkNode) else req[nid]
        # a with_columns output nobody consumes is pruned, not just skipped:
        # the map evaluates every expression it carries, so its inputs would
        # otherwise have to survive source pruning
        if isinstance(node, logical.MapNode) and node.exprs is not None \
                and any(k not in need for k in node.exprs):
            node.exprs = {k: e for k, e in node.exprs.items() if k in need}
            node.fn = logical.WithColumnsFn(node.exprs)
        for i, pid in enumerate(node.parents):
            req[pid] |= _needed_from_parent(sub, node, i, need)
    for nid in order:
        node = sub[nid]
        if isinstance(node, logical.SourceNode):
            keep = set(req[nid])
            if node.predicate is not None:
                keep |= node.predicate.required_columns()
            keep |= set(node.sorted_by or [])
            needed = [c for c in node.schema if c in keep]
            if 0 < len(needed) < len(node.schema):
                node.projection = needed
                node.schema = needed


def _recompute_schemas(sub: Dict[int, logical.Node], order: List[int]) -> None:
    for nid in order:
        node = sub[nid]
        if not node.parents:
            continue
        try:
            d = node.derive_schema([list(sub[p].schema) for p in node.parents])
        except (ValueError, KeyError):
            continue
        if d is not None:
            node.schema = d


def _needed_from_parent(sub, node: logical.Node, i: int, need: Set[str]) -> Set[str]:
    parent_schema = set(sub[node.parents[i]].schema)
    if isinstance(node, logical.FilterNode):
        return (need | node.predicate.required_columns()) & parent_schema
    if isinstance(node, logical.ProjectionNode):
        return set(node.schema) & parent_schema
    if isinstance(node, logical.MapNode):
        if node.exprs is None:
            return parent_schema  # a rename: keep everything
        out = set()
        for c in need:
            out |= node.exprs[c].required_columns() if c in node.exprs else {c}
        return out & parent_schema
    if isinstance(node, logical.AggNode):
        out = set(node.keys)
        for _, e in node.plan.pre:
            out |= e.required_columns()
        return out & parent_schema
    if isinstance(node, logical.JoinNode):
        if i == 0:
            return ((need & parent_schema) | set(node.left_on)) & parent_schema
        rename = node.rename or {}
        out = set(node.right_on)
        for c in sub[node.parents[1]].schema:
            if rename.get(c, c) in need:
                out.add(c)
        return out & parent_schema
    if isinstance(node, logical.TopKNode):
        return (need | set(node.by)) & parent_schema
    if isinstance(node, logical.StatefulNode):
        # an executor's own state: the time-series nodes read their whole input
        return parent_schema
    return need & parent_schema if need else parent_schema


# ---------------------------------------------------------------------------
# broadcast join selection
# ---------------------------------------------------------------------------

_CATALOG = None


def _get_catalog():
    from quokka_tpu_torch.catalog import Catalog

    global _CATALOG
    if _CATALOG is None:
        _CATALOG = Catalog()
    return _CATALOG


def _estimate_subtree(sub, nid: int, cat) -> Optional[float]:
    """Estimated rows flowing out of a Filter/Projection/Map chain over one
    source; None when the shape is more complex."""
    node = sub[nid]
    preds: List[Expr] = []
    for _ in range(64):
        if isinstance(node, logical.SourceNode):
            pred = conjoin(preds + ([node.predicate] if node.predicate is not None else []))
            return cat.estimate_source(node.reader, pred)
        if isinstance(node, logical.FilterNode):
            preds.append(node.predicate)
            node = sub[node.parents[0]]
            continue
        if isinstance(node, (logical.ProjectionNode, logical.MapNode)):
            node = sub[node.parents[0]]
            continue
        return None
    return None


def choose_broadcast(sub: Dict[int, logical.Node], sink_id: int) -> None:
    cat = _get_catalog()
    for nid in _reachable(sub, sink_id):
        node = sub[nid]
        if not isinstance(node, logical.JoinNode) or node.broadcast:
            continue
        if node.how not in ("inner", "semi", "anti", "left"):
            continue
        est = _estimate_subtree(sub, node.parents[1], cat)
        if est is not None and est <= BROADCAST_THRESHOLD:
            node.broadcast = True


# ---------------------------------------------------------------------------
# approximate nearest-neighbour pushdown
# ---------------------------------------------------------------------------


def push_ann(sub: Dict[int, logical.Node], sink_id: int) -> None:
    """An opted-in ``nearest_neighbors(..., approximate=True)`` over an
    IVF-indexed Parquet source prunes the scan to the row groups owning the
    queries' closest cells (the reference's ``push_ann``)."""
    # readers are shared with the user's plan: reset first, so that an
    # earlier approximate query cannot leak pruning into a later exact one
    for nid in _reachable(sub, sink_id):
        node = sub[nid]
        if isinstance(node, logical.SourceNode) and hasattr(node.reader, "ann_prune"):
            node.reader.ann_prune = None
    cons = _consumers(sub, sink_id)
    for nid in _reachable(sub, sink_id):
        info = getattr(sub[nid], "ann_info", None)
        if info is None:
            continue
        # the chain down to the source must feed only this search: pruning a
        # shared source would drop rows from the other branches
        cur_id = sub[nid].parents[0]
        shared = False
        for _ in range(16):
            if len(cons.get(cur_id, [])) > 1:
                shared = True
                break
            cur = sub[cur_id]
            if not isinstance(cur, (logical.ProjectionNode, logical.FilterNode)):
                break
            cur_id = cur.parents[0]
        cur = sub[cur_id]
        if not shared and isinstance(cur, logical.SourceNode) \
                and hasattr(cur.reader, "ann_prune"):
            cur.reader.ann_prune = (info["queries"], info["nprobe"])


# ---------------------------------------------------------------------------
# whole-stage fusion
# ---------------------------------------------------------------------------


def stage_fuse_enabled() -> bool:
    """QK_STAGE_FUSE=0 disables fuse_stages (read at every plan)."""
    return os.environ.get("QK_STAGE_FUSE", "1") not in ("0", "false", "no")


def _fusible_member(node: logical.Node) -> bool:
    """May this node live inside a fused stage?  Non-blocking, streaming,
    unordered operators only: an ordered node (and every as-of, window and
    shift node, which are stateful) keeps an actor of its own."""
    if node.sorted_by is not None:
        return False
    return isinstance(node, (logical.FilterNode, logical.ProjectionNode, logical.MapNode,
                             logical.JoinNode, logical.AggNode))


def fuse_stages(sub: Dict[int, logical.Node], sink_id: int) -> None:
    """Rewrite each maximal single-consumer linear chain of fusible
    operators into one FusedStageNode.  Chain rules, as the reference's:

    - extension follows the consumer's main input (parents[0]) only, and
      only while the producer has exactly one consumer;
    - a non-broadcast hash join may only head a chain (its probe-side hash
      edge partitions the stage's stream 0); interior joins are broadcast;
    - an AggNode ends the chain (its partial half fuses in-stage, the final
      half stays a separate key-partitioned actor);
    - filters, projections and expression maps inside a chain run as one
      in-stage elementwise kernel (K16);
    - blocking operators (top-k, sinks) never fuse; 1-member chains stay.
    """
    if not stage_fuse_enabled():
        return
    cons = _consumers(sub, sink_id)
    absorbed: Set[int] = set()
    for nid in _reachable(sub, sink_id):
        if nid in absorbed:
            continue
        node = sub.get(nid)
        if node is None or not _fusible_member(node) or isinstance(node, logical.AggNode):
            continue
        members = [node]
        ids = [nid]
        cur = nid
        while True:
            c = cons.get(cur, [])
            if len(c) != 1:
                break
            nxt = sub[c[0]]
            if nxt.parents[0] != cur:
                break  # we feed a build side, not the main input
            if not _fusible_member(nxt):
                break
            if isinstance(nxt, logical.JoinNode) and not nxt.broadcast:
                break
            members.append(nxt)
            ids.append(c[0])
            cur = c[0]
            if isinstance(nxt, logical.AggNode):
                break
        if len(members) < 2:
            continue
        chans = {m.channels for m in members if m.channels is not None}
        if len(chans) > 1:
            continue  # members pinned to conflicting widths
        parents = [members[0].parents[0]] + [
            m.parents[1] for m in members if isinstance(m, logical.JoinNode)]
        fused = logical.FusedStageNode(members, parents, list(members[-1].schema))
        fused.channels = chans.pop() if chans else None
        # the tail's id survives so consumers' parent links stay valid
        sub[ids[-1]] = fused
        for i in ids[:-1]:
            del sub[i]
        absorbed.update(ids)
        cons = _consumers(sub, sink_id)


def unfuse_stages(sub: Dict[int, logical.Node]) -> Dict[int, logical.Node]:
    """Inverse of ``fuse_stages``, for executors that lower logical nodes
    themselves (the mesh, ``parallel/mesh_exec.py``): every FusedStageNode
    expands back into its member chain.  Fusion never rewrote the members'
    own parent links (member i's parents[0] still names member i-1's id and
    the tail kept its id), so the original graph comes back exactly.
    Returns a new dict; the caller's fused plan is untouched."""
    out = dict(sub)
    for nid, node in sub.items():
        if not isinstance(node, logical.FusedStageNode):
            continue
        ids = [m.parents[0] for m in node.members[1:]] + [nid]
        for mid, m in zip(ids, node.members):
            out[mid] = m
    return out
