"""Logical plan nodes (port of ``quokka_tpu/logical.py``: Source, Filter,
Projection, Map, Join, Agg, FusedStage, TopK, Sink, and the time-series
nodes AsofJoin, WindowAgg and Shift).

A node whose ``sorted_by`` is set lowers to a sorted actor: its consumers
take its batches in global (seq, channel) order (``runtime/engine.py``).

The DataStream API builds a DAG of these; the optimizer rewrites it;
``lower()`` emits physical actors into the runtime TaskGraph.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

from quokka_tpu_torch.expression import Expr
from quokka_tpu_torch.ops.expr_compile import AggPlan, evaluate_to_column
from quokka_tpu_torch.target_info import (
    BroadcastPartitioner,
    HashPartitioner,
    PassThroughPartitioner,
    TargetInfo,
)


class Node:
    def __init__(self, parents: List[int], schema: List[str]):
        self.parents = parents
        self.schema = schema
        self.stage = 0
        self.channels: Optional[int] = None  # None -> context default
        self.sorted_by: Optional[List[str]] = None
        # parents[i] for i in build_parents run a stage earlier (builds
        # finish before their probe starts; context._assign_stages)
        self.build_parents: List[int] = []

    def lower(self, ctx, graph, actor_of: Dict[int, int], node_id: int) -> None:
        raise NotImplementedError

    def derive_schema(self, parents: List[List[str]]) -> Optional[List[str]]:
        """Output columns derived from the parents' schemas (None when the
        declared schema is the source of truth)."""
        return None

    def describe(self) -> str:
        return type(self).__name__


def _require(cols, parent: List[str], what: str) -> None:
    missing = [c for c in cols if c not in set(parent)]
    if missing:
        raise ValueError(f"{what} references columns {missing} not in input {parent}")


def _passthrough_edge():
    return TargetInfo(PassThroughPartitioner())


class SourceNode(Node):
    def __init__(self, reader, schema: List[str], sorted_by=None):
        super().__init__([], schema)
        self.reader = reader
        self.sorted_by = sorted_by
        self.predicate: Optional[Expr] = None  # pushed-down filter
        self.projection: Optional[List[str]] = None  # pushed-down column set

    def lower(self, ctx, graph, actor_of, node_id):
        reader = self.reader
        if self.predicate is not None and hasattr(reader, "predicate"):
            reader.predicate = self.predicate  # row-group pruning
        if self.projection is not None and hasattr(reader, "columns"):
            reader.columns = list(self.projection)
        actor_of[node_id] = graph.new_input_reader_node(
            reader, self.channels or ctx.io_channels, self.stage, self.sorted_by,
            predicate=self.predicate, projection=self.projection)

    def describe(self):
        d = f"Source({type(self.reader).__name__}"
        if self.predicate is not None:
            d += f", filter={self.predicate.sql()}"
        if self.projection is not None:
            d += f", cols={self.projection}"
        return d + ")"


@dataclasses.dataclass
class SelectFn:
    """Per-batch projection."""

    cols: List[str]

    def __call__(self, b):
        return b.select(self.cols)


@dataclasses.dataclass
class RenameFn:
    mapping: Dict[str, str]

    def __call__(self, b):
        return b.rename(self.mapping)


@dataclasses.dataclass
class WithColumnsFn:
    """with_columns map: evaluates its expressions per batch."""

    exprs: Dict[str, Expr]

    def __call__(self, b):
        for name, e in self.exprs.items():
            b = b.with_column(name, evaluate_to_column(e, b))
        return b


class FilterNode(Node):
    def __init__(self, parents, schema, predicate: Expr):
        super().__init__(parents, schema)
        self.predicate = predicate

    def derive_schema(self, parents):
        _require(self.predicate.required_columns(), parents[0], "filter predicate")
        return list(parents[0])

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import UDFExecutor
        from quokka_tpu_torch.ops.fuse import FusedPredicate

        actor_of[node_id] = graph.new_exec_node(
            functools.partial(UDFExecutor, FusedPredicate(self.predicate)),
            {0: (actor_of[self.parents[0]], _passthrough_edge())},
            self.channels or ctx.exec_channels, self.stage,
            sorted_actor=self.sorted_by is not None)

    def describe(self):
        return f"Filter({self.predicate.sql()})"


class ProjectionNode(Node):
    def derive_schema(self, parents):
        _require(self.schema, parents[0], "projection")
        return list(self.schema)

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import UDFExecutor

        actor_of[node_id] = graph.new_exec_node(
            functools.partial(UDFExecutor, SelectFn(list(self.schema))),
            {0: (actor_of[self.parents[0]], _passthrough_edge())},
            self.channels or ctx.exec_channels, self.stage,
            sorted_actor=self.sorted_by is not None)

    def describe(self):
        return f"Projection({self.schema})"


class MapNode(Node):
    """with_columns / rename: a per-batch function with explicit output
    schema metadata, ``exprs`` (with_columns) or ``rename`` (a column-rename
    map)."""

    def __init__(self, parents, schema, fn: Callable,
                 exprs: Optional[Dict[str, Expr]] = None,
                 rename: Optional[Dict[str, str]] = None):
        super().__init__(parents, schema)
        self.fn = fn
        self.exprs = exprs
        self.rename = rename

    def derive_schema(self, parents):
        if self.exprs is not None:
            for k, e in self.exprs.items():
                _require(e.required_columns(), parents[0], f"map expr {k}")
            # with_column replaces a present column in place and appends a new one
            return list(parents[0]) + [k for k in self.exprs if k not in set(parents[0])]
        # a mapping key absent from the input is a no-op, as in DeviceBatch.rename
        return [self.rename.get(c, c) for c in parents[0]]

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import UDFExecutor

        actor_of[node_id] = graph.new_exec_node(
            functools.partial(UDFExecutor, self.fn),
            {0: (actor_of[self.parents[0]], _passthrough_edge())},
            self.channels or ctx.exec_channels, self.stage,
            sorted_actor=self.sorted_by is not None)

    def describe(self):
        if self.exprs:
            return "Map(" + ", ".join(f"{k}={v.sql()}" for k, v in self.exprs.items()) + ")"
        return f"Map(rename {self.rename})"


class AggNode(Node):
    """Decomposed group-by aggregate: a partial-agg actor on the parent's
    channels feeds a key-hash-partitioned final-agg actor."""

    def __init__(self, parents, schema, keys: List[str], plan: AggPlan, having=None,
                 order_by=None, limit=None):
        super().__init__(parents, schema)
        self.keys = keys
        self.plan = plan
        self.having = having
        self.order_by = order_by
        self.limit = limit

    def derive_schema(self, parents):
        _require(self.keys, parents[0], "groupby keys")
        for name, e in self.plan.pre:
            _require(e.required_columns(), parents[0], f"aggregate input {name}")
        return list(self.keys) + [n for n, _ in self.plan.finals if n not in set(self.keys)]

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import PartialAggExecutor

        partial = graph.new_exec_node(
            functools.partial(PartialAggExecutor, self.keys, self.plan),
            {0: (actor_of[self.parents[0]], _passthrough_edge())},
            self.channels or ctx.exec_channels, self.stage)
        actor_of[node_id] = self.lower_final(ctx, graph, partial, self.channels, self.stage)

    def lower_final(self, ctx, graph, partial: int, channels: Optional[int],
                    stage: int) -> int:
        """The final half, fed by the actor holding the partials: a
        key-partitioned final aggregate, and a one-channel merge when ORDER
        BY / LIMIT must see every channel's rows."""
        from quokka_tpu_torch.executors.sql_execs import FinalAggExecutor, TopKExecutor

        n_final = (channels or ctx.exec_channels) if self.keys else 1
        part = HashPartitioner(self.keys) if self.keys else PassThroughPartitioner()
        final = graph.new_exec_node(
            functools.partial(FinalAggExecutor, self.keys, self.plan, ctx.device,
                              having=self.having, order_by=self.order_by,
                              limit=self.limit),
            {0: (partial, TargetInfo(part))}, n_final, stage)
        if (self.order_by or self.limit is not None) and n_final > 1:
            if self.limit is None:
                raise NotImplementedError("a global ORDER BY without LIMIT needs the "
                                          "sort executor: ROADMAP Queue 1, \"The rest of "
                                          "the DataStream/SQL surface\"")
            names = [n for n, _ in (self.order_by or [])]
            desc = [d for _, d in (self.order_by or [])]
            final = graph.new_exec_node(
                functools.partial(TopKExecutor, names, self.limit, desc),
                {0: (final, _passthrough_edge())}, 1, stage)
        return final

    def describe(self):
        return f"Agg(keys={self.keys}, out={[n for n, _ in self.plan.finals]})"


class StatefulNode(Node):
    """An operator with its own executor and per-input partitioners; the
    base of the time-series nodes."""

    def __init__(self, parents, schema, executor_factory, partitioners=None,
                 sorted_output=None):
        super().__init__(parents, schema)
        self.executor_factory = executor_factory
        self.partitioners = partitioners or {}
        self.sorted_by = sorted_output

    def lower(self, ctx, graph, actor_of, node_id):
        sources = {i: (actor_of[p], TargetInfo(self.partitioners.get(
            i, PassThroughPartitioner()))) for i, p in enumerate(self.parents)}
        actor_of[node_id] = graph.new_exec_node(
            self.executor_factory, sources, self.channels or ctx.exec_channels, self.stage,
            sorted_actor=self.sorted_by is not None)

    def describe(self):
        return "Stateful"


class AsofJoinNode(StatefulNode):
    """As-of join (OrderedStream.join_asof): the streaming SortedAsofExecutor,
    both inputs hash-partitioned by their by-keys."""

    def __init__(self, parents, schema, executor_factory, partitioners, sorted_output, *,
                 left_on, right_on, left_by, right_by, suffix, direction):
        super().__init__(parents, schema, executor_factory, partitioners, sorted_output)
        self.left_on = left_on
        self.right_on = right_on
        self.left_by = list(left_by)
        self.right_by = list(right_by)
        self.suffix = suffix
        self.direction = direction

    def derive_schema(self, parents):
        _require([self.left_on] + self.left_by, parents[0], "asof left keys")
        _require([self.right_on] + self.right_by, parents[1], "asof right keys")
        rpayload = [c for c in parents[1] if c not in set(self.right_by) and c != self.right_on]
        return list(parents[0]) + [c + self.suffix if c in set(parents[0]) else c
                                   for c in rpayload]

    def describe(self):
        return f"AsofJoin({self.direction} on {self.left_on}, by {self.left_by})"


class WindowAggNode(StatefulNode):
    """Window aggregation (OrderedStream.window_agg): tumbling, hopping,
    session or sliding windows per key."""

    def __init__(self, parents, schema, executor_factory, partitioners, sorted_output, *,
                 time_col, by, window, plan, trigger):
        super().__init__(parents, schema, executor_factory, partitioners, sorted_output)
        self.time_col = time_col
        self.by = list(by)
        self.window = window
        self.plan = plan
        self.trigger = trigger

    def derive_schema(self, parents):
        from quokka_tpu_torch import windows as W

        _require([self.time_col] + self.by, parents[0], "window keys")
        for name, e in self.plan.pre:
            _require(e.required_columns(), parents[0], f"window agg input {name}")
        finals = [n for n, _ in self.plan.finals]
        if isinstance(self.window, W.SlidingWindow):
            return list(parents[0]) + finals
        if isinstance(self.window, W.SessionWindow):
            return list(self.by) + ["session_start", "session_end"] + finals
        return list(self.by) + ["window_start", "window_end"] + finals

    def describe(self):
        return f"WindowAgg({type(self.window).__name__}, by {self.by})"


class ShiftNode(StatefulNode):
    """Per-key lag (OrderedStream.shift)."""

    def __init__(self, parents, schema, executor_factory, partitioners, sorted_output, *,
                 time_col, by, columns, n):
        super().__init__(parents, schema, executor_factory, partitioners, sorted_output)
        self.time_col = time_col
        self.by = list(by)
        self.columns = list(columns)
        self.n = n

    def derive_schema(self, parents):
        _require([self.time_col] + self.by + self.columns, parents[0], "shift")
        return list(parents[0]) + [f"{c}_shifted_{self.n}" for c in self.columns]

    def describe(self):
        return f"Shift(n={self.n}, by {self.by})"


class JoinNode(Node):
    """Binary hash join; parents[0] = probe (stream 0), parents[1] = build."""

    def __init__(self, parents, schema, left_on, right_on, how="inner", suffix="_2",
                 broadcast=False, rename=None):
        super().__init__(parents, schema)
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.suffix = suffix
        self.broadcast = broadcast
        # plan-time build-column renames (runtime behaviour stays stable even
        # when the optimizer prunes the clashing probe column)
        self.rename = rename
        self.build_parents = [1]
        # planner/decide.plan_adaptive_exchanges: this join's build edge may
        # be salted mid-query when the engine observes partition skew
        # (inner, non-broadcast, unordered joins only)
        self.adapt_salt = False

    def derive_schema(self, parents):
        _require(self.left_on, parents[0], "join left keys")
        _require(self.right_on, parents[1], "join right keys")
        if self.how in ("semi", "anti"):
            return list(parents[0])
        rename = self.rename or {}
        rpayload = [c for c in parents[1] if c not in set(self.right_on)]
        return list(parents[0]) + [rename.get(c, c) for c in rpayload]

    def executor_factory(self) -> Callable:
        from quokka_tpu_torch.executors.sql_execs import (
            BroadcastJoinExecutor,
            BuildProbeJoinExecutor,
        )

        cls = BroadcastJoinExecutor if self.broadcast else BuildProbeJoinExecutor
        return functools.partial(cls, self.left_on, self.right_on, self.how, self.suffix,
                                 self.rename, out_schema=list(self.schema))

    def build_edge(self) -> TargetInfo:
        return TargetInfo(BroadcastPartitioner() if self.broadcast
                          else HashPartitioner(self.right_on))

    def probe_edge(self) -> TargetInfo:
        return _passthrough_edge() if self.broadcast else TargetInfo(
            HashPartitioner(self.left_on))

    def lower(self, ctx, graph, actor_of, node_id):
        actor_of[node_id] = graph.new_exec_node(
            self.executor_factory(),
            {0: (actor_of[self.parents[0]], self.probe_edge()),
             1: (actor_of[self.parents[1]], self.build_edge())},
            self.channels or ctx.exec_channels, self.stage)
        if not self.broadcast and self.adapt_salt:
            graph.adapt_edges[(actor_of[self.parents[1]], actor_of[node_id])] = {
                "probe_src": actor_of[self.parents[0]]}

    def describe(self):
        k = "BroadcastJoin" if self.broadcast else "HashJoin"
        return f"{k}({self.how}, {self.left_on}={self.right_on})"


class FusedStageNode(Node):
    """A maximal fusible linear chain rewritten into one exec actor
    (optimizer.fuse_stages).  parents[0] is the chain head's main input;
    parents[1:] are the member joins' build sides in chain order.  Lowers to
    one FusedStageExecutor actor (ops/stagefuse.py); a tail AggNode
    contributes its partial half in-stage, and its final actors are emitted
    as AggNode.lower emits them."""

    def __init__(self, members: List[Node], parents: List[int], schema: List[str]):
        super().__init__(parents, schema)
        self.members = members
        self.build_parents = list(range(1, len(parents)))

    def derive_schema(self, parents):
        # replay the member chain: member i's main input is member i-1's
        # output; join members consume build sides in chain order
        builds = iter(parents[1:])
        cur = list(parents[0])
        for m in self.members:
            if isinstance(m, JoinNode):
                cur = m.derive_schema([cur, list(next(builds))])
            else:
                d = m.derive_schema([cur])
                cur = list(m.schema) if d is None else d
        leftover = list(builds)
        if leftover:
            raise ValueError(f"fused stage has {len(leftover)} build inputs with no join member")
        return cur

    def describe(self):
        inner = "\n".join("  " + m.describe() for m in self.members)
        return "FusedStage(\n" + inner + "\n)"

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import PartialAggExecutor, UDFExecutor
        from quokka_tpu_torch.ops.stagefuse import (
            FusedElementwise,
            FusedStageExecutor,
            StageSpec,
        )

        steps: List[Tuple[str, Callable]] = []
        routing: Dict[int, Tuple[int, int]] = {}
        builds = iter(self.parents[1:])
        agg: Optional[AggNode] = None
        elem: List[Tuple] = []

        def flush_elem():
            # consecutive filter / projection / map members: one K16 step
            if elem:
                steps.append(("Elemwise", functools.partial(
                    UDFExecutor, FusedElementwise(list(elem)))))
                elem.clear()

        head = self.members[0]
        main_edge = head.probe_edge() if isinstance(head, JoinNode) else _passthrough_edge()
        sources = {0: (actor_of[self.parents[0]], main_edge)}
        for m in self.members:
            if isinstance(m, FilterNode):
                elem.append(("filter", m.predicate))
            elif isinstance(m, ProjectionNode):
                elem.append(("project", list(m.schema)))
            elif isinstance(m, MapNode) and m.exprs:
                elem.append(("map", list(m.exprs.items())))
            elif isinstance(m, MapNode):
                flush_elem()
                steps.append(("Map", functools.partial(UDFExecutor, m.fn)))
            elif isinstance(m, JoinNode):
                flush_elem()
                stream = len(sources)
                sources[stream] = (actor_of[next(builds)], m.build_edge())
                routing[stream] = (len(steps), 1)
                steps.append(("BroadcastJoin" if m.broadcast else "HashJoin",
                              m.executor_factory()))
            elif isinstance(m, AggNode):
                flush_elem()
                steps.append(("PartialAgg", functools.partial(
                    PartialAggExecutor, m.keys, m.plan)))
                agg = m
            else:
                raise TypeError(f"unfusible member {type(m).__name__}")
        flush_elem()
        fused = graph.new_exec_node(
            functools.partial(FusedStageExecutor, StageSpec(steps, routing)),
            sources, self.channels or ctx.exec_channels, self.stage)
        # fuse_stages admits a non-broadcast hash join only at the chain head;
        # its build is the fused actor's stream 1, so the adaptive-exchange
        # mark survives fusion as an edge of the fused actor
        if (isinstance(head, JoinNode) and not head.broadcast and head.adapt_salt
                and 1 in sources):
            graph.adapt_edges[(sources[1][0], fused)] = {"probe_src": sources[0][0]}
        actor_of[node_id] = fused if agg is None else agg.lower_final(
            ctx, graph, fused, self.channels, self.stage)


class TopKNode(Node):
    def __init__(self, parents, schema, by, k, descending):
        super().__init__(parents, schema)
        self.by = by
        self.k = k
        self.descending = descending

    def derive_schema(self, parents):
        _require(self.by, parents[0], "top_k keys")
        return list(parents[0])

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import TopKExecutor

        factory = functools.partial(TopKExecutor, self.by, self.k, self.descending)
        local = graph.new_exec_node(
            factory, {0: (actor_of[self.parents[0]], _passthrough_edge())},
            self.channels or ctx.exec_channels, self.stage)
        actor_of[node_id] = graph.new_exec_node(
            factory, {0: (local, _passthrough_edge())}, 1, self.stage)

    def describe(self):
        return f"TopK({self.by}, k={self.k})"


class SinkNode(Node):
    """Blocking collect target."""

    def derive_schema(self, parents):
        _require(self.schema, parents[0], "collect")
        return list(self.schema)

    def lower(self, ctx, graph, actor_of, node_id):
        from quokka_tpu_torch.executors.sql_execs import SelectingStorageExecutor

        actor_of[node_id] = graph.new_exec_node(
            functools.partial(SelectingStorageExecutor, list(self.schema)),
            {0: (actor_of[self.parents[0]], _passthrough_edge())},
            1, self.stage, blocking=True)

    def describe(self):
        return "Collect"
