"""DataStream: the lazy relational API (port of ``quokka_tpu/datastream.py``:
filter, select, rename, with_columns, join, groupby + agg (with
count(distinct col) and count_distinct), distinct, top_k, collect,
nearest_neighbors, gramian, covariance, approximate_quantile, and
OrderedStream's time-series verbs: join_asof, window_agg and shift).

Every method appends a logical Node to the context's plan and returns a new
stream; nothing executes until collect() / compute().
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Union

from quokka_tpu_torch import logical, sqlparse
from quokka_tpu_torch.expression import Agg, Alias, ColRef, Expr, IsNull
from quokka_tpu_torch.ops.expr_compile import plan_aggregation
from quokka_tpu_torch.target_info import HashPartitioner, PassThroughPartitioner


def _not_in_slice(what: str):
    raise NotImplementedError(
        f"{what} is not in quokka_tpu_torch yet (it carries filter, select, rename, "
        "with_columns, join, groupby/agg, count(distinct), distinct, top_k, "
        "nearest_neighbors, gramian, covariance, approximate_quantile and collect; see "
        "ROADMAP.md for the "
        "slice that adds it)")


class DataStream:
    def __init__(self, ctx, node_id: int):
        self.ctx = ctx
        self.node_id = node_id

    @property
    def _node(self) -> logical.Node:
        return self.ctx.nodes[self.node_id]

    @property
    def schema(self) -> List[str]:
        return list(self._node.schema)

    def _child(self, node: logical.Node) -> "DataStream":
        return DataStream(self.ctx, self.ctx.add_node(node))

    def explain(self) -> str:
        return self.ctx.explain(self.node_id)

    # -- execution -----------------------------------------------------------
    def compute(self):
        """Execute and return the materialized ResultDataset."""
        return self.ctx.execute_node(self.node_id)

    def collect(self):
        """Execute; a pandas DataFrame where pandas imports, otherwise a
        dict of numpy arrays."""
        ds = self.compute()
        try:
            import pandas  # noqa: F401
        except ImportError:
            cols = ds.to_numpy()
            return cols if cols is not None else {c: [] for c in self.schema}
        return ds.to_df()

    def to_arrow(self):
        return self.compute().to_arrow()

    # -- row ops ---------------------------------------------------------------
    def filter(self, predicate: Union[Expr, str]) -> "DataStream":
        if isinstance(predicate, str):
            return self.filter_sql(predicate)
        if not isinstance(predicate, Expr):
            raise TypeError(f"filter takes an Expr or SQL text, got {type(predicate)}")
        missing = predicate.required_columns() - set(self.schema)
        if missing:
            raise ValueError(f"filter references unknown columns {missing}")
        return self._child(logical.FilterNode([self.node_id], self.schema, predicate))

    def filter_sql(self, sql: str) -> "DataStream":
        return self.filter(sqlparse.parse_expression(sql))

    def select(self, columns: Union[str, Sequence[str]]) -> "DataStream":
        columns = [columns] if isinstance(columns, str) else list(columns)
        missing = set(columns) - set(self.schema)
        if missing:
            raise ValueError(f"select references unknown columns {missing}")
        return self._child(logical.ProjectionNode([self.node_id], columns))

    def rename(self, mapping: Dict[str, str]) -> "DataStream":
        new_schema = [mapping.get(c, c) for c in self.schema]
        return self._child(logical.MapNode([self.node_id], new_schema,
                                           logical.RenameFn(dict(mapping)),
                                           rename=dict(mapping)))

    def with_columns(self, exprs: Dict[str, Union[Expr, str]]) -> "DataStream":
        compiled = {k: sqlparse.parse_expression(v) if isinstance(v, str) else v
                    for k, v in exprs.items()}
        for k, e in compiled.items():
            missing = e.required_columns() - set(self.schema)
            if missing:
                raise ValueError(f"with_columns {k} references unknown columns {missing}")
        new_schema = self.schema + [k for k in compiled if k not in self.schema]
        return self._child(logical.MapNode([self.node_id], new_schema,
                                           logical.WithColumnsFn(compiled), exprs=compiled))

    def with_columns_sql(self, sql: str) -> "DataStream":
        named = {}
        for e in sqlparse.parse_select_list(sql):
            if not isinstance(e, Alias):
                raise ValueError(f"with_columns_sql needs 'expr as name': {e.sql()}")
            named[e.name] = e.expr
        return self.with_columns(named)

    def groupby(self, keys: Union[str, Sequence[str]], orderby=None) -> "GroupedDataStream":
        if orderby is not None:
            _not_in_slice("groupby(orderby=...)")
        keys = [keys] if isinstance(keys, str) else list(keys)
        for k in keys:
            if k not in self.schema:
                raise ValueError(f"groupby key {k} not in {self.schema}")
        return GroupedDataStream(self, keys)

    def agg(self, aggregations: Dict) -> "DataStream":
        return GroupedDataStream(self, []).agg(aggregations)

    def agg_sql(self, sql: str) -> "DataStream":
        return GroupedDataStream(self, []).agg_sql(sql)

    aggregate = agg
    aggregate_sql = agg_sql

    def count_distinct(self, col_name: str) -> "DataStream":
        """The number of distinct non-null values of ``col_name``, lowered as
        SQL ``count(distinct col)`` is."""
        return GroupedDataStream(self, [])._agg_exprs(
            [Alias(Agg("count", ColRef(col_name), distinct=True), "count")])

    # -- joins -----------------------------------------------------------------
    def join(self, right: "DataStream", on: Optional[Union[str, Sequence[str]]] = None,
             left_on=None, right_on=None, how: str = "inner",
             suffix: str = "_2") -> "DataStream":
        from quokka_tpu_torch.ops.join import require_join_how

        require_join_how(how)
        if on is not None:
            left_on = right_on = [on] if isinstance(on, str) else list(on)
        else:
            left_on = [left_on] if isinstance(left_on, str) else list(left_on)
            right_on = [right_on] if isinstance(right_on, str) else list(right_on)
        for c in left_on:
            if c not in self.schema:
                raise ValueError(f"left join key {c} not in {self.schema}")
        for c in right_on:
            if c not in right.schema:
                raise ValueError(f"right join key {c} not in {right.schema}")
        rename = None
        if how in ("semi", "anti"):
            out_schema = self.schema
        else:
            rpayload = [c for c in right.schema if c not in set(right_on)]
            rename = {c: c + suffix for c in rpayload if c in set(self.schema)}
            out_schema = self.schema + [rename.get(c, c) for c in rpayload]
        return self._child(logical.JoinNode([self.node_id, right.node_id], out_schema,
                                            left_on, right_on, how, suffix, rename=rename))

    # -- vectors (reference datastream.py:324) ---------------------------------
    def nearest_neighbors(self, queries, vec_col: str, k: int, payload=None,
                          approximate: bool = False, nprobe: int = 4) -> "DataStream":
        """Top-k cosine matches of each query vector against this stream's
        ``vec_col`` vectors (exact, kernel K21).  ``approximate=True`` lets
        the optimizer push the search into an IVF sidecar index when the
        source has one (``dataset/vector.build_vector_index``): only the row
        groups owning the queries' ``nprobe`` closest cells are scanned."""
        import numpy as np

        from quokka_tpu_torch.executors.vector import (
            GlobalTopKReduceExecutor,
            NearestNeighborExecutor,
        )

        if vec_col not in self.schema:
            raise ValueError(f"nearest_neighbors column {vec_col} not in {self.schema}")
        queries = np.asarray(queries)
        payload_cols = list(payload) if payload else [c for c in self.schema if c != vec_col]
        out_schema = ["query_idx", "score"] + payload_cols
        local = logical.StatefulNode(
            [self.node_id], out_schema,
            functools.partial(NearestNeighborExecutor, queries, vec_col, k, payload_cols))
        if approximate:
            local.ann_info = {"queries": queries, "nprobe": int(nprobe)}
        local_id = self.ctx.add_node(local)
        reduce_node = logical.StatefulNode(
            [local_id], out_schema, functools.partial(GlobalTopKReduceExecutor, k))
        reduce_node.channels = 1
        return DataStream(self.ctx, self.ctx.add_node(reduce_node))

    vector_nn_join = nearest_neighbors

    # -- numeric extras (reference datastream.py:362-405) ----------------------
    def gramian(self, columns) -> "DataStream":
        return self._gramian(columns, covariance=False)

    def covariance(self, columns) -> "DataStream":
        return self._gramian(columns, covariance=True)

    def _gramian(self, columns, covariance: bool) -> "DataStream":
        from quokka_tpu_torch.executors.linalg import (
            CombineGramianExecutor,
            GramianExecutor,
        )

        columns = [columns] if isinstance(columns, str) else list(columns)
        missing = set(columns) - set(self.schema)
        if missing:
            raise ValueError(f"gramian references unknown columns {missing}")
        local = logical.StatefulNode(
            [self.node_id], ["__row"] + columns,
            functools.partial(GramianExecutor, columns, covariance))
        local_id = self.ctx.add_node(local)
        combine = logical.StatefulNode(
            [local_id], ["column"] + columns,
            functools.partial(CombineGramianExecutor, columns, covariance))
        combine.channels = 1
        return DataStream(self.ctx, self.ctx.add_node(combine))

    def approximate_quantile(self, column: str, quantiles) -> "DataStream":
        from quokka_tpu_torch.executors.linalg import (
            CombineQuantileExecutor,
            ReservoirQuantileExecutor,
        )

        if column not in self.schema:
            raise ValueError(f"approximate_quantile column {column} not in {self.schema}")
        quantiles = [quantiles] if isinstance(quantiles, (int, float)) else list(quantiles)
        local = logical.StatefulNode(
            [self.node_id], ["__td_mean", "__td_weight"],  # serialised t-digest centroids
            functools.partial(ReservoirQuantileExecutor, column, quantiles))
        local_id = self.ctx.add_node(local)
        combine = logical.StatefulNode(
            [local_id], ["quantile", column],
            functools.partial(CombineQuantileExecutor, column, quantiles))
        combine.channels = 1
        return DataStream(self.ctx, self.ctx.add_node(combine))

    def distinct(self, keys: Optional[Sequence[str]] = None) -> "DataStream":
        """One row per distinct value of ``keys`` (every column by default),
        hash-partitioned on them; the output holds the key columns only."""
        keys = list(keys) if keys else list(self.schema)
        missing = set(keys) - set(self.schema)
        if missing:
            raise ValueError(f"distinct references unknown columns {missing}")
        return self._child(logical.DistinctNode([self.node_id], keys, keys))

    # -- ordering ----------------------------------------------------------------
    def top_k(self, by, k: int, descending=None) -> "DataStream":
        by = [by] if isinstance(by, str) else list(by)
        descending = descending or [False] * len(by)
        return self._child(logical.TopKNode([self.node_id], self.schema, by, k, descending))

    # -- not in this slice -----------------------------------------------------

    def sort(self, *args, **kwargs):
        _not_in_slice("sort")



class GroupedDataStream:
    """groupby(...) handle -> agg / agg_sql."""

    def __init__(self, stream: DataStream, keys: List[str]):
        self.stream = stream
        self.keys = keys

    def agg(self, aggregations: Dict) -> DataStream:
        """{'col': 'sum' | ['sum','max'] | ...,  '*': 'count'}; output names
        col_sum, col_max, ..., count (the reference's naming)."""
        exprs: List[Alias] = []
        for c, specs in aggregations.items():
            specs = [specs] if isinstance(specs, str) else list(specs)
            for s in specs:
                s = s.lower()
                if c == "*":
                    if s != "count":
                        raise ValueError("only count supported for '*'")
                    exprs.append(Alias(Agg("count", None), "count"))
                else:
                    op = "avg" if s in ("mean", "avg") else s
                    exprs.append(Alias(Agg(op, ColRef(c)), f"{c}_{s}"))
        return self._agg_exprs(exprs)

    def agg_sql(self, sql: str) -> DataStream:
        exprs = sqlparse.parse_select_list(sql)
        return self._agg_exprs([e if isinstance(e, Alias) else Alias(e, f"col{i}")
                                for i, e in enumerate(exprs)])

    aggregate = agg
    aggregate_sql = agg_sql

    def _agg_exprs(self, exprs: List[Alias]) -> DataStream:
        rewritten = self._rewrite_count_distinct(exprs)
        if rewritten is not None:
            return rewritten
        plan = plan_aggregation(exprs)
        out_schema = self.keys + [n for n, _ in plan.finals if n not in self.keys]
        node = logical.AggNode([self.stream.node_id], out_schema, self.keys, plan)
        return self.stream._child(node)

    def _rewrite_count_distinct(self, exprs: List[Alias]) -> Optional[DataStream]:
        """``count(distinct x)`` lowers to distinct-then-count, as the
        reference's does (``datastream.py:563``): drop the rows where x is
        null, project the keys and x, de-duplicate them (a DistinctNode),
        then ``count(*)`` per key.  Only the pure form is rewritten: a
        mix with other aggregates, or a distinct count of an expression,
        raises ValueError."""
        cds = [a for a in exprs if _has_distinct(a.expr)]
        if not cds:
            return None
        if len(cds) != len(exprs) or len(cds) != 1 or not (
                isinstance(cds[0].expr, Agg) and cds[0].expr.distinct):
            raise ValueError(
                "count(distinct) cannot be mixed with other aggregates yet; "
                "compute it in a separate aggregation and join")
        a = cds[0]
        if a.expr.op != "count" or not isinstance(a.expr.arg, ColRef):
            raise ValueError("only count(distinct column) is supported")
        name = a.expr.arg.name
        deduped = (self.stream.filter(IsNull(ColRef(name), True))  # nulls do not count
                   .select(self.keys + [name]).distinct())
        return GroupedDataStream(deduped, self.keys)._agg_exprs(
            [Alias(Agg("count", None), a.name)])


def _has_distinct(e: Expr) -> bool:
    if isinstance(e, Agg) and e.distinct:
        return True
    return any(_has_distinct(c) for c in e.children())


def _time_series_rest(what: str):
    raise NotImplementedError(
        f"{what} is not in quokka_tpu_torch yet: ROADMAP Queue 1, \"The rest of the "
        "time-series tier\"")


def _key_partitioner(by: List[str]):
    return HashPartitioner(list(by)) if by else PassThroughPartitioner()


class OrderedStream(DataStream):
    """A stream with time-order metadata (the reference's OrderedStream,
    ``datastream.py:609``).  Order-preserving verbs keep it ordered; the
    time-series verbs (as-of join, window aggregation, shift) attach here."""

    @property
    def sorted_by(self):
        return self._node.sorted_by

    @property
    def time_col(self) -> str:
        if not self.sorted_by:
            raise ValueError("ordered stream has no sort column metadata")
        return self.sorted_by[0]

    def _ordered(self, node: logical.Node) -> "OrderedStream":
        node.sorted_by = self.sorted_by
        return OrderedStream(self.ctx, self.ctx.add_node(node))

    def _rewrap(self, ds: DataStream) -> DataStream:
        """Keep a DataStream verb's result ordered unless it dropped a sort
        column."""
        node = ds._node
        if self.sorted_by and all(c in node.schema for c in self.sorted_by):
            node.sorted_by = self.sorted_by
            return OrderedStream(self.ctx, ds.node_id)
        return ds

    # order-preserving relational verbs stay ordered
    def filter(self, predicate):
        return self._rewrap(DataStream.filter(self, predicate))

    def filter_sql(self, sql):
        return self.filter(sql)

    def select(self, columns):
        return self._rewrap(DataStream.select(self, columns))

    def with_columns(self, exprs):
        return self._rewrap(DataStream.with_columns(self, exprs))

    # -- as-of join ---------------------------------------------------------
    def join_asof(self, right: "OrderedStream", on: Optional[str] = None,
                  left_on: Optional[str] = None, right_on: Optional[str] = None, by=None,
                  left_by=None, right_by=None, suffix: str = "_2",
                  direction: str = "backward") -> "OrderedStream":
        from quokka_tpu_torch.executors.ts_execs import SortedAsofExecutor

        if direction not in ("backward", "forward"):
            raise NotImplementedError(f"join_asof direction {direction!r}")
        left_on = left_on or on or self.time_col
        right_on = right_on or on or right.time_col
        if by is not None:
            left_by = right_by = [by] if isinstance(by, str) else list(by)
        left_by = [left_by] if isinstance(left_by, str) else list(left_by or [])
        right_by = [right_by] if isinstance(right_by, str) else list(right_by or [])
        if len(left_by) != len(right_by):
            raise ValueError(f"join_asof by-keys differ in number: {left_by} vs {right_by}")
        for c in [left_on] + left_by:
            if c not in self.schema:
                raise ValueError(f"join_asof left column {c} not in {self.schema}")
        for c in [right_on] + right_by:
            if c not in right.schema:
                raise ValueError(f"join_asof right column {c} not in {right.schema}")
        rpayload = [c for c in right.schema if c not in set(right_by) and c != right_on]
        out_schema = self.schema + [c + suffix if c in set(self.schema) else c
                                    for c in rpayload]
        node = logical.AsofJoinNode(
            [self.node_id, right.node_id], out_schema,
            functools.partial(SortedAsofExecutor, left_on, right_on, left_by, right_by,
                              suffix, direction=direction),
            {0: _key_partitioner(left_by), 1: _key_partitioner(right_by)}, [left_on],
            left_on=left_on, right_on=right_on, left_by=left_by, right_by=right_by,
            suffix=suffix, direction=direction)
        return OrderedStream(self.ctx, self.ctx.add_node(node))

    # -- window aggregation -------------------------------------------------
    def window_agg(self, window, aggs_sql: str, by=None, trigger=None) -> "OrderedStream":
        from quokka_tpu_torch import windows as W
        from quokka_tpu_torch.executors.ts_execs import (
            HoppingWindowExecutor,
            SessionWindowExecutor,
            SlidingWindowExecutor,
        )

        by = [by] if isinstance(by, str) else list(by or [])
        for c in by:
            if c not in self.schema:
                raise ValueError(f"window_agg key {c} not in {self.schema}")
        time_col = self.time_col
        exprs = sqlparse.parse_select_list(aggs_sql)
        plan = plan_aggregation([e if isinstance(e, Alias) else Alias(e, f"col{i}")
                                 for i, e in enumerate(exprs)])
        if isinstance(window, (W.TumblingWindow, W.HoppingWindow)):
            factory = functools.partial(HoppingWindowExecutor, time_col, by, window, plan,
                                        trigger)
            extra = ["window_start", "window_end"]
        elif isinstance(window, W.SessionWindow):
            factory = functools.partial(SessionWindowExecutor, time_col, by, window, plan)
            extra = ["session_start", "session_end"]
        elif isinstance(window, W.SlidingWindow):
            factory = functools.partial(SlidingWindowExecutor, time_col, by, window, plan)
            extra = []
        else:
            raise TypeError(f"unknown window type {type(window)}")
        if isinstance(window, W.SlidingWindow):
            out_schema = self.schema + [n for n, _ in plan.finals]
            out_sorted = [time_col]  # per-event output keeps the time column
        else:
            out_schema = by + extra + [n for n, _ in plan.finals]
            out_sorted = [extra[0]]  # windows come out ordered by their start
        node = logical.WindowAggNode(
            [self.node_id], out_schema, factory, {0: _key_partitioner(by)}, out_sorted,
            time_col=time_col, by=by, window=window, plan=plan, trigger=trigger)
        return OrderedStream(self.ctx, self.ctx.add_node(node))

    def windowed_transform(self, window, aggs_sql: str, by=None, trigger=None):
        return self.window_agg(window, aggs_sql, by=by, trigger=trigger)

    # -- shift --------------------------------------------------------------
    def shift(self, columns, n: int = 1, by=None, fill_value=None) -> "OrderedStream":
        from quokka_tpu_torch.executors.ts_execs import ShiftExecutor

        if fill_value is not None:
            raise NotImplementedError("shift(fill_value=...): rows without history are null")
        columns = [columns] if isinstance(columns, str) else list(columns)
        by = [by] if isinstance(by, str) else list(by or [])
        for c in columns + by:
            if c not in self.schema:
                raise ValueError(f"shift column {c} not in {self.schema}")
        time_col = self.time_col
        node = logical.ShiftNode(
            [self.node_id], self.schema + [f"{c}_shifted_{n}" for c in columns],
            functools.partial(ShiftExecutor, time_col, by, columns, n),
            {0: _key_partitioner(by)}, [time_col],
            time_col=time_col, by=by, columns=columns, n=n)
        return self._ordered(node)

    # -- not ported yet -----------------------------------------------------
    def pattern_recognize(self, events, within, by=None):
        _time_series_rest("pattern_recognize (CEP, the reference's executors/cep.py)")

    def stateful_transform_sorted(self, executor, new_schema, by=None):
        _time_series_rest("stateful_transform_sorted")
