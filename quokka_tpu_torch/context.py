"""QuokkaContext: the session object (port of ``quokka_tpu/context.py``).

Owns the logical-plan registry, the read_* entry points, the optimizer
driver and the lowering into the runtime.  ``device=None`` means CUDA: the
port runs on the card unless the caller asks for the CPU, and without a
card anything but ``device="cpu"`` raises at construction.

``mesh=`` (``parallel.make_mesh``) runs each collect over the shards of a
one-device mesh (``parallel/mesh_exec.py``); a plan shape the mesh does not
cover falls back to the engine with a logged warning, and the reason stays
in ``last_mesh_fallback`` (None after a collect that ran on the mesh).
"""

from __future__ import annotations

import copy
import datetime
import logging
from typing import Dict, List, Optional

from quokka_tpu_torch import config, logical
from quokka_tpu_torch.datastream import DataStream, OrderedStream
from quokka_tpu_torch.dataset.ordered import InputSortedParquetDataset
from quokka_tpu_torch.dataset.readers import (
    InputArrowDataset,
    InputHostDataset,
    InputParquetDataset,
)
from quokka_tpu_torch.runtime.engine import TaskGraph

_log = logging.getLogger("quokka_tpu_torch.mesh")


def _reader_schema(reader) -> List[str]:
    schema = reader.schema
    return list(getattr(schema, "names", schema))


class QuokkaContext:
    def __init__(self, cluster=None, io_channels: int = 2, exec_channels: int = 2,
                 exec_config: Optional[dict] = None, optimize: bool = True,
                 mesh=None, device=None):
        if cluster is not None:
            raise NotImplementedError("multi-process clusters come with the "
                                      "distributed-runtime slice of quokka_tpu_torch")
        config.check_exec_config(exec_config)
        if mesh is not None:
            from quokka_tpu_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh= takes a parallel.mesh.Mesh, got {type(mesh).__name__}")
            if device is None:
                device = mesh.device
        self.device = config.resolve_device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh lies on {mesh.device}, the context on {self.device}")
        self.mesh = mesh
        self.last_mesh_fallback: Optional[str] = None
        self.io_channels = io_channels
        self.exec_channels = exec_channels
        self.exec_config = dict(config.DEFAULT_EXEC_CONFIG)
        if exec_config:
            self.exec_config.update(exec_config)
        self.optimize_plans = optimize
        self.nodes: Dict[int, logical.Node] = {}
        self._next_node = 0
        self.latest_graph = None

    # -- plan registry --------------------------------------------------------
    def add_node(self, node: logical.Node) -> int:
        nid = self._next_node
        self.nodes[nid] = node
        self._next_node += 1
        return nid

    def new_stream(self, node: logical.Node, ordered: bool = False) -> DataStream:
        cls = OrderedStream if ordered else DataStream
        return cls(self, self.add_node(node))

    # -- readers ---------------------------------------------------------------
    def read_parquet(self, path, columns=None) -> DataStream:
        reader = InputParquetDataset(path, columns=columns)
        schema = list(columns) if columns else _reader_schema(reader)
        return self.new_stream(logical.SourceNode(reader, schema))

    def read_dataset(self, reader, schema=None, sorted_by=None) -> DataStream:
        """Any reader with get_own_state / execute (see dataset/readers.py).
        With ``sorted_by`` (a column or a list) the reader promises its
        channels' lineages in global time order (dataset/ordered.py deals
        them out so) and the result is an OrderedStream."""
        if isinstance(sorted_by, str):
            sorted_by = [sorted_by]
        schema = list(schema or _reader_schema(reader))
        return self.new_stream(logical.SourceNode(reader, schema, sorted_by=sorted_by),
                               ordered=sorted_by is not None)

    def read_sorted_parquet(self, path, sorted_by: str, columns=None,
                            mode: str = "stride") -> OrderedStream:
        """Time-ordered Parquet scan: row groups ordered by their min/max
        statistics on ``sorted_by``, non-overlap asserted, dealt to channels
        in ``mode`` ("stride" or "range")."""
        reader = InputSortedParquetDataset(path, sorted_by, columns=columns, mode=mode)
        schema = list(columns) if columns else _reader_schema(reader)
        return self.new_stream(logical.SourceNode(reader, schema, sorted_by=[sorted_by]),
                               ordered=True)

    def read_sorted_csv(self, *args, **kwargs):
        raise NotImplementedError(
            "read_sorted_csv waits for the CSV reader: ROADMAP Queue 1, \"The rest of the "
            "time-series tier\"")

    def from_arrow_sorted(self, table, sorted_by: str) -> OrderedStream:
        return self.new_stream(logical.SourceNode(InputArrowDataset(table),
                                                  list(table.column_names),
                                                  sorted_by=[sorted_by]), ordered=True)

    def from_arrow(self, table) -> DataStream:
        return self.new_stream(logical.SourceNode(InputArrowDataset(table),
                                                  list(table.column_names)))

    def from_pandas(self, df) -> DataStream:
        from quokka_tpu_torch.ops.bridge import HostTable
        import numpy as np

        cols, validity = {}, {}
        for name in df.columns:
            s = df[name]
            if s.dtype == object or str(s.dtype) in ("string", "str"):
                vals = [None if v is None or v != v else v for v in s.tolist()]
                first = next((v for v in vals if v is not None), None)
                if isinstance(first, datetime.date):
                    cols[name] = np.array(["NaT" if v is None else v for v in vals],
                                          dtype="datetime64[D]")
                else:
                    cols[name] = np.array(vals, dtype=object)
            elif s.hasnans and s.dtype.kind in ("i", "u", "b"):
                validity[name] = s.notna().to_numpy()
                cols[name] = s.fillna(0).to_numpy()
            else:
                cols[name] = s.to_numpy()
        table = HostTable(cols, validity)
        return self.new_stream(logical.SourceNode(InputHostDataset(table),
                                                  list(table.column_names)))

    # -- execution ---------------------------------------------------------------
    def _prepare_plan(self, node_id: int):
        sub, mapping = self._copy_subgraph(node_id)
        sink_id = mapping[node_id]
        if not isinstance(sub[sink_id], logical.SinkNode):
            sink = logical.SinkNode([sink_id], sub[sink_id].schema)
            sub_sink_id = max(sub) + 1
            sub[sub_sink_id] = sink
            sink_id = sub_sink_id
        if self.optimize_plans:
            from quokka_tpu_torch.optimizer import optimize
            from quokka_tpu_torch.planner import decide

            # the optimizer's decision log for this plan (taken at lowering)
            decide.begin_decisions()
            sink_id = optimize(sub, sink_id)
        return sub, sink_id

    def execute_node(self, node_id: int):
        """Run a plan to completion.  The query's operator statistics are
        on the ledger afterwards: EXPLAIN ANALYZE is
        ``obs.explain.render(obs.OPSTATS.last_finished())``."""
        from quokka_tpu_torch.planner import decide
        from quokka_tpu_torch.runtime.engine import plan_fingerprint

        sub, sink_id = self._prepare_plan(node_id)
        if self.mesh is not None:
            ds = self._execute_on_mesh(sub, sink_id)
            if ds is not None:
                return ds
        self._assign_stages(sub, sink_id)
        graph = TaskGraph(self.device, self.exec_config)
        actor_of: Dict[int, int] = {}
        for nid in self._toposort(sub, sink_id):
            sub[nid].lower(self, graph, actor_of, nid)
        # the decision log and the plan's fingerprint ride the graph to the
        # ledger (register_plan), which keys measured cardinalities by it
        graph.planner_decisions = decide.take_decisions()
        graph.plan_fp = plan_fingerprint(graph)
        self.latest_graph = graph
        try:
            graph.run()
        finally:
            graph.cleanup()
        ds = graph.result(actor_of[sink_id])
        ds.schema = list(sub[sink_id].schema)
        return ds

    def _execute_on_mesh(self, sub, sink_id: int):
        """The plan over the mesh, or None after a logged fallback: only a
        plan shape the mesh does not cover (``MeshUnsupported``) falls back;
        anything else, a kernel that does not build or launch among it,
        propagates."""
        from quokka_tpu_torch.parallel.mesh_exec import MeshExecutor, MeshUnsupported
        from quokka_tpu_torch.runtime.dataset import ResultDataset

        try:
            cols = MeshExecutor(self.mesh).run(sub, sink_id)
        except MeshUnsupported as e:
            # the mesh is an explicit request: a quiet single-device run
            # would misreport what ran
            self.last_mesh_fallback = str(e)
            _log.warning("mesh execution fell back to the engine: %s", e)
            return None
        self.last_mesh_fallback = None
        ds = ResultDataset(schema=list(sub[sink_id].schema))
        if cols is not None:  # None: a legitimately empty result
            ds.append(0, cols)
        return ds

    def _copy_subgraph(self, node_id: int):
        mapping: Dict[int, int] = {}
        sub: Dict[int, logical.Node] = {}

        def rec(nid: int) -> int:
            if nid in mapping:
                return mapping[nid]
            node = self.nodes[nid]
            cp = copy.copy(node)
            cp.parents = [rec(p) for p in node.parents]
            cp.schema = list(node.schema)
            mapping[nid] = nid
            sub[nid] = cp
            return nid

        rec(node_id)
        return sub, mapping

    def _toposort(self, sub: Dict[int, logical.Node], sink_id: int) -> List[int]:
        out: List[int] = []
        seen = set()

        def rec(nid):
            if nid in seen:
                return
            seen.add(nid)
            for p in sub[nid].parents:
                rec(p)
            out.append(nid)

        rec(sink_id)
        return out

    def _assign_stages(self, sub: Dict[int, logical.Node], sink_id: int) -> None:
        """Build-before-probe stage assignment: walking from the sink, a
        build parent's subtree gets stage - 1; then normalise to 0-based
        ascending so the engine runs stages in increasing order."""
        stage: Dict[int, int] = {}

        def rec(nid: int, s: int):
            # only re-walk a subtree when this visit lowers its stage
            if nid in stage and s >= stage[nid]:
                return
            stage[nid] = s
            node = sub[nid]
            for i, p in enumerate(node.parents):
                rec(p, s - 1 if i in node.build_parents else s)

        rec(sink_id, 0)
        lo = min(stage.values())
        for nid, s in stage.items():
            sub[nid].stage = s - lo

    def explain(self, node_id: int) -> str:
        sub, sink_id = self._prepare_plan(node_id)
        self._assign_stages(sub, sink_id)
        lines = []
        for nid in self._toposort(sub, sink_id):
            n = sub[nid]
            lines.append(f"{'  ' * n.stage}[{nid}] {n.describe()} stage={n.stage} "
                         f"schema={n.schema} parents={n.parents}")
        return "\n".join(lines)
