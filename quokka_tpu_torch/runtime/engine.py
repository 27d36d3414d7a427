"""Physical plan and push-based execution (port of
``quokka_tpu/runtime/engine.py``, the happy path).

``TaskGraph`` holds actors (input readers and executor channels) and the
edges between them; ``Engine`` runs it to completion on one task loop with
the reference's scheduling discipline: input tasks run only when their stage is
current, executor tasks consume contiguous runs of ready batches from one
source actor at a time (the lowest stage first, so a join's build side is
consumed before its probe side), and every produced batch is pushed through
its edge's partition function into the in-memory batch cache: one channel
(pass-through), every channel (broadcast) or a hash split (K4; K17 when the
split is compacted; K26 on an adapted exchange).  The
consumers of a sorted actor (a source read with ``sorted_by``, or an
ordered operator) take its batches in global (seq, channel) order and stop
at the first one not yet produced, as the reference's cache does.  An exec
actor may read several input streams; each stream's exhaustion reaches the
executor as ``source_done(stream)``.

The adaptive exchange (``planner/adapt.py``): while an eligible join-build
edge (``TaskGraph.adapt_edges``) is unadapted, the engine counts the rows
each of its target channels received; when one channel reaches the skew
ratio, it writes the build edge's salt record and the probe edge's
replicate record to the ADT table before the next build batch ships, and
the partition functions read them on every call.

Observability (``obs/``): every graph carries a query id; the engine feeds
the operator-statistics ledger at the reference's choke points (the plan at
start, scan batches, executor inputs and outputs with the current operator
marked on the thread, exchange edges on push, dispatch seconds, runtime
adaptations), resolves its deferred device counts at the flush cadence, and
``TaskGraph.cleanup`` hands the finished query to ``OPSTATS.on_query_gc``.
The input tasks run under the input actor's mark too, so the wire decode
(K23) and the source predicate (K1) are charged to the scan.

Host overlap, as the reference's: an IO pool (``quokka-io`` threads, two
to four) reads and lands each input channel's next lineage while the loop
runs other tasks, every stage-0 channel's first read starting before the
loop; a landed batch comes from the device scan cache
(``runtime/scancache.py``) when the reader names its bytes; and a blocking
sink's conversion to the host runs on one ``quokka-emit`` thread, in
order, at most ``_EMIT_INFLIGHT`` batches behind, flushed before a sink
channel is marked done.  The IO threads run on the default stream of the
graph's device, the stream the loop's kernels queue on, so a landed batch
is ordered before any kernel that reads it; the emitter copies on a stream
of its own into page-locked buffers, after an event the loop recorded at
the emit.  An error on either pool
reaches ``run``'s caller through the future that carried it.  Unlike the
reference, which leaves reads in flight at shutdown (``shutdown(wait=
False)``), ``run`` cancels the queued reads and waits for the running ones:
on the card a read that outlived its query would allocate device memory
and launch K23 inside the next query's measured window.

Left for later slices, and raising where a plan would need them:
checkpoints, spill, lineage replay and recovery, and the compile plane.
"""

from __future__ import annotations

import concurrent.futures
import copy
import hashlib
import threading
import time
import uuid
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.obs import opstats
from quokka_tpu_torch.ops import bridge, kernels
from quokka_tpu_torch.ops.batch import DeviceBatch
from quokka_tpu_torch.planner import adapt as adapt_mod
from quokka_tpu_torch.runtime import scancache
from quokka_tpu_torch.runtime.dataset import ResultDataset
from quokka_tpu_torch.runtime.tables import ControlStore
from quokka_tpu_torch.runtime.task import ExecutorTask, TapedInputTask
from quokka_tpu_torch.target_info import (
    BroadcastPartitioner,
    HashPartitioner,
    PassThroughPartitioner,
    TargetInfo,
)


# Guards the engine's lazily made pools against a double start.
_LAZY_INIT_LOCK = threading.Lock()


def new_query_id() -> str:
    """A fresh query id: short and unique for the process's lifetime."""
    return "q" + uuid.uuid4().hex[:10]


def _describe(obj) -> str:
    """A structural label of an executor factory or expression: its type
    and public fields, never an object address."""
    f = getattr(obj, "func", obj)
    name = getattr(f, "__qualname__", type(obj).__name__)
    state = getattr(obj, "keywords", None) or getattr(obj, "__dict__", {})
    return name + "(" + ",".join(f"{k}={v!r}" for k, v in sorted(state.items())
                                 if not k.startswith("_") and "object at" not in repr(v)) + ")"


def plan_fingerprint(graph) -> str:
    """Structural fingerprint of a lowered TaskGraph (actor kinds, channels,
    readers, executors, predicates, projections): the key the measured
    cardinalities persist under, stable across runs of the same plan."""
    parts = []
    for aid in sorted(graph.actors):
        info = graph.actors[aid]
        desc = [str(aid), info.kind, str(info.channels), str(info.stage)]
        if info.reader is not None:
            desc.append(type(info.reader).__name__)
        if info.executor_factory is not None:
            desc.append(_describe(info.executor_factory))
        if info.predicate is not None:
            desc.append(repr(getattr(info.predicate, "expr", None)))
        if info.projection:
            desc.append(",".join(info.projection))
        desc.append(",".join(str(t) for t in sorted(info.targets)))
        parts.append("|".join(desc))
    return hashlib.sha256(";".join(parts).encode()).hexdigest()[:16]


class ActorInfo:
    def __init__(self, actor_id, kind, channels, stage=0):
        self.id = actor_id
        self.kind = kind  # 'input' | 'exec'
        self.channels = channels
        self.stage = stage
        self.reader = None
        self.executor_factory = None
        self.targets: Dict[int, TargetInfo] = {}  # tgt_actor -> TargetInfo
        self.source_streams: Dict[int, int] = {}  # src_actor -> stream_id
        self.blocking_dataset: Optional[ResultDataset] = None
        self.sorted_by: Optional[List[str]] = None
        self.predicate = None  # pushed-down source filter (K1, post-read)
        self.projection: Optional[List[str]] = None


class BatchCache:
    """In-memory batch cache and input planning (the reference's
    ``runtime/cache.py`` contiguous policy): which pending batches an
    executor channel consumes next."""

    def __init__(self):
        self._data: Dict[Tuple, DeviceBatch] = {}
        self._index: Dict[Tuple, Dict[Tuple, Set[int]]] = defaultdict(lambda: defaultdict(set))

    def put(self, name: Tuple, batch: DeviceBatch) -> None:
        src_actor, src_ch, seq, tgt_actor, _, tgt_ch = name
        self._data[name] = batch
        self._index[(tgt_actor, tgt_ch)][(src_actor, src_ch)].add(seq)

    def get(self, name: Tuple) -> DeviceBatch:
        return self._data[name]

    def plan_get(self, tgt_actor: int, tgt_ch: int, input_reqs: Dict[int, Dict[int, int]],
                 actor_stages: Dict[int, int], max_batches: int,
                 sorted_actors: Set[int] = frozenset()):
        """(source actor, [names]) to consume next, or None: among sources at
        the lowest stage, the one with the most ready batches in its order
        (contiguous per channel; global (seq, channel) order for a sorted
        source)."""
        idx = self._index.get((tgt_actor, tgt_ch))
        if not idx:
            return None
        candidates = []
        for src_actor, chans in input_reqs.items():
            plan = self._plan_sorted if src_actor in sorted_actors else self._plan_contiguous
            names = plan(idx, src_actor, tgt_actor, tgt_ch, chans, max_batches)
            if names:
                candidates.append((actor_stages.get(src_actor, 0), -len(names),
                                   src_actor, names))
        if not candidates:
            return None
        candidates.sort()
        _, _, src_actor, names = candidates[0]
        return src_actor, names

    @staticmethod
    def _plan_contiguous(idx, src_actor, tgt_actor, tgt_ch, chans, max_batches):
        names = []
        for src_ch, next_seq in chans.items():
            have = idx.get((src_actor, src_ch), ())
            s = next_seq
            while s in have and len(names) < max_batches:
                names.append((src_actor, src_ch, s, tgt_actor, src_actor, tgt_ch))
                s += 1
            if len(names) >= max_batches:
                break
        return names

    @staticmethod
    def _plan_sorted(idx, src_actor, tgt_actor, tgt_ch, chans, max_batches):
        """Global (seq, channel) order across the source's channels, stopping
        at the first batch not yet there, so the order is never broken.
        Exhausted channels are already pruned from ``chans`` by the engine,
        so every frontier seq here will exist."""
        names = []
        frontier = dict(chans)  # channel -> next needed seq
        channels = sorted(frontier)
        if not channels:
            return names
        seq = min(frontier.values())
        while len(names) < max_batches:
            for ch in channels:
                if frontier[ch] != seq:
                    continue
                if seq not in idx.get((src_actor, ch), ()):
                    return names  # a hole: stop to keep the order
                names.append((src_actor, ch, seq, tgt_actor, src_actor, tgt_ch))
                frontier[ch] = seq + 1
                if len(names) >= max_batches:
                    return names
            later = [f for f in frontier.values() if f > seq]
            if not later:
                break
            seq = min(later)
        return names

    def gc(self, names) -> None:
        for name in names:
            self._data.pop(name, None)
            src_actor, src_ch, seq, tgt_actor, _, tgt_ch = name
            chans = self._index.get((tgt_actor, tgt_ch))
            if chans is not None:
                chans[(src_actor, src_ch)].discard(seq)


def _feeds(partitioner, src_ch: int, tgt_ch: int, n_tgt: int) -> bool:
    if isinstance(partitioner, PassThroughPartitioner):
        return src_ch % n_tgt == tgt_ch
    return True


class TaskGraph:
    """Physical plan builder.  ``device`` is where every batch of the query
    lives."""

    def __init__(self, device, exec_config: Optional[dict] = None,
                 query_id: Optional[str] = None):
        config.check_exec_config(exec_config)
        self.device = torch.device(device)
        # the ledger's key for this query; plan_fp and planner_decisions are
        # set by the context once the plan is lowered
        self.query_id = query_id or new_query_id()
        self.plan_fp: Optional[str] = None
        self.planner_decisions: List[dict] = []
        self.store = ControlStore()
        self.cache = BatchCache()
        self.exec_config = dict(config.DEFAULT_EXEC_CONFIG)
        if exec_config:
            self.exec_config.update(exec_config)
        self.actors: Dict[int, ActorInfo] = {}
        self._next_actor = 0
        # actors whose consumers read them in global (seq, channel) order
        self.sorted_actors: Set[int] = set()
        # adaptive-exchange eligibility (planner/decide.py, registered by
        # JoinNode.lower / FusedStageNode.lower): (build source actor, join
        # actor) -> {"probe_src": actor}; the skew trigger fires on these only
        self.adapt_edges: Dict[Tuple[int, int], dict] = {}

    def _new_actor(self, kind, channels, stage) -> ActorInfo:
        info = ActorInfo(self._next_actor, kind, channels, stage)
        self.actors[self._next_actor] = info
        self._next_actor += 1
        return info

    def new_input_reader_node(self, reader, channels: int, stage: int = 0,
                              sorted_by: Optional[List[str]] = None, predicate=None,
                              projection: Optional[List[str]] = None) -> int:
        info = self._new_actor("input", channels, stage)
        info.reader = reader
        info.sorted_by = sorted_by
        if predicate is not None:
            from quokka_tpu_torch.ops.fuse import FusedPredicate

            info.predicate = FusedPredicate(predicate)
        info.projection = projection
        if sorted_by is not None:
            self.sorted_actors.add(info.id)
        tapes = reader.get_own_state(channels)
        for ch in range(channels):
            lineages = tapes.get(ch, [])
            for seq, lineage in enumerate(lineages):
                self.store.tset("LT", (info.id, ch, seq), lineage)
            self.store.tset("LIT", (info.id, ch), len(lineages) - 1)
            self.store.ntt_push(info.id, TapedInputTask(info.id, ch, list(range(len(lineages)))))
        self.store.tset("AST", info.id, stage)
        return info.id

    def new_exec_node(self, executor_factory: Callable[[], object],
                      sources: Dict[int, Tuple[int, TargetInfo]], channels: int,
                      stage: int = 0, blocking: bool = False,
                      sorted_actor: bool = False) -> int:
        if len({a for a, _ in sources.values()}) != len(sources):
            raise NotImplementedError(
                "two streams from one actor (self-join / self-union) need relay "
                "actors, which quokka_tpu_torch does not carry yet")
        info = self._new_actor("exec", channels, stage)
        info.executor_factory = executor_factory
        if sorted_actor:
            self.sorted_actors.add(info.id)
        self.store.tset("AST", info.id, stage)
        if blocking:
            info.blocking_dataset = ResultDataset(f"ds-{info.id}")
        for stream_id, (src_actor, tinfo) in sources.items():
            self.actors[src_actor].targets[info.id] = tinfo
            info.source_streams[src_actor] = stream_id
            self.store.tset("PFT", (src_actor, info.id), tinfo)
        for ch in range(channels):
            reqs = {}
            for src_actor, tinfo in sources.values():
                src = self.actors[src_actor]
                reqs[src_actor] = {sch: 0 for sch in range(src.channels)
                                   if _feeds(tinfo.partitioner, sch, ch, channels)}
            self.store.ntt_push(info.id, ExecutorTask(info.id, ch, 0, 0, copy.deepcopy(reqs)))
        return info.id

    def run(self, timeout: float = 3600.0) -> None:
        Engine(self).run(timeout=timeout)

    def cleanup(self) -> None:
        """The query is over: the ledger's final snapshot (deferred counts
        resolved), the cardinality profile, devprof's per-query GC, and the
        scan cache's accounting of the query (its batches stay cached)."""
        scancache.GLOBAL.drop_query(self.query_id)
        opstats.OPSTATS.on_query_gc(self.query_id, plan_fp=self.plan_fp)

    def result(self, actor_id: int) -> ResultDataset:
        return self.actors[actor_id].blocking_dataset


class Engine:
    """Task manager + coordinator of the embedded runtime: one task loop, with
    its IO pool and emitter thread beside it."""

    def __init__(self, graph: TaskGraph):
        self.g = graph
        self.store = graph.store
        self.cache = graph.cache
        self.max_batches = graph.exec_config["max_pipeline_batches"]
        self.execs: Dict[Tuple[int, int], object] = {}
        self._partition_fns: Dict[Tuple[int, int], Callable] = {}
        for info in graph.actors.values():
            if info.kind == "exec":
                for ch in range(info.channels):
                    self.execs[(info.id, ch)] = info.executor_factory()
        self._stages = {a.id: a.stage for a in graph.actors.values()}
        # adaptive-exchange state: the edge -> record map mirrors the ADT
        # table; the row histograms and last-pushed sequences feed the trigger
        self._adapt: Dict[Tuple[int, int], dict] = dict(self.store.titems("ADT"))
        self._adapt_rows: Dict[Tuple[int, int], Dict[int, int]] = {}
        self._push_seqs: Dict[Tuple[int, int], int] = {}
        self.qid = graph.query_id
        self._dispatches = 0
        # the host-overlap pools, made on first use: the IO pool and its
        # one read a channel ((actor, channel) -> (seq, future)), the
        # emitter and its futures in order
        self._prefetch_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._prefetch: Optional[dict] = None
        self._emit_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._emit_futs: List[concurrent.futures.Future] = []
        self._emit_lock = threading.Lock()
        self._emit_stream: Optional[torch.cuda.Stream] = None  # the emitter's copies, on the card
        dev = graph.device
        self._cuda_index = (None if dev.type != "cuda" else
                            dev.index if dev.index is not None else torch.cuda.current_device())
        # the plan's topology on the ledger, exec actors labelled with their
        # executor (a fused stage with its member chain)
        opstats.OPSTATS.register_plan(
            graph, op_names={aid: getattr(ex, "OP_NAME", type(ex).__name__)
                             for (aid, ch), ex in self.execs.items()})

    # the ledger's deferred device counts resolve every this many completed
    # dispatches (and at the query's final snapshot), in one batched read
    _FLUSH_EVERY = 1024

    @staticmethod
    def _rows_of(batch):
        """Host count if known, else the batch's device count (resolved at
        the flush), else None (unknown: never read for a statistic)."""
        if batch is None:
            return 0
        if batch.nrows is not None:
            return batch.nrows
        return batch.nrows_dev

    # -- partition function lowering ----------------------------------------
    def _partition_fn(self, src_actor: int, tgt_actor: int) -> Callable:
        key = (src_actor, tgt_actor)
        fn = self._partition_fns.get(key)
        if fn is not None:
            return fn
        tinfo: TargetInfo = self.store.tget("PFT", key)
        n_tgt = self.g.actors[tgt_actor].channels
        part = tinfo.partitioner
        if not isinstance(part, (PassThroughPartitioner, BroadcastPartitioner,
                                 HashPartitioner)):
            raise NotImplementedError(type(part))

        def fn(batch: DeviceBatch, src_ch: int, seq: int) -> Dict[int, DeviceBatch]:
            if isinstance(part, PassThroughPartitioner):
                return {src_ch % n_tgt: batch}
            if isinstance(part, BroadcastPartitioner):
                return {ch: batch for ch in range(n_tgt)}
            # an ADT record rewrites this edge's routing: salt the fat build
            # partition from its recorded sequence on, or replicate the fat
            # probe partition to every channel.  Looked up on every call:
            # the record can appear mid-run.
            ad = self._adapt.get(key)
            if ad is not None and ad["mode"] == "replicate":
                return dict(enumerate(adapt_mod.replicate_split(batch, part.keys, ad["fat"],
                                                                n_tgt)))
            if (ad is not None and ad["mode"] == "salt"
                    and seq >= ad["from_seq"].get(src_ch, 0)):
                return dict(enumerate(adapt_mod.salt_split(batch, part.keys, ad["fat"], n_tgt)))
            return dict(enumerate(kernels.hash_split(batch, part.keys, n_tgt)))

        self._partition_fns[key] = fn
        return fn

    def push(self, actor: int, channel: int, seq: int, batch: DeviceBatch) -> None:
        info = self.g.actors[actor]
        for tgt_actor in info.targets:
            parts = self._partition_fn(actor, tgt_actor)(batch, channel, seq)
            # the skew histogram, only while an eligible build edge is
            # unadapted: the rows each target channel received (a read of
            # each part's device count, a wait on an already queued sum)
            edge = (actor, tgt_actor)
            track = None
            if (edge in self.g.adapt_edges and config.adapt_enabled()
                    and edge not in self._adapt):
                track = self._adapt_rows.setdefault(edge, {})
            for tgt_ch, part in parts.items():
                # delivered rows per (edge, target channel): the skew report
                opstats.OPSTATS.edge(self.qid, actor, tgt_actor, tgt_ch, self._rows_of(part))
                if track is not None:
                    n = part.nrows if part.nrows is not None else int(
                        part.nrows_dev if part.nrows_dev is not None else part.valid.sum())
                    track[tgt_ch] = track.get(tgt_ch, 0) + n
                self.cache.put((actor, channel, seq, tgt_actor, actor, tgt_ch), part)
            if track is not None:
                self._push_seqs[(actor, channel)] = seq
                self._adapt_consider(edge, info.channels, self.g.actors[tgt_actor].channels)
        self._push_seqs[(actor, channel)] = seq

    def _adapt_consider(self, edge: Tuple[int, int], src_channels: int, n_tgt: int) -> None:
        """Evaluate the skew trigger for one eligible build edge; on fire,
        write the (build, probe) ADT records before any batch ships under
        the new routing, then install them."""
        fat = adapt_mod.skewed_channel(self._adapt_rows.get(edge, {}), n_tgt,
                                       config.skew_ratio_threshold())
        if fat is None:
            return
        src, tgt = edge
        probe = self.g.adapt_edges[edge]["probe_src"]
        probe_edge = (probe, tgt)
        # replicating the fat probe partition is exactly-once only if no
        # probe batch shipped under the old routing (stage gating keeps the
        # probe side unread while its join's build runs; this guards it)
        tinfo = self.store.tget("PFT", probe_edge)
        if (any(a == probe for (a, _ch) in self._push_seqs) or tinfo is None
                or not isinstance(tinfo.partitioner, HashPartitioner)):
            del self.g.adapt_edges[edge]  # too late, or not a hash exchange
            return
        from_seq = {ch: self._push_seqs.get((src, ch), -1) + 1 for ch in range(src_channels)}
        build_rec, probe_rec = adapt_mod.build_records(fat, from_seq)
        with self.store.transaction():
            self.store.tset("ADT", edge, build_rec)
            self.store.tset("ADT", probe_edge, probe_rec)
        self._adapt[edge] = build_rec
        self._adapt[probe_edge] = probe_rec
        hist = self._adapt_rows.get(edge, {})
        total = sum(hist.values())
        mean = total / max(n_tgt, 1)
        opstats.OPSTATS.note_adaptation(
            self.qid,
            {"kind": "adapt_runtime", "edge": f"a{src}->a{tgt}",
             "fat_channel": int(fat), "fat_rows": int(hist.get(fat, 0)),
             "mean_rows": round(mean), "total_rows": int(total),
             "ratio": round(hist.get(fat, 0) / mean, 2) if mean else None,
             "action": f"salt build partition {fat} across {n_tgt} "
                       f"channels, replicate probe partition {fat}"})

    # -- input ----------------------------------------------------------------
    def _read_and_bridge(self, info: ActorInfo, channel: int, lineage) -> DeviceBatch:
        """Read one lineage and land it on the device: the read, the
        projection, the host encode, one copy and K23.  Runs on the IO
        threads (the first read of a channel the pool did not warm runs on
        the loop).  A lineage whose bytes the reader names comes from the
        scan cache when it is there: no read, encode, copy or K23."""
        ckey = None
        key_fn = getattr(info.reader, "cache_key", None)
        if key_fn is not None and scancache.GLOBAL.enabled:
            base = key_fn(channel, lineage)
            if base is not None:
                ckey = (base, tuple(info.projection or ()), tuple(info.sorted_by or ()),
                        str(self.g.device))
                cached = scancache.GLOBAL.get(ckey, query=self.qid)
                if cached is not None:
                    return cached
        table = info.reader.execute(channel, lineage)
        if info.projection is not None:
            keep = [c for c in info.projection if c in table.column_names]
            table = table.select(keep)
        if isinstance(table, bridge.HostTable):
            batch = bridge.host_to_device(table, self.g.device, sorted_by=info.sorted_by)
        else:
            batch = bridge.arrow_to_device(table, self.g.device, sorted_by=info.sorted_by)
        if ckey is not None:
            scancache.GLOBAL.put(ckey, batch)
        return batch

    def _io_threads(self) -> int:
        n = sum(a.channels for a in self.g.actors.values() if a.kind == "input")
        return max(2, min(4, n))

    def _pool_init(self) -> None:
        """Each pool thread works on the graph's device (its default
        stream: the one the loop's kernels queue on)."""
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)

    def _ensure_prefetch_pool(self) -> dict:
        if self._prefetch is None:
            with _LAZY_INIT_LOCK:
                if self._prefetch is None:
                    self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
                        max_workers=self._io_threads(), thread_name_prefix="quokka-io",
                        initializer=self._pool_init)
                    self._prefetch = {}
        return self._prefetch

    def _io_read(self, info: ActorInfo, channel: int, lineage) -> DeviceBatch:
        # under the channel's operator mark, as the loop's read was: K23's
        # charges go to the scan
        with opstats.OPSTATS.current_op(self.qid, info.id, channel):
            return self._read_and_bridge(info, channel, lineage)

    def _submit_read(self, info: ActorInfo, channel: int, seq: int) -> None:
        lineage = self.store.tget("LT", (info.id, channel, seq))
        if lineage is not None:
            self._prefetch[(info.id, channel)] = (
                seq, self._prefetch_pool.submit(self._io_read, info, channel, lineage))

    def _take_prefetched(self, info: ActorInfo, task: TapedInputTask, seq: int) -> DeviceBatch:
        """The channel's batch for ``seq``: the IO pool's when it read this
        seq (its error raised here), else read on the loop; then the next
        seq's read goes to the pool while this batch computes."""
        pf = self._ensure_prefetch_pool()
        ent = pf.pop((task.actor, task.channel), None)
        batch = None
        if ent is not None:
            want, fut = ent
            if want == seq:
                batch = fut.result()
            elif not fut.cancel():
                fut.result()  # a read of another seq: its error is still an error
        if batch is None:
            lineage = self.store.tget("LT", (task.actor, task.channel, seq))
            batch = self._read_and_bridge(info, task.channel, lineage)
        nxt = task.peek_next_seq()
        if nxt is not None:
            self._submit_read(info, task.channel, nxt)
        return batch

    def _warm_prefetch(self, actors) -> None:
        """Start every stage-0 input channel's first read before the loop,
        so the first reads run side by side instead of each on first
        touch."""
        self._ensure_prefetch_pool()
        for info in actors:
            if info.kind == "input" and info.stage == 0:
                for ch in range(info.channels):
                    self._submit_read(info, ch, 0)  # none for a channel with no lineage

    def _shutdown_prefetch(self) -> None:
        """Cancel the queued reads and wait for the running ones: a read
        that outlived the query would land a batch on the device after it."""
        pool = self._prefetch_pool
        if pool is not None:
            self._prefetch_pool = None
            self._prefetch = None
            pool.shutdown(wait=True, cancel_futures=True)

    def _throttled(self, info: ActorInfo, src_ch: int, seq: int) -> bool:
        """Back-pressure: an input channel waits while seq runs more than
        max_pipeline ahead of its slowest consumer's watermark (EWT)."""
        if not info.targets:
            return False
        watermark = None
        for tgt_actor, tinfo in info.targets.items():
            tgt = self.g.actors[tgt_actor]
            for tgt_ch in range(tgt.channels):
                if not _feeds(tinfo.partitioner, src_ch, tgt_ch, tgt.channels):
                    continue
                w = self.store.tget("EWT", (info.id, src_ch, tgt_actor, tgt_ch), -1)
                watermark = w if watermark is None else min(watermark, w)
        return watermark is not None and seq > watermark + self.g.exec_config["max_pipeline"]

    def handle_input_task(self, task: TapedInputTask) -> bool:
        info = self.g.actors[task.actor]
        seq = task.current_seq()
        if seq is None:
            self.store.sadd("DST", (task.actor, task.channel), "done")
            return True
        if self._throttled(info, task.channel, seq):
            self.store.ntt_push(task.actor, task)
            return False
        with opstats.OPSTATS.current_op(self.qid, task.actor, task.channel):
            batch = self._take_prefetched(info, task, seq)
            rows_raw = self._rows_of(batch)  # what the reader read
            if info.predicate is not None:
                batch = info.predicate(batch)
        self.push(task.actor, task.channel, seq, batch)
        opstats.OPSTATS.scan(self.qid, task.actor, task.channel, rows_raw,
                             self._rows_of(batch), opstats.batch_nbytes(batch),
                             batch.padded_len)
        self.store.sadd("GIT", (task.actor, task.channel), seq)
        nxt = task.advance()
        if nxt.tape:
            self.store.ntt_push(task.actor, nxt)
        else:
            self.store.sadd("DST", (task.actor, task.channel), "done")
        return True

    # -- executors ------------------------------------------------------------
    def handle_exec_task(self, task: ExecutorTask) -> bool:
        info = self.g.actors[task.actor]
        executor = self.execs[(task.actor, task.channel)]
        out_seq = task.out_seq
        for src in list(task.input_reqs):
            chans = task.input_reqs[src]
            for ch in list(chans):
                if self.store.scontains("DST", (src, ch), "done"):
                    if chans[ch] > self.store.tget("LIT", (src, ch), -1):
                        del chans[ch]
            if not chans:
                del task.input_reqs[src]
                with opstats.OPSTATS.current_op(self.qid, task.actor, task.channel):
                    extra = executor.source_done(info.source_streams[src], task.channel)
                if extra is not None:
                    self._emit(info, task.channel, out_seq, extra)
                    opstats.OPSTATS.exec_out(self.qid, task.actor, task.channel,
                                             self._rows_of(extra))
                    out_seq += 1
        task.out_seq = out_seq
        if not task.input_reqs:
            with opstats.OPSTATS.current_op(self.qid, task.actor, task.channel):
                out = executor.done(task.channel)
            # a fused stage's done() may emit a list of batches
            for o in ([out] if out is None or isinstance(out, DeviceBatch) else out):
                if o is not None:
                    self._emit(info, task.channel, out_seq, o)
                    opstats.OPSTATS.exec_out(self.qid, task.actor, task.channel,
                                             self._rows_of(o))
                    out_seq += 1
            if info.blocking_dataset is not None:
                # every sink batch lands before DST says done: a consumer may
                # act on "done" at once
                self._flush_emits()
            self.store.tset("LIT", (task.actor, task.channel), out_seq - 1)
            self.store.sadd("DST", (task.actor, task.channel), "done")
            return True
        # a fused stage drains a wider slice of the ready queue per task
        plan = self.cache.plan_get(task.actor, task.channel, task.input_reqs, self._stages,
                                   getattr(executor, "MAX_PIPELINE_BATCHES", self.max_batches),
                                   self.g.sorted_actors)
        if plan is None:
            self.store.ntt_push(task.actor, task)
            return False
        src_actor, names = plan
        batches = [self.cache.get(n) for n in names]
        opstats.OPSTATS.exec_in(self.qid, task.actor, task.channel, batches)
        with opstats.OPSTATS.current_op(self.qid, task.actor, task.channel):
            out = executor.execute(batches, info.source_streams[src_actor], task.channel)
        if out is not None:
            self._emit(info, task.channel, out_seq, out)
            out_seq += 1
        opstats.OPSTATS.exec_out(self.qid, task.actor, task.channel, self._rows_of(out))
        consumed: Dict[int, Dict[int, int]] = {src_actor: {}}
        for (sa, sch, seq, *_rest) in names:
            consumed[sa][sch] = max(consumed[sa].get(sch, 0), seq + 1)
        for sch, nxt in consumed[src_actor].items():
            self.store.tset("EWT", (src_actor, sch, task.actor, task.channel), nxt - 1)
        self.cache.gc(names)
        self.store.ntt_push(task.actor, task.advance(consumed, out_seq))
        return True

    # at most this many sink batches wait on the emitter (it bounds the
    # device memory that unconverted batches hold)
    _EMIT_INFLIGHT = 8

    def _emit(self, info: ActorInfo, channel: int, seq: int, out: DeviceBatch) -> None:
        if info.blocking_dataset is not None:
            # a sink's conversion waits on the device and copies to the host:
            # it runs on the emitter so the loop keeps queueing device work;
            # one thread keeps the order, and appends are keyed by seq.  On
            # the card the copy waits for the loop's work so far (an event
            # on the loop's stream), not for what the loop queues after it
            ready = None
            if out.valid.is_cuda:
                ready = torch.cuda.Event()
                ready.record()
            self._emit_submit(lambda: self._convert_and_append(info, channel, seq, out, ready))
        else:
            self.push(info.id, channel, seq, out)

    def _convert_and_append(self, info: ActorInfo, channel: int, seq: int,
                            out: DeviceBatch, ready) -> None:
        if ready is None:
            host = bridge.device_to_host(out)
        else:
            # on the emitter's own stream, into page-locked buffers: the DMA
            # runs at the link's rate beside the loop's kernels, and holds
            # neither their stream nor the host.  ``out`` is held here until
            # its copies have ended, so its memory is not reused under them
            with torch.cuda.stream(self._emit_stream):
                self._emit_stream.wait_event(ready)
                host = bridge.device_to_host(out, pinned=True)
        info.blocking_dataset.append(channel, host, seq=seq)

    def _emit_submit(self, fn) -> None:
        if self._emit_pool is None:
            with _LAZY_INIT_LOCK:
                if self._emit_pool is None:
                    if self._cuda_index is not None:
                        self._emit_stream = torch.cuda.Stream(self._cuda_index)
                    self._emit_pool = concurrent.futures.ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="quokka-emit",
                        initializer=self._pool_init)
        with self._emit_lock:
            self._emit_futs.append(self._emit_pool.submit(fn))
        while True:
            with self._emit_lock:
                if len(self._emit_futs) <= self._EMIT_INFLIGHT:
                    break
                f = self._emit_futs.pop(0)
            f.result()  # outside the lock: the conversion waits on the device

    def _flush_emits(self) -> None:
        with self._emit_lock:
            futs, self._emit_futs = self._emit_futs, []
        for f in futs:
            f.result()  # the first conversion or append error raises here

    def _shutdown_emitter(self) -> None:
        pool = self._emit_pool
        if pool is not None:
            self._emit_pool = None
            pool.shutdown(wait=True, cancel_futures=True)

    # -- coordinator loop -----------------------------------------------------
    def run(self, timeout: float = 3600.0) -> None:
        """Run the graph to its end: the loop, then every sink batch landed;
        on the way out, with or without an error, both pools are shut down
        (queued work cancelled, running work waited for)."""
        try:
            self._run(timeout)
            self._flush_emits()
        finally:
            self._shutdown_prefetch()
            self._shutdown_emitter()

    def _run(self, timeout: float) -> None:
        actors = sorted(self.g.actors.values(), key=lambda a: (a.stage, a.id))
        self._warm_prefetch(actors)
        stages = sorted({a.stage for a in actors})
        stage_idx = 0
        t0 = time.time()
        while True:
            if time.time() - t0 > timeout:
                raise TimeoutError(f"engine run exceeded {timeout:.0f}s; pending "
                                   f"tasks: {self.store.ntt_total()}")
            current = stages[stage_idx]
            progress = False
            for info in actors:
                if info.kind == "input" and info.stage > current:
                    continue
                task = self.store.ntt_pop(info.id)
                if task is None:
                    continue
                progress |= self.dispatch_task(task)
            if self._all_done(actors):
                return
            while stage_idx < len(stages) - 1 and not self._stage_undone(
                    actors, stages[stage_idx]):
                stage_idx += 1
                progress = True
            if not progress:
                raise RuntimeError(
                    "engine stalled: no task progressed and the stage cannot advance "
                    f"(stage={stages[stage_idx]}, pending={self.store.ntt_total()})")

    def dispatch_task(self, task) -> bool:
        """Run one popped task; a completed dispatch's seconds go to the
        ledger, and every ``_FLUSH_EVERY`` of them its deferred counts
        resolve."""
        t0 = time.perf_counter()
        if task.name == "input":
            ok = self.handle_input_task(task)
        else:
            ok = self.handle_exec_task(task)
        if ok:
            opstats.OPSTATS.dispatch_time(self.qid, task.actor, task.channel,
                                          time.perf_counter() - t0)
            self._dispatches += 1
            if self._dispatches % self._FLUSH_EVERY == 0:
                opstats.OPSTATS.resolve_pending()
        return ok

    def _stage_undone(self, actors, stage) -> bool:
        return any(not self.store.scontains("DST", (info.id, ch), "done")
                   for info in actors if info.stage == stage
                   for ch in range(info.channels))

    def _all_done(self, actors) -> bool:
        return all(self.store.scontains("DST", (info.id, ch), "done")
                   for info in actors for ch in range(info.channels))
