"""Whole-stage fusion: run a maximal linear operator chain as one exec actor
(port of ``quokka_tpu/ops/stagefuse.py``: ``FusedElementwise``,
``StageSpec`` and ``FusedStageExecutor``).

The optimizer's ``fuse_stages`` pass rewrites single-consumer, non-blocking
chains (a hash join at the head, broadcast joins, filters, projections and
maps inside, a partial aggregate at the tail) into one ``FusedStageNode``,
which lowers to one actor running a ``FusedStageExecutor``: a member's
output feeds the next member in-process, with no store round trip and no
extra task dispatch between them.  Stream 0 cascades through the members;
each build stream routes to its join member.

Kernel K16, ``FusedElementwise``: consecutive filter / projection / map
members collapse into one generated Triton kernel per stage signature
(the reference's ``stage_elemwise`` key: input columns and dtypes, the
prepass-bound arrays, every conjunct and every map output).  Map and
filter expressions are inlined at plan time, so one pass over the
original columns evaluates every conjunct and every map output; it writes
the row mask (``valid`` and every conjunct), its count (each program adds
its block's count to one int32, an order-free integer sum) and one array
per map output, in the plain evaluator's dtypes.  String predicates are
bound to code masks by the host prepass first, so the kernel sees numbers
only.  A map output whose value is a string (a string column, or a
dictionary transform of one: ``lower``, ``upper``, ``strip``, ``slice``,
as TPC-H Q22's ``substring(c_phone, 1, 2)``) is evaluated by the host
prepass over the batch's codes (``expr_compile.DICT_TRANSFORMS``: the new
dictionary, deduplicated, and one gather of the codes) and carried beside
the kernel's outputs; K16 takes the numeric rest of the stage, and a
conjunct over the new column, inlined, is a string predicate that the
prepass binds to a code mask.  Bound: bytes (every input column read
once, the mask and each output written once); Triton serves for the reason
it serves K1 and K5: a fused elementwise pass over a few columns, known
only at query time, with no reuse across rows for shared memory or tensor
cores to exploit.
``elementwise_plain`` is its plain version, taken only when the batch lies
on the CPU.  The reference's per-step path (``_sequential``) is kept, for
CPU batches only, for what the kernel does not take (an expression outside
the generator's subset, string material left after the prepass, string
inputs) and counted in ``SEQUENTIAL``; on the card such a stage raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from quokka_tpu_torch.executors.base import Executor
from quokka_tpu_torch.expression import ColRef, Expr, StrOp, substitute_columns
from quokka_tpu_torch.obs import devprof, opstats
from quokka_tpu_torch.ops import expr_compile, kernels
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, StrCol
from quokka_tpu_torch.ops.fuse import (
    Prepass,
    _check_inputs,
    _consts_on,
    _infer_kind,
    _kernel_arg,
    _load_generated,
    _load_lines,
    _refs_string,
    _ShimBatch,
    triton_cdiv,
)

# launches of K16, and runs of the per-step path (CPU batches only)
ELEMWISE_LAUNCHES = 0
SEQUENTIAL = 0


class _ElemwiseKernel:
    """Generated source of one stage signature: the mask, its count and
    every map output in one pass."""

    def __init__(self, conjuncts: List[Expr], outputs: List[Tuple[str, Expr]], cols):
        gen = expr_compile.TritonExpr(
            {n: (f"c{i}", dt, kind) for i, (n, dt, kind) in enumerate(cols)})
        conds = [gen.bool_of(gen.value(e)) for e in conjuncts]
        stores = []
        for j, (_, e) in enumerate(outputs):
            v = gen.value(e)
            code = f"(tl.zeros(valid.shape, {v.dt}) + {v.code})" if v.scalar else v.code
            stores.append(f"    tl.store(o{j}_ptr + offs, {code}, mask=m)")
        self.consts = gen.consts
        args = ", ".join([f"c{i}_ptr" for i in range(len(cols))]
                         + ["valid_ptr", "consts_ptr", "mask_ptr", "count_ptr"]
                         + [f"o{j}_ptr" for j in range(len(outputs))]
                         + ["n", "BLOCK: tl.constexpr"])
        body = [
            "    pid = tl.program_id(0)",
            "    offs = pid * BLOCK + tl.arange(0, BLOCK)",
            "    m = offs < n",
            "    valid = tl.load(valid_ptr + offs, mask=m, other=0) != 0",
            *_load_lines([(n, dt) for n, dt, _ in cols], "    "),
            *[f"    {l}" for l in gen.lines],
            "    res = valid" + "".join(f" & ({c})" for c in conds),
            "    tl.store(mask_ptr + offs, res.to(tl.uint8), mask=m)",
            "    tl.atomic_add(count_ptr, tl.sum(res.to(tl.int32), axis=0))",
            *stores,
        ]
        self.src = f"@triton.jit\ndef qk_elemwise({args}):\n" + "\n".join(body) + "\n"


def elementwise_plain(conjuncts: List[Expr], outputs: List[Tuple[str, Expr]],
                      columns: Dict[str, torch.Tensor], kinds: Dict[str, str],
                      valid: torch.Tensor):
    """Plain version of K16: (mask, live count, [output columns])."""
    shim = _ShimBatch(columns, valid, kinds)
    m = valid
    for e in conjuncts:
        m = m & expr_compile.evaluate_predicate(e, shim)
    outs = [expr_compile.evaluate_to_column(e, shim) for _, e in outputs]
    return m, m.sum(dtype=torch.int32), outs


def elementwise_launch(kern: _ElemwiseKernel, inputs: List[torch.Tensor],
                       valid: torch.Tensor, out_dtypes: List[torch.dtype]):
    """Launch K16 on CUDA tensors: (mask, live count, [output arrays])."""
    global ELEMWISE_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    _check_inputs(inputs + [valid], dev, n)
    mod = _load_generated(kern.src)
    mask = torch.empty(n, dtype=torch.uint8, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    outs = [torch.empty(n, dtype=dt, device=dev) for dt in out_dtypes]
    if n:
        block = 1024
        mod.qk_elemwise[(triton_cdiv(n, block),)](
            *[_kernel_arg(t) for t in inputs], valid.view(torch.uint8),
            _consts_on(kern, dev), mask, count, *[_kernel_arg(o) for o in outs], n,
            BLOCK=block, num_warps=4)
    ELEMWISE_LAUNCHES += 1
    return mask.view(torch.bool), count[0], outs


def _string_valued(e: Expr, batch: DeviceBatch) -> bool:
    """Is e a string column of the batch, or a dictionary transform of one?"""
    if isinstance(e, ColRef):
        return isinstance(batch.columns.get(e.name), StrCol)
    return (isinstance(e, StrOp) and e.op in expr_compile.DICT_TRANSFORMS
            and _string_valued(e.expr, batch))


@dataclasses.dataclass
class ElemwiseCall:
    """Everything one K16 call needs, for the kernel and its plain version;
    ``strings`` are the stage's string-valued outputs, evaluated by the
    host prepass (no kernel writes them)."""

    kern: _ElemwiseKernel
    conjuncts: List[Expr]
    outputs: List[Tuple[str, Expr]]
    inputs: Dict[str, torch.Tensor]
    kinds: Dict[str, str]
    valid: torch.Tensor
    out_dtypes: List[torch.dtype]
    strings: Dict[str, StrCol] = dataclasses.field(default_factory=dict)

    def plain(self):
        m, num, outs = elementwise_plain(self.conjuncts, self.outputs, self.inputs,
                                         self.kinds, self.valid)
        return m, num, [c.data for c in outs]

    def launch(self):
        return elementwise_launch(self.kern, list(self.inputs.values()), self.valid,
                                  self.out_dtypes)

    def run(self):
        """K16 on CUDA tensors, the plain version on CPU ones, charged to
        devprof: inputs and mask read, the mask, its count and every output
        written."""
        n = self.valid.shape[0]
        out = n + 4 + n * sum(torch.empty((), dtype=dt).element_size()
                              for dt in self.out_dtypes)
        devprof.on_dispatch(
            ("K16", self.valid.device.type, n, tuple(str(t.dtype) for t in self.inputs.values()),
             tuple(str(dt) for dt in self.out_dtypes)),
            lambda: (0.0, float(devprof.nbytes(*self.inputs.values(), self.valid) + out),
                     float(out)))
        return self.plain() if self.valid.device.type == "cpu" else self.launch()


class FusedElementwise:
    """Fused filter / project / map pipeline: one K16 launch per batch
    computes the combined row mask and every derived column.

    ``steps`` is the chain segment in execution order:
      ("filter", Expr) | ("project", [cols]) | ("map", [(name, Expr), ...])
    Later steps see earlier map definitions inlined, so the kernel
    evaluates everything against the original input columns: filters and
    maps commute because masks only narrow ``valid`` and expressions are
    evaluated over every padded row anyway."""

    def __init__(self, steps: Sequence[Tuple]):
        self.steps = [tuple(s) for s in steps]
        env: Dict[str, Expr] = {}
        conjuncts: List[Expr] = []
        visible: Optional[List[str]] = None  # None: every input column passes
        for kind, payload in self.steps:
            if kind == "filter":
                conjuncts.append(substitute_columns(payload, env))
            elif kind == "map":
                for name, e in payload:
                    env[name] = substitute_columns(e, env)
                if visible is not None:
                    visible += [n for n, _ in payload if n not in visible]
            elif kind == "project":
                visible = list(payload)
            else:
                raise ValueError(f"unknown stagefuse step {kind!r}")
        self._conjuncts = conjuncts
        self._visible = visible
        # the computed outputs the kernel must produce (a projection may drop some)
        names = visible if visible is not None else list(env)
        self._outputs = [(n, env[n]) for n in names if n in env]
        self._kernels: Dict[Tuple, Optional[Tuple[_ElemwiseKernel, List[torch.dtype], List[str]]]] = {}

    def _sequential(self, batch: DeviceBatch) -> DeviceBatch:
        """The reference's per-step path: one evaluation per step."""
        global SEQUENTIAL
        SEQUENTIAL += 1
        b = batch
        for kind, payload in self.steps:
            if kind == "filter":
                b = kernels.apply_mask(b, expr_compile.evaluate_predicate(payload, b))
            elif kind == "map":
                for name, e in payload:
                    b = b.with_column(name, expr_compile.evaluate_to_column(e, b))
            else:
                b = b.select([c for c in payload if c in b.columns])
        return b

    def prepare(self, batch: DeviceBatch) -> Optional[Tuple[ElemwiseCall, List[str]]]:
        """The K16 call of this batch and its output kinds, or None when the
        batch must take the per-step path."""
        pre = Prepass(batch)
        try:
            strings = {n: expr_compile.evaluate(e, batch) for n, e in self._outputs
                       if _string_valued(e, batch)}
            conjuncts = [pre.rewrite(e) for e in self._conjuncts]
            outputs = [(n, pre.rewrite(e)) for n, e in self._outputs if n not in strings]
        except expr_compile.CompileError:
            return None
        exprs = conjuncts + [e for _, e in outputs]
        if any(_refs_string(e, batch) for e in exprs):
            return None
        needed = set()
        for e in exprs:
            needed |= e.required_columns()
        inputs: Dict[str, torch.Tensor] = {}
        kinds: Dict[str, str] = {}
        for n in sorted(needed):
            c = batch.columns.get(n)
            if c is None:
                continue  # a prepass-bound array
            if not isinstance(c, NumCol):
                return None
            inputs[n] = c.data.contiguous()
            kinds[n] = c.kind
        for n, t in pre.bound.items():
            inputs[n] = t.contiguous()
            kinds[n] = _infer_kind(t)
        cols = [(n, t.dtype, kinds[n]) for n, t in inputs.items()]
        sig = (tuple(e.sql() for e in conjuncts), tuple((n, e.sql()) for n, e in outputs),
               tuple(cols))
        if sig not in self._kernels:
            # a signature outside the generator's subset is remembered as None
            try:
                kern = _ElemwiseKernel(conjuncts, outputs, cols)
                # output dtypes and kinds are the plain evaluator's, read off a
                # 0-row evaluation once per signature
                _, _, zero = elementwise_plain(conjuncts, outputs,
                                               {n: t[:0] for n, t in inputs.items()},
                                               kinds, batch.valid[:0])
                self._kernels[sig] = (kern, [c.data.dtype for c in zero],
                                      [c.kind for c in zero])
            except expr_compile.CompileError:
                self._kernels[sig] = None
        hit = self._kernels[sig]
        if hit is None:
            return None
        kern, dts, out_kinds = hit
        return ElemwiseCall(kern, conjuncts, outputs, inputs, kinds, batch.valid, dts,
                            strings), out_kinds

    def __call__(self, batch: DeviceBatch) -> DeviceBatch:
        if not self._conjuncts and not self._outputs:
            return batch.select(self._visible)  # a projection alone
        prep = self.prepare(batch)
        if prep is None:
            if batch.device.type != "cpu":
                raise NotImplementedError(
                    "a fused stage outside K16's subset (an expression the generator "
                    "does not take, string material left after the prepass, a "
                    "non-numeric input) is not ported to quokka_tpu_torch yet: "
                    "ROADMAP Queue 1, \"The rest of the DataStream/SQL surface\"")
            return self._sequential(batch)
        call, out_kinds = prep
        mask, num, arrays = call.run()
        computed = {name: NumCol(arr, kind)
                    for (name, _), arr, kind in zip(call.outputs, arrays, out_kinds)}
        computed.update(call.strings)
        computed = {n: computed[n] for n, _ in self._outputs}  # definition order
        if self._visible is None:
            # a recomputed column keeps its position, new names append in
            # definition order (DeviceBatch.with_column's order)
            names = list(batch.columns) + [n for n in computed if n not in batch.columns]
        else:
            names = self._visible
        cols = {n: computed[n] if n in computed else batch.columns[n] for n in names}
        sorted_by = batch.sorted_by
        if sorted_by is not None and not all(c in cols for c in sorted_by):
            sorted_by = None
        return DeviceBatch(cols, mask, None, sorted_by).note_count(num)


class StageSpec:
    """The member executor steps in chain order (label, factory) plus the
    fused actor's stream routing {stream: (member index, member stream)}."""

    def __init__(self, steps: Sequence[Tuple[str, Callable]],
                 routing: Dict[int, Tuple[int, int]]):
        self.steps = [tuple(s) for s in steps]
        self.routing = dict(routing)


class FusedStageExecutor(Executor):
    """One actor running a whole fused stage."""

    # one fused dispatch does the work of the whole member chain: drain a
    # wider slice of the ready queue per task than the per-operator default
    MAX_PIPELINE_BATCHES = 32

    def __init__(self, spec: StageSpec):
        self.steps = [factory() for _, factory in spec.steps]
        self.labels = [label for label, _ in spec.steps]
        self.routing = spec.routing
        # the ledger's operator label: the member chain
        self.OP_NAME = "FusedStage[" + ">".join(self.labels) + "]"

    def _note_rows(self, idx: int, out: Optional[DeviceBatch]) -> None:
        """Per-member rows on the fused actor's ledger record (host-known
        rows, else the padded length: never a device read)."""
        if out is None:
            return
        rows = out.nrows if out.nrows is not None else out.padded_len
        opstats.note(**{f"fused{idx}_{self.labels[idx]}_rows": rows})

    def _cascade(self, start: int, out: Optional[DeviceBatch],
                 channel: int) -> Optional[DeviceBatch]:
        for i in range(start, len(self.steps)):
            if out is None:
                return None
            out = self.steps[i].execute([out], 0, channel)
            self._note_rows(i, out)
        return out

    def execute(self, batches, stream_id, channel):
        idx, sub_stream = self.routing.get(stream_id, (0, 0))
        out = self.steps[idx].execute(batches, sub_stream, channel)
        self._note_rows(idx, out)
        return self._cascade(idx + 1, out, channel)

    def source_done(self, stream_id, channel):
        idx, sub_stream = self.routing.get(stream_id, (0, 0))
        out = self.steps[idx].source_done(sub_stream, channel)
        self._note_rows(idx, out)
        return self._cascade(idx + 1, out, channel)

    def done(self, channel) -> Optional[List[DeviceBatch]]:
        # interior members learn "main input exhausted" here: each member's
        # done() output feeds the rest of the chain before the next member
        # finalizes, the order the unfused actors would deliver it in
        pending: List[DeviceBatch] = []
        for i, m in enumerate(self.steps):
            outs: List[DeviceBatch] = []
            for b in pending:
                o = m.execute([b], 0, channel)
                self._note_rows(i, o)
                if o is not None:
                    outs.append(o)
            d = m.done(channel)
            if d is not None:
                for o in ([d] if isinstance(d, DeviceBatch) else d):
                    if o is not None:
                        self._note_rows(i, o)
                        outs.append(o)
            pending = outs
        return pending or None
