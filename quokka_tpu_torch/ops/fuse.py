"""Fused filter and partial aggregate (PyTorch port of ``quokka_tpu/ops/fuse.py``).

Kernel K1, ``FusedPredicate``: one generated Triton kernel per predicate
signature.  It replaces the reference's jitted ``FusedPredicate.__call__``
program (and its ``kernels._mask_and_count`` fallback).  Each program loads
its block of the referenced columns, evaluates the predicate with SQL null
semantics, ANDs it with ``valid``, stores the mask and adds its block's live
count to one counter.  Bound: bytes (Q1 reads 4 B of ``l_shipdate`` and 1 B
of validity per row and writes 1 B); the design reads every input byte once
and keeps the whole expression in registers.  Triton rather than CUDA C++:
the predicate is known only at query time, and Triton's JIT compiles a new
signature without an ``nvcc`` run per query.

Kernel K2, the small-key partial aggregate of ``FusedPartialAgg``: one
generated Triton kernel per plan signature, replacing the reference's
``_build_small_scatter`` program (the GPU row of its strategy matrix).
Pre-expressions (``l_extendedprice * (1 - l_discount) * (1 + l_tax)``, ...)
are inlined; the group id is the mixed radix ``sum((code + 1) * stride)``
with invalid rows sent to a dump bucket.  Pass 1: a grid of persistent
programs, each walking a strided set of blocks and reducing them through a
block x buckets one-hot into per-program partial sums, counts and minimum
row ids kept in registers, then written to scratch.  Pass 2: a column
reduction over programs.  Both passes run in a fixed order, so sums are
deterministic.  Bound: bytes, 41 B/row on Q1 (4 float64 + 2 int32 codes +
validity); the one-hot work is arithmetic that the card hides under the
loads at Q1's bucket count.  The live-first ordering of the <= 256 buckets
and the padding to 256 rows are torch ops on a few hundred elements.

Kernel K5, the general partial aggregate of ``FusedPartialAgg`` (any key
shape, e.g. TPC-H Q3's ``(l_orderkey, o_orderdate, o_shippriority)``): one
generated Triton kernel per pre-expression signature evaluates every
pre-expression in one pass over the batch and writes one array per partial
input, replacing the pre-expression half of the reference's general fused
program (``FusedPartialAgg._build``); the hash group-by (K3) then groups
them, or ``segment_aggs`` when there is no key.  Bound: bytes (Q3 reads
two float64 columns and validity, 17 B/row, and writes 8 B/row).  Triton
serves here for the reason it serves K1: a fused elementwise pass over a
few columns, known only at query time, with no reuse across rows for shared
memory or tensor cores to exploit.

Kernel K6, the one-hot small-key partial aggregate (``csrc/onehot.cu``):
under ``groupby=sort`` the small-key path is the reference's matmul
strategy (``_build_small``, ``use_tables=False``) instead of K2.  K5
evaluates the pre-expressions; K6 then reduces the columns by bucket
(a stable counting sort of each 256-row chunk in shared memory, then each
bucket's rows in row order, block partials reduced in block order): float64
sums, exact integer sums, int32 counts and the smallest row of each bucket.  It takes a batch only where the
reference's gate admits the one-hot: at most 256 buckets and
``padded_len * buckets * 8`` bytes at most 512 MiB; other batches take the
general path, whose group-by is then the sort group-by (row 10).

Each kernel has a plain torch version beside it (``predicate_plain``,
``small_agg_plain``, ``pre_exprs_plain``, ``onehot_agg_plain``), taken
only when the batch lies on the CPU.  Both the CPU and the CUDA route
generate the kernel source first, so an expression outside the
generator's subset is found on either device: a CPU batch then takes the
unfused path, as the reference falls back when its prepass raises
``CompileError``, and a CUDA batch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import importlib.util
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.expression import (
    Alias,
    BinOp,
    Cast,
    ColRef,
    Expr,
    InList,
    IsNull,
    Literal,
    StrOp,
    UnaryOp,
    _rebuild,
)
from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import expr_compile, kernels, native, sigkey, strategy
from quokka_tpu_torch.ops.batch import DeviceBatch, NumCol, StrCol, gather_columns
from quokka_tpu_torch.ops.bridge import pad_tail

# launch counters of the three Triton kernels and of K6, and of the unfused
# fallbacks (a predicate or partial aggregate whose expression left the
# generator's subset); the smoke runs require the fallbacks to stay at 0
PREDICATE_LAUNCHES = 0
SMALL_AGG_LAUNCHES = 0
PRE_AGG_LAUNCHES = 0
ONEHOT_LAUNCHES = 0
FALLBACKS = 0


def note_fallback(batch: DeviceBatch) -> None:
    """Count a batch taking the unfused path, which runs on CPU batches only:
    on the card an expression outside the generator's subset raises."""
    global FALLBACKS
    if batch.device.type != "cpu":
        raise NotImplementedError(
            "an expression outside the generated kernels' subset is not ported "
            "to quokka_tpu_torch yet: ROADMAP Queue 1, \"The rest of the DataStream/SQL "
            "surface\"")
    FALLBACKS += 1


# ---------------------------------------------------------------------------
# host prepass
# ---------------------------------------------------------------------------


def _is_string_dependent(e: Expr, batch: DeviceBatch) -> bool:
    """Does evaluating e require dictionary VALUES (host data)?"""
    if isinstance(e, StrOp):
        return True
    if _is_string_cast(e):
        return True
    if isinstance(e, UnaryOp) and e.op == "not":
        return _is_string_dependent(e.operand, batch)
    if isinstance(e, (InList, IsNull)):
        return _refs_string(e.expr, batch)
    if isinstance(e, BinOp) and e.op in ("=", "!=", "<", "<=", ">", ">="):
        if _refs_string(e.left, batch) or _refs_string(e.right, batch):
            return True
    return False


def _is_string_cast(e: Expr) -> bool:
    return isinstance(e, Cast) and e.to.startswith(("varchar", "string", "text"))


def _refs_string(e: Expr, batch: DeviceBatch) -> bool:
    if isinstance(e, ColRef):
        return isinstance(batch.columns.get(e.name), StrCol)
    if isinstance(e, Literal):
        return isinstance(e.value, str)
    if _is_string_cast(e):
        return True
    return any(_refs_string(c, batch) for c in e.children())


class Prepass:
    """Rewrites expressions against a concrete batch: string-dependent
    subtrees are evaluated now (host dictionary work + one gather) and
    replaced by references to bound device columns."""

    def __init__(self, batch: DeviceBatch):
        self.batch = batch
        self.bound: Dict[str, torch.Tensor] = {}
        self._memo: Dict[str, str] = {}

    def rewrite(self, e: Expr) -> Expr:
        if isinstance(e, Alias):
            return Alias(self.rewrite(e.expr), e.name)
        if _is_string_dependent(e, self.batch):
            return ColRef(self._bind(e))
        kids = e.children()
        if not kids:
            return e
        return _rebuild(e, [self.rewrite(k) for k in kids])

    def _bind(self, e: Expr) -> str:
        key = e.sql()
        if key in self._memo:
            return self._memo[key]
        col = expr_compile.evaluate_to_column(e, self.batch)
        if isinstance(col, StrCol):
            raise expr_compile.CompileError("string-valued expr in fused pipeline")
        name = f"__b{len(self.bound)}"
        self.bound[name] = col.data
        self._memo[key] = name
        return name


class _ShimBatch:
    """Duck-typed DeviceBatch over plain tensors, kinds re-inferred from
    dtypes as inside the reference's fused programs unless given."""

    def __init__(self, columns: Dict[str, torch.Tensor], valid: torch.Tensor,
                 kinds: Optional[Dict[str, str]] = None):
        kinds = kinds or {}
        self.columns = {n: NumCol(t, kinds.get(n) or _infer_kind(t))
                        for n, t in columns.items()}
        self.valid = valid

    @property
    def padded_len(self):
        return self.valid.shape[0]

    @property
    def names(self):
        return list(self.columns)


def _infer_kind(t: torch.Tensor) -> str:
    if t.dtype == torch.bool:
        return "b"
    return "f" if t.is_floating_point() else "i"


# ---------------------------------------------------------------------------
# generated Triton modules
# ---------------------------------------------------------------------------

_GEN_LOCK = threading.Lock()
_GEN_MODULES: Dict[str, object] = {}

_HEADER = "import triton\nimport triton.language as tl\n\n\n"


def _load_generated(src: str):
    """Import generated Triton source as a module (written under the build
    directory, since Triton reads a kernel's source back from its file)."""
    src = _HEADER + src
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    mod = _GEN_MODULES.get(key)
    if mod is not None:
        return mod
    with _GEN_LOCK:
        mod = _GEN_MODULES.get(key)
        if mod is None:
            os.environ.setdefault("TRITON_CACHE_DIR", native.triton_cache_dir())
            gen_dir = native.BUILD_DIR / "gen"
            gen_dir.mkdir(parents=True, exist_ok=True)
            path = gen_dir / f"qk_{key}.py"
            if not path.exists():
                tmp = path.with_suffix(f".tmp{os.getpid()}")
                tmp.write_text(src)
                os.replace(tmp, path)
            spec = importlib.util.spec_from_file_location(f"qk_gen_{key}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _GEN_MODULES[key] = mod
    return mod


_COLREDUCE_SRC = '''@triton.jit
def qk_colreduce(src_ptr, dst_ptr, P, C, IS_MIN: tl.constexpr, BLOCK_C: tl.constexpr):
    cid = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    m = cid < C
    acc = tl.load(src_ptr + cid, mask=m, other=0)
    for p in range(1, P):
        x = tl.load(src_ptr + p * C + cid, mask=m, other=0)
        if IS_MIN:
            acc = tl.minimum(acc, x)
        else:
            acc = acc + x
    tl.store(dst_ptr + cid, acc, mask=m)
'''


def _colreduce(src: torch.Tensor, is_min: bool) -> torch.Tensor:
    """Pass 2 of K2: reduce a [programs, C] scratch over its first axis."""
    p, c = src.shape
    dst = torch.empty(c, dtype=src.dtype, device=src.device)
    if c == 0:
        return dst
    mod = _load_generated(_COLREDUCE_SRC)
    block_c = 128
    mod.qk_colreduce[(triton_cdiv(c, block_c),)](src, dst, p, c, IS_MIN=is_min,
                                                  BLOCK_C=block_c, num_warps=4)
    return dst


def triton_cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def _load_lines(cols: List[Tuple[str, torch.dtype]], indent: str) -> List[str]:
    out = []
    for i, (_, dt) in enumerate(cols):
        if dt == torch.bool:
            out.append(f"{indent}c{i} = tl.load(c{i}_ptr + offs, mask=m, other=0) != 0")
        else:
            out.append(f"{indent}c{i} = tl.load(c{i}_ptr + offs, mask=m, other=0)")
    return out


def _kernel_arg(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _consts_on(kern, dev: torch.device) -> torch.Tensor:
    """A generated kernel's float64 literals on ``dev``, uploaded once."""
    cache = kern.__dict__.setdefault("_consts_dev", {})
    t = cache.get(dev)
    if t is None:
        t = cache[dev] = torch.tensor(kern.consts or [0.0], dtype=torch.float64).to(dev)
    return t


def _check_inputs(tensors: List[torch.Tensor], dev: torch.device, n: int) -> None:
    for t in tensors:
        if t.device != dev or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"fused kernel input {t.dtype}{tuple(t.shape)} on "
                             f"{t.device} does not match the batch ({n} rows on {dev})")


# ---------------------------------------------------------------------------
# K1: fused predicate
# ---------------------------------------------------------------------------


class _PredicateKernel:
    """Generated source of one predicate signature."""

    def __init__(self, expr: Expr, cols: List[Tuple[str, torch.dtype]]):
        gen = expr_compile.TritonExpr({n: (f"c{i}", dt) for i, (n, dt) in enumerate(cols)})
        pred = gen.bool_of(gen.value(expr))
        self.consts = gen.consts
        args = ", ".join([f"c{i}_ptr" for i in range(len(cols))]
                         + ["valid_ptr", "consts_ptr", "out_ptr", "count_ptr", "n",
                            "BLOCK: tl.constexpr"])
        body = [
            "    pid = tl.program_id(0)",
            "    offs = pid * BLOCK + tl.arange(0, BLOCK)",
            "    m = offs < n",
            "    valid = tl.load(valid_ptr + offs, mask=m, other=0) != 0",
            *_load_lines(cols, "    "),
            *[f"    {l}" for l in gen.lines],
            f"    res = valid & ({pred})",
            "    tl.store(out_ptr + offs, res.to(tl.uint8), mask=m)",
            "    tl.atomic_add(count_ptr, tl.sum(res.to(tl.int32), axis=0))",
        ]
        self.src = f"@triton.jit\ndef qk_predicate({args}):\n" + "\n".join(body) + "\n"


def predicate_plain(expr: Expr, columns: Dict[str, torch.Tensor], valid: torch.Tensor):
    """Plain version of K1: (mask, live count)."""
    m = valid & expr_compile.evaluate_predicate(expr, _ShimBatch(columns, valid))
    return m, m.sum(dtype=torch.int32)


def predicate_launch(kern: _PredicateKernel, inputs: List[torch.Tensor],
                     valid: torch.Tensor):
    """Launch K1 on CUDA tensors: (mask, live count)."""
    global PREDICATE_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    _check_inputs(inputs + [valid], dev, n)
    mod = _load_generated(kern.src)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    consts = _consts_on(kern, dev)
    block = 1024
    mod.qk_predicate[(triton_cdiv(n, block),)](
        *[_kernel_arg(t) for t in inputs], valid.view(torch.uint8), consts, out,
        count, n, BLOCK=block, num_warps=4)
    PREDICATE_LAUNCHES += 1
    return out.view(torch.bool), count[0]


class FusedPredicate:
    """Filter-mask evaluation in one kernel (plus prepass-bound string masks)."""

    def __init__(self, expr: Expr):
        self.expr = expr
        self._kernels: Dict[Tuple, _PredicateKernel] = {}

    def _unfused(self, batch: DeviceBatch) -> DeviceBatch:
        note_fallback(batch)
        mask = expr_compile.evaluate_predicate(self.expr, batch)
        return kernels.apply_mask(batch, mask)

    def prepare(self, batch: DeviceBatch):
        """(rewritten expression, generated kernel, input tensors by name),
        or None when the predicate must take the unfused path."""
        pre = Prepass(batch)
        try:
            e = pre.rewrite(self.expr)
        except expr_compile.CompileError:
            return None
        names = sorted(n for n in e.required_columns() if n in batch.columns)
        if not all(isinstance(batch.columns[n], NumCol) for n in names):
            return None
        inputs = {n: batch.columns[n].data for n in names}
        inputs.update(pre.bound)
        cols = [(n, t.dtype) for n, t in inputs.items()]
        sig = (e.sql(), tuple(cols))
        kern = self._kernels.get(sig)
        if kern is None:
            try:
                kern = _PredicateKernel(e, cols)
            except expr_compile.CompileError:
                return None
            self._kernels[sig] = kern
        return e, kern, inputs

    def __call__(self, batch: DeviceBatch) -> DeviceBatch:
        prep = self.prepare(batch)
        if prep is None:
            return self._unfused(batch)
        e, kern, inputs = prep
        n = batch.padded_len
        devprof.on_dispatch(("K1", batch.device.type, n, tuple(str(t.dtype) for t in inputs.values())),
                            lambda: (0.0, float(devprof.nbytes(*inputs.values()) + 2 * n + 4),
                                     float(n + 4)))
        if batch.device.type == "cpu":
            mask, num = predicate_plain(e, inputs, batch.valid)
        else:
            mask, num = predicate_launch(kern, [t.contiguous() for t in inputs.values()],
                                         batch.valid)
        return DeviceBatch(batch.columns, mask, None, batch.sorted_by).note_count(num)


# ---------------------------------------------------------------------------
# K2: small-key partial aggregate
# ---------------------------------------------------------------------------

_SMALL_GROUPBY_MAX_BUCKETS = 256


class _SmallAggKernel:
    """Generated source of one small-key partial-aggregate signature."""

    def __init__(self, pre_exprs: Dict[str, Expr], partials, cols, n_keys: int,
                 strides: Tuple[int, ...], n_groups: int):
        gen = expr_compile.TritonExpr({n: (f"c{i}", dt) for i, (n, dt) in enumerate(cols)})
        self.fparts: List[int] = []  # partial index -> float accumulator
        self.iparts: List[int] = []
        lines: List[str] = []
        accs: List[Tuple[str, str]] = []  # (acc var, init)
        upd: List[str] = []
        for j, (_pname, op, tmp) in enumerate(partials):
            if op == "count":
                self.iparts.append(j)
                acc = f"acc{j}"
                accs.append((acc, "tl.zeros([BP], tl.int64)"))
                upd.append(f"{acc} += tl.sum(tl.where(hit, valid.to(tl.int64)[:, None], 0), axis=0)")
                continue
            v = gen.value(pre_exprs[tmp])
            if v.scalar:
                raise expr_compile.CompileError("constant aggregate input in the fused subset")
            acc = f"acc{j}"
            if v.dt in ("tl.float64", "tl.float32"):
                self.fparts.append(j)
                accs.append((acc, "tl.zeros([BP], tl.float64)"))
                upd.append(f"x{j} = tl.where(valid, {v.code}.to(tl.float64), 0.0)")
                upd.append(f"{acc} += tl.sum(tl.where(hit, x{j}[:, None], 0.0), axis=0)")
            else:
                self.iparts.append(j)
                accs.append((acc, "tl.zeros([BP], tl.int64)"))
                upd.append(f"x{j} = tl.where(valid, {v.code}.to(tl.int64), 0)")
                upd.append(f"{acc} += tl.sum(tl.where(hit, x{j}[:, None], 0), axis=0)")
        self.consts = gen.consts
        gid = " + ".join(f"(k{i} + 1) * {st}" for i, st in enumerate(strides))
        args = ", ".join([f"c{i}_ptr" for i in range(len(cols))]
                         + [f"k{i}_ptr" for i in range(n_keys)]
                         + ["valid_ptr", "consts_ptr", "fsc_ptr", "isc_ptr", "rsc_ptr",
                            "n", "nprog", "BLOCK: tl.constexpr", "BP: tl.constexpr"])
        body = ["    pid = tl.program_id(0)", "    bidx = tl.arange(0, BP)"]
        body += [f"    {a} = {init}" for a, init in accs]
        body += ["    rmin = tl.zeros([BP], tl.int32) + n",
                 "    for start in range(pid * BLOCK, n, nprog * BLOCK):",
                 "        offs = start + tl.arange(0, BLOCK)",
                 "        m = offs < n",
                 "        valid = tl.load(valid_ptr + offs, mask=m, other=0) != 0"]
        body += _load_lines(cols, "        ")
        body += [f"        k{i} = tl.load(k{i}_ptr + offs, mask=m, other=0)"
                 for i in range(n_keys)]
        body += [f"        gid = tl.where(valid, {gid}, {n_groups})",
                 "        hit = gid[:, None] == bidx[None, :]"]
        body += [f"        {l}" for l in gen.lines + upd]
        body += ["        rmin = tl.minimum(rmin, tl.min(tl.where(hit, offs[:, None], n), axis=0))"]
        for slot, j in enumerate(self.fparts):
            body.append(f"    tl.store(fsc_ptr + (pid * {len(self.fparts)} + {slot}) * BP + bidx, acc{j})")
        for slot, j in enumerate(self.iparts):
            body.append(f"    tl.store(isc_ptr + (pid * {len(self.iparts)} + {slot}) * BP + bidx, acc{j})")
        body.append("    tl.store(rsc_ptr + pid * BP + bidx, rmin)")
        self.src = f"@triton.jit\ndef qk_small_agg({args}):\n" + "\n".join(body) + "\n"


def small_agg_plain(pre_exprs, partials, columns: Dict[str, torch.Tensor],
                    codes: List[torch.Tensor], valid: torch.Tensor,
                    strides: Tuple[int, ...], n_groups: int):
    """Plain version of K2: per-bucket sums/counts [n_groups] per partial and
    the minimum valid row id per bucket (n where empty)."""
    n = valid.shape[0]
    dev = valid.device
    shim = _ShimBatch(columns, valid)
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    for c, st in zip(codes, strides):
        gid = gid + (c.to(torch.int64) + 1) * st
    gid = torch.where(valid, gid, torch.full_like(gid, n_groups))
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rep = torch.full((n_groups + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, torch.where(valid, iota, torch.full_like(iota, n)), reduce="amin")
    sums = []
    for _pname, op, tmp in partials:
        if op == "count":
            x = valid.to(torch.int64)
        else:
            v = expr_compile.evaluate_to_column(pre_exprs[tmp], shim).data
            v = v.to(torch.float64) if v.is_floating_point() else v.to(torch.int64)
            x = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=dev))
        sums.append(torch.zeros(n_groups + 1, dtype=x.dtype, device=dev).index_add_(0, gid, x)[:n_groups])
    return sums, rep[:n_groups]


def small_agg_launch(kern: _SmallAggKernel, partials, inputs: List[torch.Tensor],
                     codes: List[torch.Tensor], valid: torch.Tensor, n_groups: int):
    """Launch K2 (both passes) on CUDA tensors; same outputs as the plain
    version."""
    global SMALL_AGG_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    _check_inputs(inputs + codes + [valid], dev, n)
    mod = _load_generated(kern.src)
    bp = sigkey.pow2_dim(n_groups + 1)
    block = max(16, 4096 // bp)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nprog = max(1, min(triton_cdiv(n, block), 4 * sms))
    kf, ki = len(kern.fparts), len(kern.iparts)
    fsc = torch.empty((nprog, max(kf, 1) * bp), dtype=torch.float64, device=dev)
    isc = torch.empty((nprog, max(ki, 1) * bp), dtype=torch.int64, device=dev)
    rsc = torch.empty((nprog, bp), dtype=torch.int32, device=dev)
    consts = _consts_on(kern, dev)
    mod.qk_small_agg[(nprog,)](
        *[_kernel_arg(t) for t in inputs], *codes, valid.view(torch.uint8), consts,
        fsc, isc, rsc, n, nprog, BLOCK=block, BP=bp, num_warps=4)
    fsum = _colreduce(fsc, False).view(max(kf, 1), bp)
    isum = _colreduce(isc, False).view(max(ki, 1), bp)
    rep = _colreduce(rsc, True)
    SMALL_AGG_LAUNCHES += 1
    sums: List[Optional[torch.Tensor]] = [None] * len(partials)
    for slot, j in enumerate(kern.fparts):
        sums[j] = fsum[slot, :n_groups]
    for slot, j in enumerate(kern.iparts):
        sums[j] = isum[slot, :n_groups]
    return sums, rep[:n_groups].to(torch.int64)


@dataclasses.dataclass
class SmallCall:
    """Everything one K2 call needs, for the kernel and its plain version."""

    kern: _SmallAggKernel
    pre_exprs: Dict[str, Expr]
    partials: list
    inputs: Dict[str, torch.Tensor]
    codes: List[torch.Tensor]
    valid: torch.Tensor
    strides: Tuple[int, ...]
    n_groups: int

    def plain(self):
        return small_agg_plain(self.pre_exprs, self.partials, self.inputs, self.codes,
                               self.valid, self.strides, self.n_groups)

    def launch(self):
        return small_agg_launch(self.kern, self.partials, list(self.inputs.values()),
                                self.codes, self.valid, self.n_groups)

    def run(self):
        """K2 on CUDA tensors, the plain version on CPU ones, charged to
        devprof: inputs, codes and mask read, each bucket's sums and
        smallest row written."""
        out = 8 * self.n_groups * (len(self.partials) + 1)
        devprof.on_dispatch(
            ("K2", self.valid.device.type, self.valid.shape[0], tuple(str(t.dtype) for t in self.inputs.values()),
             len(self.codes), len(self.partials), self.n_groups),
            lambda: (0.0, float(devprof.nbytes(*self.inputs.values(), *self.codes,
                                               self.valid) + out), float(out)))
        return self.plain() if self.valid.device.type == "cpu" else self.launch()


# ---------------------------------------------------------------------------
# K5: pre-expressions of the general partial aggregate
# ---------------------------------------------------------------------------


class _PreAggKernel:
    """Generated source of one pre-expression signature: every listed
    pre-expression evaluated in one pass, one output array each."""

    def __init__(self, pre_exprs: Dict[str, Expr], outs: List[str], cols):
        gen = expr_compile.TritonExpr({n: (f"c{i}", dt) for i, (n, dt) in enumerate(cols)})
        stores = []
        for j, tmp in enumerate(outs):
            v = gen.value(pre_exprs[tmp])
            code = f"(tl.zeros(valid.shape, {v.dt}) + {v.code})" if v.scalar else v.code
            stores.append(f"    tl.store(o{j}_ptr + offs, {code}, mask=m)")
        self.consts = gen.consts
        args = ", ".join([f"c{i}_ptr" for i in range(len(cols))]
                         + ["valid_ptr", "consts_ptr"]
                         + [f"o{j}_ptr" for j in range(len(outs))]
                         + ["n", "BLOCK: tl.constexpr"])
        body = [
            "    pid = tl.program_id(0)",
            "    offs = pid * BLOCK + tl.arange(0, BLOCK)",
            "    m = offs < n",
            "    valid = tl.load(valid_ptr + offs, mask=m, other=0) != 0",
            *_load_lines(cols, "    "),
            *[f"    {l}" for l in gen.lines],
            *stores,
        ]
        self.src = f"@triton.jit\ndef qk_pre_agg({args}):\n" + "\n".join(body) + "\n"


def pre_exprs_plain(pre_exprs: Dict[str, Expr], outs: List[str],
                    columns: Dict[str, torch.Tensor], valid: torch.Tensor) -> List[torch.Tensor]:
    """Plain version of K5: each listed pre-expression as a column."""
    shim = _ShimBatch(columns, valid)
    return [expr_compile.evaluate_to_column(pre_exprs[t], shim).data for t in outs]


def pre_exprs_launch(kern: _PreAggKernel, inputs: List[torch.Tensor], valid: torch.Tensor,
                     out_dtypes: List[torch.dtype]) -> List[torch.Tensor]:
    """Launch K5 on CUDA tensors: one output per pre-expression, in the
    plain version's dtypes."""
    global PRE_AGG_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    _check_inputs(inputs + [valid], dev, n)
    mod = _load_generated(kern.src)
    outs = [torch.empty(n, dtype=dt, device=dev) for dt in out_dtypes]
    if n:
        block = 1024
        mod.qk_pre_agg[(triton_cdiv(n, block),)](
            *[_kernel_arg(t) for t in inputs], valid.view(torch.uint8),
            _consts_on(kern, dev), *[_kernel_arg(o) for o in outs], n, BLOCK=block,
            num_warps=4)
    PRE_AGG_LAUNCHES += 1
    return outs


@dataclasses.dataclass
class PreAggCall:
    """Everything one K5 call needs, for the kernel and its plain version."""

    kern: _PreAggKernel
    pre_exprs: Dict[str, Expr]
    outs: List[str]
    inputs: Dict[str, torch.Tensor]
    valid: torch.Tensor
    out_dtypes: List[torch.dtype]

    def plain(self) -> List[torch.Tensor]:
        return pre_exprs_plain(self.pre_exprs, self.outs, self.inputs, self.valid)

    def launch(self) -> List[torch.Tensor]:
        return pre_exprs_launch(self.kern, list(self.inputs.values()), self.valid,
                                self.out_dtypes)

    def run(self) -> List[torch.Tensor]:
        """K5 on CUDA tensors, the plain version on CPU ones, charged to
        devprof: inputs and mask read, one array per pre-expression written."""
        n = self.valid.shape[0]
        out = n * sum(torch.empty((), dtype=dt).element_size() for dt in self.out_dtypes)
        devprof.on_dispatch(
            ("K5", self.valid.device.type, n, tuple(str(t.dtype) for t in self.inputs.values()),
             tuple(str(dt) for dt in self.out_dtypes)),
            lambda: (0.0, float(devprof.nbytes(*self.inputs.values(), self.valid) + out),
                     float(out)))
        return self.plain() if self.valid.device.type == "cpu" else self.launch()


# ---------------------------------------------------------------------------
# K6: the one-hot small-key partial aggregate (groupby=sort)
# ---------------------------------------------------------------------------

# the reference's one-hot gate: the n x buckets operand in float64
_SMALL_GROUPBY_MAX_BYTES = 512 << 20
_ONEHOT_MAX_COLUMNS = 32
_ONEHOT_MAX_KEYS = 8


def _bucket_ids(codes: List[torch.Tensor], strides: Tuple[int, ...], valid: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    gid = torch.zeros(valid.shape[0], dtype=torch.int64, device=valid.device)
    for c, st in zip(codes, strides):
        gid = gid + (c.to(torch.int64) + 1) * st
    return torch.where(valid, gid, torch.full_like(gid, n_groups))


def onehot_agg_plain(fcols: List[torch.Tensor], icols: List[torch.Tensor],
                     codes: List[torch.Tensor], strides: Tuple[int, ...], n_groups: int,
                     valid: torch.Tensor):
    """Plain version of K6: (float64 sums [nf, G], int64 sums [ni, G], counts
    [G] int32, smallest row [G] int64, n where empty).  Invalid rows go to a
    dump bucket that no output reads."""
    n = valid.shape[0]
    dev = valid.device
    gid = _bucket_ids(codes, strides, valid, n_groups)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rep = torch.full((n_groups + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, iota, reduce="amin")[:n_groups]

    def sums(x):
        return torch.zeros(n_groups + 1, dtype=x.dtype, device=dev).index_add_(0, gid, x)[:n_groups]

    zf = torch.zeros((), dtype=torch.float64, device=dev)
    fs = torch.stack([sums(torch.where(valid, c, zf)) for c in fcols]) if fcols else \
        torch.zeros((0, n_groups), dtype=torch.float64, device=dev)
    zi = torch.zeros((), dtype=torch.int64, device=dev)
    is_ = torch.stack([sums(torch.where(valid, c, zi)) for c in icols]) if icols else \
        torch.zeros((0, n_groups), dtype=torch.int64, device=dev)
    counts = sums(valid.to(torch.int64)).to(torch.int32)
    return fs, is_, counts, rep


def _onehot_lib():
    lib = native.library("onehot")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_onehot_agg.argtypes = [ctypes.POINTER(P), I, ctypes.POINTER(P), I,
                                      ctypes.POINTER(P), ctypes.POINTER(I), I, P, L, I, I,
                                      P, P, P, P, P, P]
        lib.qk_onehot_agg.restype = I
        lib.qk_bound = True
    return lib


def onehot_agg_cuda(fcols: List[torch.Tensor], icols: List[torch.Tensor],
                    codes: List[torch.Tensor], strides: Tuple[int, ...], n_groups: int,
                    valid: torch.Tensor):
    """Launch K6 (both passes) on CUDA tensors; the plain version's outputs."""
    global ONEHOT_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    if dev.type != "cuda":
        raise RuntimeError(f"onehot_agg: unsupported device {dev}")
    fcols = [c.contiguous() for c in fcols]
    icols = [c.contiguous() for c in icols]
    codes = [c.contiguous() for c in codes]
    for c, dt in [(c, torch.float64) for c in fcols] + [(c, torch.int64) for c in icols] + \
            [(c, torch.int32) for c in codes]:
        if c.dtype != dt or c.shape != (n,) or c.device != dev:
            raise TypeError(f"onehot_agg: column {c.dtype} {tuple(c.shape)} on {c.device}, "
                            f"expected {dt} [{n}] on {dev}")
    if len(fcols) + len(icols) > _ONEHOT_MAX_COLUMNS or not 1 <= len(codes) <= _ONEHOT_MAX_KEYS:
        raise ValueError(f"onehot_agg: {len(fcols) + len(icols)} columns and {len(codes)} keys;"
                         f" K6 takes at most {_ONEHOT_MAX_COLUMNS} and 1 to {_ONEHOT_MAX_KEYS}")
    if not 1 <= n_groups < _SMALL_GROUPBY_MAX_BUCKETS or n < 1:
        raise ValueError(f"onehot_agg: {n_groups} groups over {n} rows")
    nf, ni = len(fcols), len(icols)
    entries = n_groups * (nf + ni + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # eight blocks an SM keep the chunks' loads in flight
    blocks = max(1, min(8 * sms, -(-n // 256)))
    partial = torch.empty((blocks, entries), dtype=torch.float64, device=dev)
    fs = torch.empty((nf, n_groups), dtype=torch.float64, device=dev)
    is_ = torch.empty((ni, n_groups), dtype=torch.int64, device=dev)
    counts = torch.empty(n_groups, dtype=torch.int32, device=dev)
    rep = torch.empty(n_groups, dtype=torch.int64, device=dev)
    native.check(_onehot_lib().qk_onehot_agg(
        native.ptr_array([c.data_ptr() for c in fcols]), nf,
        native.ptr_array([c.data_ptr() for c in icols]), ni,
        native.ptr_array([c.data_ptr() for c in codes]), native.int_array(list(strides)),
        len(codes), valid.contiguous().view(torch.uint8).data_ptr(), n, n_groups, blocks,
        partial.data_ptr(), fs.data_ptr(), is_.data_ptr(), counts.data_ptr(), rep.data_ptr(),
        native.stream_ptr(dev)), "qk_onehot_agg")
    ONEHOT_LAUNCHES += 1
    return fs, is_, counts, rep


def onehot_agg(fcols: List[torch.Tensor], icols: List[torch.Tensor], codes: List[torch.Tensor],
               strides: Tuple[int, ...], n_groups: int, valid: torch.Tensor):
    """K6: per-bucket float64 sums, exact int64 sums, int32 counts and the
    smallest row id.  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    out = n_groups * (8 * (len(fcols) + len(icols)) + 12)
    devprof.on_dispatch(
        ("K6", valid.device.type, valid.shape[0], len(fcols), len(icols), len(codes), n_groups),
        lambda: (0.0, float(devprof.nbytes(*fcols, *icols, *codes, valid) + out), float(out)))
    if valid.device.type == "cpu":
        return onehot_agg_plain(fcols, icols, codes, strides, n_groups, valid)
    return onehot_agg_cuda(fcols, icols, codes, strides, n_groups, valid)


class FusedPartialAgg:
    """Per-batch partial group-by aggregate.

    Small-key path: every key is a dictionary string, the plan has only
    sum/count partials and the product of dictionary sizes is small (TPC-H
    Q1: returnflag x linestatus).  Under the default ``groupby=hashtable`` it
    is K2 (the reference's scatter strategy); under ``groupby=sort`` it is
    K5 then K6 (its one-hot matmul), where the one-hot fits the reference's
    512 MiB gate.  The output is a 256-row bucket.  Other shapes take the
    general path: the pre-expressions in one kernel (K5), then the group-by
    the strategy picks (K3, or row 10's sort group-by), as the reference's
    general fused program does."""

    def __init__(self, keys: List[str], plan):
        self.keys = keys
        self.plan = plan
        self._kernels: Dict[Tuple, _SmallAggKernel] = {}
        self._pre_kernels: Dict[Tuple, Tuple[_PreAggKernel, List[torch.dtype]]] = {}

    def _small_dims(self, batch: DeviceBatch,
                    use_tables: bool = True) -> Optional[Tuple[int, ...]]:
        """Per-key bucket counts (dictionary size + a null slot, to the next
        power of two) when the small-key path applies, else None.  The
        one-hot (``use_tables`` False) also needs its n x buckets float64
        operand within 512 MiB, as in the reference."""
        if not self.keys:
            return None
        if not all(isinstance(batch.columns[k], StrCol) for k in self.keys):
            return None
        if not all(op in ("sum", "count") for _, op, _ in self.plan.partials):
            return None
        dims = tuple(sigkey.pow2_dim(len(batch.columns[k].dictionary.values) + 1)
                     for k in self.keys)
        n_buckets = int(np.prod(dims)) + 1
        if n_buckets > _SMALL_GROUPBY_MAX_BUCKETS:
            return None
        if not use_tables and batch.padded_len * n_buckets * 8 > _SMALL_GROUPBY_MAX_BYTES:
            return None
        return dims

    @staticmethod
    def _strides(dims: Tuple[int, ...]) -> Tuple[int, ...]:
        strides, s = [], 1
        for d in reversed(dims):
            strides.append(s)
            s *= d
        return tuple(reversed(strides))

    def _pre_inputs(self, batch: DeviceBatch):
        pre = Prepass(batch)
        pre_exprs = {name: pre.rewrite(e) for name, e in self.plan.pre}
        needed = set()
        for e in pre_exprs.values():
            needed |= e.required_columns()
        inputs: Dict[str, torch.Tensor] = {}
        for n in sorted(needed):
            c = batch.columns.get(n)
            if c is None:
                continue
            if not isinstance(c, NumCol):
                raise expr_compile.CompileError(f"aggregate input {n} is not numeric")
            inputs[n] = c.data.contiguous()
        inputs.update({k: t.contiguous() for k, t in pre.bound.items()})
        return pre_exprs, inputs

    def prepare_small(self, batch: DeviceBatch) -> Optional[SmallCall]:
        """The small-key kernel call for this batch, or None when the batch
        takes the general path."""
        dims = self._small_dims(batch)
        if dims is None:
            return None
        pre_exprs, inputs = self._pre_inputs(batch)
        n_groups = int(np.prod(dims))
        strides = self._strides(dims)
        cols = [(n, t.dtype) for n, t in inputs.items()]
        sig = (tuple((k, e.sql()) for k, e in pre_exprs.items()), tuple(cols), dims)
        kern = self._kernels.get(sig)
        if kern is None:
            kern = _SmallAggKernel(pre_exprs, self.plan.partials, cols, len(self.keys),
                                   strides, n_groups)
            self._kernels[sig] = kern
        codes = [batch.columns[k].codes.contiguous() for k in self.keys]
        return SmallCall(kern, pre_exprs, self.plan.partials, inputs, codes,
                         batch.valid, strides, n_groups)

    def __call__(self, batch: DeviceBatch) -> DeviceBatch:
        pick = strategy.choice("groupby")
        if pick == "sort":
            dims = self._small_dims(batch, use_tables=False)
            if dims is None:
                return self._general(batch)
            strategy.note_used("groupby", "sort")
            sums, rep_b = self._onehot(batch, dims)
            n_groups = int(np.prod(dims))
        else:
            call = self.prepare_small(batch)
            if call is None:
                return self._general(batch)
            strategy.note_used("groupby", "hashtable")
            sums, rep_b = call.run()
            n_groups = call.n_groups
        # live buckets first, in bucket order, padded to a 256-row bucket
        n = batch.padded_len
        live = rep_b < n
        num = live.sum(dtype=torch.int32)
        bidx = torch.arange(n_groups, device=batch.device)
        order = torch.argsort(torch.where(live, bidx, bidx + n_groups))
        out_pad = config.bucket_size(n_groups)
        outs = [pad_tail(x[order], out_pad) for x in sums]
        rep = pad_tail(torch.clamp(rep_b[order], max=n - 1), out_pad)
        return self._assemble(batch, outs, rep, num, out_pad)

    def _onehot(self, batch: DeviceBatch, dims: Tuple[int, ...]):
        """The one-hot small-key aggregate (K5's pre-expressions, then K6):
        per-partial bucket arrays [G] and the smallest row of each bucket."""
        call = self.prepare_general(batch)
        pre = call.run()
        by_tmp = dict(zip(call.outs, pre))
        fcols, icols, slots = [], [], []
        for _pname, op, tmp in self.plan.partials:
            if op == "count":
                slots.append(("c", 0))
            elif by_tmp[tmp].is_floating_point():
                slots.append(("f", len(fcols)))
                fcols.append(by_tmp[tmp].to(torch.float64))
            else:
                # summed exactly in int64, returned in the column's own type
                # (an int32 sum wraps as the reference's segment sum does)
                slots.append(("i", len(icols), by_tmp[tmp].dtype))
                icols.append(by_tmp[tmp].to(torch.int64))
        codes = [batch.columns[k].codes for k in self.keys]
        fs, is_, counts, rep_b = onehot_agg(fcols, icols, codes, self._strides(dims),
                                            int(np.prod(dims)), batch.valid)
        sums = [counts if slot[0] == "c" else fs[slot[1]] if slot[0] == "f"
                else is_[slot[1]].to(slot[2]) for slot in slots]
        return sums, rep_b

    def prepare_general(self, batch: DeviceBatch) -> PreAggCall:
        """The K5 call of this batch (general path)."""
        pre_exprs, inputs = self._pre_inputs(batch)
        outs = sorted({tmp for _, _, tmp in self.plan.partials if tmp is not None})
        cols = [(n, t.dtype) for n, t in inputs.items()]
        sig = (tuple((k, pre_exprs[k].sql()) for k in outs), tuple(cols))
        hit = self._pre_kernels.get(sig)
        if hit is None:
            kern = _PreAggKernel(pre_exprs, outs, cols)
            # the output dtypes are the plain evaluator's, read off a 0-row
            # evaluation once per signature
            dts = [t.dtype for t in pre_exprs_plain(
                pre_exprs, outs, {n: t[:0] for n, t in inputs.items()}, batch.valid[:0])]
            hit = self._pre_kernels[sig] = (kern, dts)
        return PreAggCall(hit[0], pre_exprs, outs, inputs, batch.valid, hit[1])

    def _general(self, batch: DeviceBatch) -> DeviceBatch:
        call = self.prepare_general(batch)
        pre = call.run()
        by_tmp = dict(zip(call.outs, pre))
        n = batch.padded_len
        arrays = tuple(
            by_tmp[tmp] if tmp is not None
            else torch.zeros(n, dtype=torch.int32, device=batch.device)
            for (_, _, tmp) in self.plan.partials)
        ops = tuple(op for (_, op, _) in self.plan.partials)
        if self.keys:
            limbs = []
            for k in self.keys:
                c = batch.columns[k]
                # within one batch dictionary codes are the key identity
                limbs.append(c.codes if isinstance(c, StrCol) else c.data)
            outs, _counts, rep, num = kernels.groupby_limbs(limbs, arrays, ops, batch.valid)
        else:
            from quokka_tpu_torch.ops import hashtable

            ranks = torch.zeros(n, dtype=torch.int32, device=batch.device)
            num = torch.clamp(batch.valid.sum(dtype=torch.int32), max=1)
            outs, _counts, rep = hashtable.segment_aggs(ranks, batch.valid, arrays, ops)
        return self._assemble(batch, outs, rep, num, n)

    def _assemble(self, batch, outs, rep, num, out_pad) -> DeviceBatch:
        cols = gather_columns({k: batch.columns[k] for k in self.keys}, rep)
        for (pname, _, _), arr in zip(self.plan.partials, outs):
            cols[pname] = NumCol(arr, "f" if arr.is_floating_point() else "i")
        gvalid = torch.arange(out_pad, device=batch.device) < num
        return DeviceBatch(cols, gvalid, None, None).note_count(num)
