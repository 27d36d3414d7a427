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

Kernel K2, the small-key partial aggregate of ``FusedPartialAgg``,
replacing the reference's ``_build_small_scatter`` program (the GPU row of
its strategy matrix): per-bucket sums of every partial, counts and the
least valid row of each bucket, the bucket being the mixed radix
``sum((code + 1) * stride)`` of the dictionary codes, invalid rows sent to
a dump bucket.  It runs the bucket core of ``csrc/onehot.cu``: a partial
whose input is a numeric column (float64, float32, int64 or int32; ``x``,
or the null-skipping ``__nn0(x)`` of sum and ``__nncount(x)`` of count
and avg) is read in place, typed, with no cast or copy; only expression
inputs (Q1's ``l_extendedprice * (1 - l_discount) * (1 + l_tax)``, ...)
come from one generated Triton pre-pass, K5's generator restricted to
those outputs and counted apart from K5 (``SMALL_PRE_LAUNCHES``).  K6
takes the same plan (``_SmallAggKernel``).  A plan of plain columns and
``count(*)``, as the tick paths' ``sum(notional), count(*)``, is one CUDA
call and no Triton launch.  Bound: bytes, 41 B/row for Q1's fused function (4 float64
+ 2 int32 codes + validity); the pre-pass writes its outputs and the core
reads them back, about 90 B/row in all.  The Triton kernel this replaced
compared every row with every bucket (a [block, buckets] float64 tile per
partial, 16x its bound at Q1); the core groups each warp's 32 rows into
runs by bucket and sums each run with a shuffle scan, a cost that does not
grow with the buckets (see ``csrc/onehot.cu``).  Deterministic: the same bits every run.
The live-first ordering of the <= 256 buckets and the padding to 256 rows
are torch ops on a few hundred elements.

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

Kernel K6, the one-hot small-key partial aggregate: under
``groupby=sort`` the small-key path is the reference's matmul strategy
(``_build_small``, ``use_tables=False``) instead of K2.  It takes K2's
plan and tags: plain columns are read in place (one tensor read under two
tags is one source), and only expression inputs come from a generated
pre-pass of its own, ``qk_onehot_pre`` ("K6 pre",
``ONEHOT_PRE_LAUNCHES``); K5 does not run.  ``csrc/onehot.cu``'s
``qk_onehot_mma_kernel`` then multiplies the one-hot of the bucket ids
by the stacked columns on the FP64 tensor cores: float64 sums, exact
integer sums (22-bit limbs), int32 counts and the smallest row of each
bucket, the same bits every run (see its note).  Bound: bytes, 49 B/row
at Q1 (five float64 columns, two int32 codes, validity).  It takes a
batch only where the reference's gate admits the one-hot: at most 256
buckets and ``padded_len * buckets * 8`` bytes at most 512 MiB; other
batches take the general path, whose group-by is then the sort group-by
(row 10).

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
    Func,
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

# launch counters of K1, K2 (its bucket core, and its Triton pre-pass
# apart), K5 and K6, and of the unfused fallbacks (a predicate or partial
# aggregate whose expression left the generator's subset); the smoke runs
# require the fallbacks to stay at 0
PREDICATE_LAUNCHES = 0
SMALL_AGG_LAUNCHES = 0
SMALL_PRE_LAUNCHES = 0
PRE_AGG_LAUNCHES = 0
ONEHOT_LAUNCHES = 0
ONEHOT_PRE_LAUNCHES = 0
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
# the bucket core's limits (csrc/onehot.cu): columns, then key columns
_BUCKET_MAX_COLUMNS = 32
_BUCKET_MAX_KEYS = 8


# the bucket core's column tags (csrc/onehot.cu): the type, then whether a
# null (NaN, the int sentinel) adds 0 (the reference's __nn0 of sum(x)), or
# each value adds 1 unless it is null (its __nncount of count(x) and avg(x))
_AGG_TAG = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3}
_AGG_WRAP = {None: 0, "__nn0": 4, "__nncount": 8}


def _float_tag(tag: int) -> bool:
    """Does a tagged column sum into float64 (else exactly into int64)?"""
    return (tag & 3 in (_AGG_TAG[torch.float64], _AGG_TAG[torch.float32])
            and not tag & _AGG_WRAP["__nncount"])


def _plain_column(e: Expr, inputs: Dict[str, torch.Tensor]) -> Optional[Tuple[str, int]]:
    """(column, tag) when a partial's input is a numeric column of a type the
    bucket core reads, as it lies (``x``) or in the null-skipping wrapper of
    sum (``__nn0(x)``) or of count (``__nncount(x)``); else None (an
    expression, for the pre-pass)."""
    if isinstance(e, Alias):
        e = e.expr
    wrap = None
    if isinstance(e, Func) and e.name in _AGG_WRAP and len(e.args) == 1:
        wrap, e = e.name, e.args[0]
    if isinstance(e, ColRef) and e.name in inputs and inputs[e.name].dtype in _AGG_TAG:
        return e.name, _AGG_TAG[inputs[e.name].dtype] | _AGG_WRAP[wrap]
    return None


class _SmallAggKernel:
    """How one small-key plan signature feeds K2's bucket core (and K6): each
    partial a plain column read in place, an output of the generated
    pre-pass (K5's generator over the expression inputs only, named
    ``pre_name``; ``pre`` is None when there are none) or the count.
    ``cols`` lists the core's columns, float ones first: (("col", name) or
    ("pre", output index), tag)."""

    def __init__(self, pre_exprs: Dict[str, Expr], partials, inputs: Dict[str, torch.Tensor],
                 valid: torch.Tensor, pre_name: str = "qk_small_pre"):
        fcols: List[Tuple[Tuple, int]] = []
        icols: List[Tuple[Tuple, int]] = []
        self.pre_outs: List[str] = []  # the pre-pass outputs, by partial input name
        self.pre_dtypes: List[torch.dtype] = []
        by_src: Dict[Tuple, Tuple[str, int]] = {}
        self.slots: List[Tuple] = []  # per partial: ("c",), ("f", i) or ("i", i)
        for _pname, op, tmp in partials:
            if op == "count":
                self.slots.append(("c",))
                continue
            plain = _plain_column(pre_exprs[tmp], inputs)
            if plain is not None:
                src, tag = ("col", plain[0]), plain[1]
                key = (src, tag)
            else:
                key = ("pre", tmp)
                if key not in by_src:
                    # the plain evaluator's type, read off a 0-row evaluation
                    dt = pre_exprs_plain(pre_exprs, [tmp], {n: t[:0] for n, t in inputs.items()},
                                         valid[:0])[0].dtype
                    dt = torch.float64 if dt.is_floating_point else torch.int64
                    src, tag = ("pre", len(self.pre_outs)), _AGG_TAG[dt]
                    self.pre_outs.append(tmp)
                    self.pre_dtypes.append(dt)
            if key not in by_src:
                kind, cols = ("f", fcols) if _float_tag(tag) else ("i", icols)
                by_src[key] = (kind, len(cols))
                cols.append((src, tag))
            self.slots.append(by_src[key])
        self.cols = fcols + icols
        self.nf = len(fcols)
        needed = set()
        for tmp in self.pre_outs:
            needed |= pre_exprs[tmp].required_columns()
        self.pre_inputs = [n for n in inputs if n in needed]
        self.pre = _PreAggKernel(pre_exprs, self.pre_outs,
                                 [(n, inputs[n].dtype) for n in self.pre_inputs],
                                 pre_name) if self.pre_outs else None


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


def _bucket_lib():
    lib = native.library("onehot")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_small_agg.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I), I, I,
                                     ctypes.POINTER(P), ctypes.POINTER(I), I, P, L, I, P, I,
                                     P, P, P, I, P, P]
        lib.qk_small_agg.restype = I
        lib.qk_bound = True
    return lib


def _bucket_agg(cols: List[torch.Tensor], tags: List[int], nf: int, codes: List[torch.Tensor],
                strides: Tuple[int, ...], n_groups: int, valid: torch.Tensor, cnt_dtype,
                what: str):
    """The bucket core (``csrc/onehot.cu``) on CUDA tensors: (float64 sums
    [nf, G], int64 sums [ni, G], counts [G] of ``cnt_dtype``, smallest row
    [G] int64).  Every converted or contiguous copy is held in a local
    until the launch has been issued.  Outputs and scratch are one
    allocation."""
    dev = valid.device
    n = valid.shape[0]
    ni = len(cols) - nf
    cols = [c.contiguous() for c in cols]
    codes = [c.to(torch.int32).contiguous() for c in codes]
    v8 = valid.contiguous().view(torch.uint8)
    for c in cols + codes:
        if c.shape != (n,) or c.device != dev:
            raise TypeError(f"{what}: column {c.dtype} {tuple(c.shape)} on {c.device}, "
                            f"expected [{n}] on {dev}")
    if len(cols) > _BUCKET_MAX_COLUMNS or not 1 <= len(codes) <= _BUCKET_MAX_KEYS:
        raise ValueError(f"{what}: {len(cols)} columns and {len(codes)} keys; the bucket core "
                         f"takes at most {_BUCKET_MAX_COLUMNS} and 1 to {_BUCKET_MAX_KEYS}")
    if not 1 <= n_groups < _SMALL_GROUPBY_MAX_BUCKETS:
        raise ValueError(f"{what}: {n_groups} groups; the bucket core takes 1 to "
                         f"{_SMALL_GROUPBY_MAX_BUCKETS - 1}")
    entries = n_groups * (len(cols) + 2)
    # eight blocks an SM at most: the core sizes its grid to the resident blocks
    cap = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.empty(cap * entries + entries, dtype=torch.int64, device=dev)
    out = buf[cap * entries:]
    g = n_groups
    fs = out[:nf * g].view(torch.float64).view(nf, g)
    is_ = out[nf * g:(nf + ni) * g].view(ni, g)
    cnt = out[(nf + ni) * g:(nf + ni + 1) * g]
    rep = out[(nf + ni + 1) * g:]
    native.check(_bucket_lib().qk_small_agg(
        native.ptr_array([c.data_ptr() for c in cols]), native.int_array(tags), nf, ni,
        native.ptr_array([c.data_ptr() for c in codes]), native.int_array(list(strides)),
        len(codes), v8.data_ptr(), n, n_groups, buf.data_ptr(), cap, fs.data_ptr(),
        is_.data_ptr(), cnt.data_ptr(), 1 if cnt_dtype == torch.int64 else 0, rep.data_ptr(),
        native.stream_ptr(dev)), what)
    if cnt_dtype == torch.int32:  # the core wrote int32 counts
        cnt = cnt.view(torch.int32)[:g]
    return fs, is_, cnt, rep


def small_agg_launch(kern: _SmallAggKernel, inputs: Dict[str, torch.Tensor],
                     codes: List[torch.Tensor], strides: Tuple[int, ...], valid: torch.Tensor,
                     n_groups: int):
    """Launch K2 on CUDA tensors: the pre-pass when the plan has expression
    inputs, then the bucket core; the plain version's outputs."""
    global SMALL_AGG_LAUNCHES, SMALL_PRE_LAUNCHES
    dev = valid.device
    if dev.type != "cuda":
        raise RuntimeError(f"small_agg: unsupported device {dev}")
    inputs = {k: t.contiguous() for k, t in inputs.items()}
    pre: List[torch.Tensor] = []
    if kern.pre is not None:
        pre = _pre_launch(kern.pre, [inputs[k] for k in kern.pre_inputs], valid,
                          kern.pre_dtypes)
        SMALL_PRE_LAUNCHES += 1
    cols = [inputs[src[1]] if src[0] == "col" else pre[src[1]] for src, _ in kern.cols]
    for c, (_, tag) in zip(cols, kern.cols):
        if _AGG_TAG.get(c.dtype) != tag & 3:
            raise TypeError(f"small_agg: column {c.dtype}, expected tag {tag}")
    fs, is_, cnt, rep = _bucket_agg(cols, [t for _, t in kern.cols], kern.nf, codes, strides,
                                    n_groups, valid, torch.int64, "qk_small_agg")
    SMALL_AGG_LAUNCHES += 1
    sums = [cnt if s[0] == "c" else fs[s[1]] if s[0] == "f" else is_[s[1]]
            for s in kern.slots]
    return sums, rep


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
        return small_agg_launch(self.kern, self.inputs, self.codes, self.strides, self.valid,
                                self.n_groups)

    def run(self):
        """K2 on CUDA tensors, the plain version on CPU ones, charged to
        devprof: inputs, codes and mask read, each bucket's sums and
        smallest row written; on the card the pre-pass is charged apart
        ("K2 pre": its inputs and mask read, its outputs written)."""
        dev, n = self.valid.device.type, self.valid.shape[0]
        out = 8 * self.n_groups * (len(self.partials) + 1)
        devprof.on_dispatch(
            ("K2", dev, n, tuple(str(t.dtype) for t in self.inputs.values()),
             len(self.codes), len(self.partials), self.n_groups),
            lambda: (0.0, float(devprof.nbytes(*self.inputs.values(), *self.codes,
                                               self.valid) + out), float(out)))
        if dev == "cpu":
            return self.plain()
        if self.kern.pre is not None:
            pre_in = [self.inputs[k] for k in self.kern.pre_inputs]
            pre_out = 8 * n * len(self.kern.pre_outs)
            devprof.on_dispatch(
                ("K2 pre", dev, n, tuple(str(t.dtype) for t in pre_in), len(self.kern.pre_outs)),
                lambda: (0.0, float(devprof.nbytes(*pre_in, self.valid) + pre_out),
                         float(pre_out)))
        return self.launch()


# ---------------------------------------------------------------------------
# K5: pre-expressions of the general partial aggregate
# ---------------------------------------------------------------------------


class _PreAggKernel:
    """Generated source of one pre-expression signature: every listed
    pre-expression evaluated in one pass, one output array each.  ``name``
    is the kernel's (K5's, or K2's pre-pass ``qk_small_pre``), so that a
    profile tells the two apart."""

    def __init__(self, pre_exprs: Dict[str, Expr], outs: List[str], cols,
                 name: str = "qk_pre_agg"):
        self.name = name
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
        self.src = f"@triton.jit\ndef {name}({args}):\n" + "\n".join(body) + "\n"


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
    outs = _pre_launch(kern, inputs, valid, out_dtypes)
    PRE_AGG_LAUNCHES += 1
    return outs


def _pre_launch(kern: _PreAggKernel, inputs: List[torch.Tensor], valid: torch.Tensor,
                out_dtypes: List[torch.dtype]) -> List[torch.Tensor]:
    """One generated pre-expression kernel (K5, or K2's pre-pass) on CUDA
    tensors: one output per pre-expression, in ``out_dtypes``."""
    dev = valid.device
    n = valid.shape[0]
    _check_inputs(inputs + [valid], dev, n)
    mod = _load_generated(kern.src)
    outs = [torch.empty(n, dtype=dt, device=dev) for dt in out_dtypes]
    if n:
        block = 1024
        getattr(mod, kern.name)[(triton_cdiv(n, block),)](
            *[_kernel_arg(t) for t in inputs], valid.view(torch.uint8),
            _consts_on(kern, dev), *[_kernel_arg(o) for o in outs], n, BLOCK=block,
            num_warps=4)
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
# K6's limits (csrc/onehot.cu): distinct columns read, and rows (a row
# index is an int32 there)
_ONEHOT_MAX_SOURCES = 32
_ONEHOT_MAX_ROWS = (1 << 31) - 1 - 512
# the blocks an SM the scratch is sized for (csrc/onehot.cu's
# QK_OH_BLOCKS_PER_SM; the kernel launches no more than the scratch holds)
_ONEHOT_BLOCKS_PER_SM = 2


def _bucket_ids(codes: List[torch.Tensor], strides: Tuple[int, ...], valid: torch.Tensor,
                n_groups: int) -> torch.Tensor:
    gid = torch.zeros(valid.shape[0], dtype=torch.int64, device=valid.device)
    for c, st in zip(codes, strides):
        gid = gid + (c.to(torch.int64) + 1) * st
    return torch.where(valid, gid, torch.full_like(gid, n_groups))


def _tagged_addends(c: torch.Tensor, tag: int) -> torch.Tensor:
    """What a tagged column adds per row, as the kernels read it: float64
    for a float sum, int64 else; a null (NaN, or the int sentinel) adds 0
    under ``__nn0``, and under ``__nncount`` each value adds 1 unless null."""
    null = torch.isnan(c) if c.is_floating_point() else c == torch.iinfo(c.dtype).min
    if tag & _AGG_WRAP["__nncount"]:
        return (~null).to(torch.int64)
    x = c.to(torch.float64) if _float_tag(tag) else c.to(torch.int64)
    if tag & _AGG_WRAP["__nn0"]:
        x = torch.where(null, torch.zeros((), dtype=x.dtype, device=x.device), x)
    return x


def onehot_agg_plain(cols: List[torch.Tensor], tags: List[int], nf: int,
                     codes: List[torch.Tensor], strides: Tuple[int, ...], n_groups: int,
                     valid: torch.Tensor):
    """Plain version of K6 over tagged columns (K2's tags, ``_AGG_TAG`` |
    ``_AGG_WRAP``: the first ``nf`` sum into float64, the rest exactly into
    int64): (float64 sums [nf, G], int64 sums [ni, G], counts [G] int32,
    smallest row [G] int64, n where empty), each a per-bucket ``index_add_``
    or ``scatter_reduce``.  Invalid rows go to a dump bucket that no output
    reads; a NaN or an infinity in a valid row stays in its bucket."""
    n = valid.shape[0]
    dev = valid.device
    gid = _bucket_ids(codes, strides, valid, n_groups)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rep = torch.full((n_groups + 1,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, iota, reduce="amin")[:n_groups]

    def sums(x):
        x = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=dev))
        return torch.zeros(n_groups + 1, dtype=x.dtype, device=dev).index_add_(0, gid, x)[:n_groups]

    per = [sums(_tagged_addends(c, t)) for c, t in zip(cols, tags)]
    fs = torch.stack(per[:nf]) if nf else torch.zeros((0, n_groups), dtype=torch.float64,
                                                       device=dev)
    is_ = torch.stack(per[nf:]) if len(per) > nf else \
        torch.zeros((0, n_groups), dtype=torch.int64, device=dev)
    counts = sums(valid.to(torch.int64)).to(torch.int32)
    return fs, is_, counts, rep


def _onehot_lib():
    lib = native.library("onehot")
    if not getattr(lib, "qk_onehot_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pi = ctypes.POINTER(I)
        lib.qk_onehot_agg.argtypes = [ctypes.POINTER(P), pi, I, pi, pi, I, I, ctypes.POINTER(P),
                                      pi, I, P, L, I, P, L, I, P, P, P, P, P]
        lib.qk_onehot_agg.restype = I
        lib.qk_onehot_bound = True
    return lib


_ONEHOT_SIGS: Dict[Tuple, Tuple] = {}  # call signature -> its ctypes arrays and sizes


def _tma_ptr(t: torch.Tensor, keep: List[torch.Tensor]) -> int:
    """The address K6 reads t at: t's own when it is contiguous and 16-byte
    aligned (a TMA copy's source), else a contiguous copy's, held in
    ``keep`` until the launch has been issued."""
    p = t.data_ptr()
    if p & 15 or not t.is_contiguous():
        t = t.clone(memory_format=torch.contiguous_format)
        keep.append(t)
        p = t.data_ptr()
    return p


def onehot_agg_cuda(cols: List[torch.Tensor], tags: List[int], nf: int,
                    codes: List[torch.Tensor], strides: Tuple[int, ...], n_groups: int,
                    valid: torch.Tensor):
    """Launch K6 (the one-hot product, then its reduce) on CUDA tensors; the
    plain version's outputs.  A tensor read under two tags is one source.
    Every converted or contiguous copy is held in ``keep`` until the launch
    has been issued; outputs and scratch are one allocation, and what does
    not change between calls of one signature is made once."""
    global ONEHOT_LAUNCHES
    dev = valid.device
    n = valid.shape[0]
    if dev.type != "cuda":
        raise RuntimeError(f"onehot_agg: unsupported device {dev}")
    if valid.dtype not in (torch.bool, torch.uint8) or valid.dim() != 1:
        raise TypeError(f"onehot_agg: mask {valid.dtype} {tuple(valid.shape)}, expected a "
                        f"bool or uint8 vector")
    if len(cols) != len(tags) or not 0 <= nf <= len(cols):
        raise ValueError(f"onehot_agg: {len(cols)} columns, {len(tags)} tags, {nf} float")
    if not 1 <= n <= _ONEHOT_MAX_ROWS or len(cols) > _BUCKET_MAX_COLUMNS \
            or not 1 <= len(codes) <= _BUCKET_MAX_KEYS \
            or not 1 <= n_groups < _SMALL_GROUPBY_MAX_BUCKETS:
        raise ValueError(f"onehot_agg: {n} rows, {len(cols)} columns, {len(codes)} keys, "
                         f"{n_groups} groups: K6 takes 1 to {_ONEHOT_MAX_ROWS} rows, at most "
                         f"{_BUCKET_MAX_COLUMNS} columns, 1 to {_BUCKET_MAX_KEYS} keys and 1 "
                         f"to {_SMALL_GROUPBY_MAX_BUCKETS - 1} groups")
    keep: List[torch.Tensor] = []
    where: Dict[Tuple[int, torch.dtype], int] = {}  # (address, type) -> source
    seen: Dict[int, int] = {}  # id of a column passed again -> its source
    ent_src = []
    for c, t in zip(cols, tags):
        if c.shape != (n,) or c.device != dev or _AGG_TAG.get(c.dtype) != t & 3:
            raise TypeError(f"onehot_agg: column {c.dtype} {tuple(c.shape)} on {c.device} "
                            f"under tag {t}, expected [{n}] on {dev}")
        s = seen.get(id(c))
        if s is None:
            s = seen[id(c)] = where.setdefault((_tma_ptr(c, keep), c.dtype), len(where))
        ent_src.append(s)
    if len(where) > _ONEHOT_MAX_SOURCES:
        raise ValueError(f"onehot_agg: {len(where)} distinct columns; K6 reads at most "
                         f"{_ONEHOT_MAX_SOURCES}")
    code_ptrs = []
    for c in codes:
        if c.shape != (n,) or c.device != dev:
            raise TypeError(f"onehot_agg: codes {tuple(c.shape)} on {c.device}, expected [{n}]")
        if c.dtype != torch.int32:
            c = c.to(torch.int32)
            keep.append(c)
        code_ptrs.append(_tma_ptr(c, keep))
    valid_ptr = _tma_ptr(valid, keep)
    sig = (dev.index, tuple(tags), nf, tuple(ent_src), tuple(dt for _, dt in where),
           tuple(strides), n_groups)
    hit = _ONEHOT_SIGS.get(sig)
    if hit is None:
        nncount = sum(1 for t in tags[nf:] if t & _AGG_WRAP["__nncount"])
        ncols = nf + 3 * (len(tags) - nf - nncount) + 1  # floats, limbs, the ones
        cap = _ONEHOT_BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
        scratch = cap * (ncols + nncount + 1) * n_groups
        ni = len(cols) - nf
        hit = _ONEHOT_SIGS[sig] = (
            native.int_array([_AGG_TAG[dt] for _, dt in where]), native.int_array(ent_src),
            native.int_array(list(tags)), native.int_array(list(strides)), cap, scratch,
            (scratch, nf * n_groups, ni * n_groups, n_groups, n_groups))
    src_types, ent_arr, tag_arr, stride_arr, cap, scratch, sizes = hit
    buf = torch.empty(sum(sizes), dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    fs_at = base + 8 * scratch
    is_at = fs_at + 8 * sizes[1]
    rep_at = is_at + 8 * sizes[2]
    native.check(_onehot_lib().qk_onehot_agg(
        native.ptr_array([p for p, _ in where]), src_types, len(where), ent_arr, tag_arr, nf,
        len(cols) - nf, native.ptr_array(code_ptrs), stride_arr, len(codes), valid_ptr, n,
        n_groups, base, scratch, cap, fs_at, is_at, rep_at + 8 * n_groups, rep_at,
        native.stream_ptr(dev)), "qk_onehot_agg")
    ONEHOT_LAUNCHES += 1
    _, fs, is_, rep, cnt = buf.split_with_sizes(sizes)
    return (fs.view(torch.float64).view(nf, n_groups), is_.view(len(cols) - nf, n_groups),
            cnt.view(torch.int32)[:n_groups], rep)


def onehot_agg(cols: List[torch.Tensor], tags: List[int], nf: int, codes: List[torch.Tensor],
               strides: Tuple[int, ...], n_groups: int, valid: torch.Tensor):
    """K6: per-bucket float64 sums, exact int64 sums, int32 counts and the
    smallest row id of tagged columns.  CUDA tensors launch the kernel; CPU
    tensors take the plain version.  Charged to devprof: each distinct
    column, the codes and the mask read once, the outputs written."""
    out = n_groups * (8 * len(cols) + 12)
    devprof.on_dispatch(
        ("K6", valid.device.type, valid.shape[0], tuple(tags), nf, len(codes), n_groups),
        lambda: (0.0, float(devprof.nbytes(*{(c.data_ptr(), c.dtype): c for c in cols}.values(),
                                           *codes, valid) + out), float(out)))
    if valid.device.type == "cpu":
        return onehot_agg_plain(cols, tags, nf, codes, strides, n_groups, valid)
    return onehot_agg_cuda(cols, tags, nf, codes, strides, n_groups, valid)


class _OnehotPlan:
    """How one small-key plan signature feeds K6: K2's plan
    (``_SmallAggKernel``: each partial a plain column read in place, an
    output of the generated pre-pass ``qk_onehot_pre``, or the count), and
    the type each integer sum comes back in, its plain evaluation's (an
    int32 sum wraps as the reference's segment sum does)."""

    def __init__(self, pre_exprs: Dict[str, Expr], partials, inputs: Dict[str, torch.Tensor],
                 valid: torch.Tensor):
        self.kern = _SmallAggKernel(pre_exprs, partials, inputs, valid, "qk_onehot_pre")
        tmps = [tmp for _, op, tmp in partials if op != "count"]
        dts = iter([t.dtype for t in pre_exprs_plain(
            pre_exprs, tmps, {n: t[:0] for n, t in inputs.items()}, valid[:0])])
        self.dtypes = [None if op == "count" else next(dts) for _, op, _ in partials]


def onehot_pre(kern: _SmallAggKernel, pre_exprs: Dict[str, Expr],
               inputs: Dict[str, torch.Tensor], valid: torch.Tensor) -> List[torch.Tensor]:
    """K6's pre-pass (K5's generator over the expression inputs only): one
    float64 or int64 column per expression input.  CUDA tensors launch the
    generated kernel, counted as ``ONEHOT_PRE_LAUNCHES`` and charged to
    devprof as "K6 pre"; CPU tensors take K5's plain evaluator."""
    global ONEHOT_PRE_LAUNCHES
    dev, n = valid.device.type, valid.shape[0]
    pre_in = [inputs[k] for k in kern.pre_inputs]
    out = 8 * n * len(kern.pre_outs)
    devprof.on_dispatch(
        ("K6 pre", dev, n, tuple(str(t.dtype) for t in pre_in), len(kern.pre_outs)),
        lambda: (0.0, float(devprof.nbytes(*pre_in, valid) + out), float(out)))
    if dev == "cpu":
        return [x.to(dt) for x, dt in zip(pre_exprs_plain(pre_exprs, kern.pre_outs, inputs, valid),
                                          kern.pre_dtypes)]
    outs = _pre_launch(kern.pre, pre_in, valid, kern.pre_dtypes)
    ONEHOT_PRE_LAUNCHES += 1
    return outs


class FusedPartialAgg:
    """Per-batch partial group-by aggregate.

    Small-key path: every key is a dictionary string, the plan has only
    sum/count partials and the product of dictionary sizes is small (TPC-H
    Q1: returnflag x linestatus).  Under the default ``groupby=hashtable`` it
    is K2 (the reference's scatter strategy); under ``groupby=sort`` it is
    K6 (its one-hot matmul), with K6's pre-pass for expression inputs,
    where the one-hot fits the reference's 512 MiB gate.  The output is a
    256-row bucket.  Other shapes take the general path: the pre-expressions in one kernel (K5), then the group-by
    the strategy picks (K3, or row 10's sort group-by), as the reference's
    general fused program does."""

    def __init__(self, keys: List[str], plan):
        self.keys = keys
        self.plan = plan
        self._kernels: Dict[Tuple, _SmallAggKernel] = {}
        self._pre_kernels: Dict[Tuple, Tuple[_PreAggKernel, List[torch.dtype]]] = {}
        self._onehot_plans: Dict[Tuple, _OnehotPlan] = {}

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
        sig = (tuple((k, e.sql()) for k, e in pre_exprs.items()), tuple(cols))
        kern = self._kernels.get(sig)
        if kern is None:
            kern = _SmallAggKernel(pre_exprs, self.plan.partials, inputs, batch.valid)
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
        """The one-hot small-key aggregate (K6, and its pre-pass when a
        partial's input is an expression): per-partial bucket arrays [G] and
        the smallest row of each bucket.  Plain columns are read in place:
        no K5, no copy."""
        pre_exprs, inputs = self._pre_inputs(batch)
        sig = (tuple((k, e.sql()) for k, e in pre_exprs.items()),
               tuple((n, t.dtype) for n, t in inputs.items()))
        plan = self._onehot_plans.get(sig)
        if plan is None:
            plan = self._onehot_plans[sig] = _OnehotPlan(pre_exprs, self.plan.partials, inputs,
                                                         batch.valid)
        kern = plan.kern
        pre = onehot_pre(kern, pre_exprs, inputs, batch.valid) if kern.pre is not None else []
        cols = [inputs[src[1]] if src[0] == "col" else pre[src[1]] for src, _ in kern.cols]
        codes = [batch.columns[k].codes for k in self.keys]
        fs, is_, counts, rep_b = onehot_agg(cols, [t for _, t in kern.cols], kern.nf, codes,
                                            self._strides(dims), int(np.prod(dims)), batch.valid)
        # integer sums come back in their own type (an int32 sum wraps as
        # the reference's segment sum does), count(*) in int32
        sums = [counts if s[0] == "c" else fs[s[1]] if s[0] == "f" else is_[s[1]].to(dt)
                for s, dt in zip(kern.slots, plan.dtypes)]
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
