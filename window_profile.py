#!/usr/bin/env python3
"""Profile K3, K19, K20a and K20b of the PyTorch port on one NVIDIA GPU.

    python3 window_profile.py [--package DIR] [--variants] [--seed N] [--out FILE]

K3 is the hash group-by, K19 the segmented scan (its general form and its
segment bounds, the scan both ways), K20a the sliding-window bounds and
K20b the range min/max.

It runs TPC-H Q1 and Q3 at SF1 and the tumbling, hopping and sliding
windows over bench.py's ticks (chip_smoke.py's data and queries) through
this checkout's quokka_tpu_torch, and keeps the arguments of K3's largest
call on Q1 (a recombine of partial aggregates), on Q3, on tumbling and on
hopping, and of K20b's first and last largest calls on sliding (a batch of
live rows, and the last batch, half of it padding rows, whose windows the
executor cuts to their own row).  For the last batch it also keeps the
windows K20a gave before that cut (every padding row's window spans the
padding), and times the cut itself (two ``torch.where``).  It makes K20b's
case of one symbol holding every quote (chip_smoke.py's: the quotes sorted
by time in one segment, padded to the bucket, K20a's 10-second windows,
the padding rows' windows cut as the executor cuts them).  K19: its
general form at the as-of sort strategy's largest call (5,242,880 rows)
and on sliding's start flags (the start form, 2^20 rows), and every row's
segment start and end at sliding's and shift's largest calls, where the
parent package (which has no segment bounds) runs what its executors ran:
K19 on the start form, then row 20's flip and cummin; ``torch.cummax`` of
the start form and the flip and cummin alone are timed as yardsticks.
K20a: sliding's first full batch and its padded batch, and the one-symbol
case (its segment runs on into the zero-time padding, so every row takes
the reference's searches).  At those arguments it calls the wrapper of
this checkout's package and, with
``--package``, of another checkout's (e.g. the parent commit unpacked
with ``git archive``) in turns (package, this, this, package), and
reports per call:

- the wrapper's ms, CUDA events over many calls;
- the host ms, time.perf_counter over calls issued with no
  synchronisation;
- the device us of every device operation of the call (memsets, fills,
  scans, copies and kernels: the profiler's device events), in all and by
  operation, with each operation's count per call;
- the allocations per call (the caching allocator's requests);
- whether the call made a host read (torch.cuda.set_sync_debug_mode
  "error" raises on one);

beside the bound, the bytes the function must move over 3.35 TB/s (K3:
every row's validity byte, the keys and inputs of the live rows, the
outputs; K20b: x, both bounds and the output, 24 B a float64 row).  It
checks K3 against its plain version (groups matched by their smallest row,
floats within rtol 1e-9), K19 and K20a against this package's plain
versions bit for bit, and K20b against the other package's values (NaN
equal to NaN), and compiles csrc/hashtable.cu, csrc/asof.cu and
csrc/window.cu with
``-Xptxas -v`` (vector_profile.py's compile_sources) to keep each kernel's
registers, shared memory and spills.  With ``--variants`` it also builds K3
from copies of csrc/hashtable.cu patched here (``K3_VARIANTS``, each
(text, replacement) pair must match once) and times each at the four K3
shapes against the production kernel's results.

It prints the card's name and power limit, one line per measurement and
one JSON line, and writes the JSON to ``--out``.  It imports neither JAX
nor quokka_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
K3_SHAPES = ("q1", "q3", "tumbling", "hopping")
# The shared-memory fold: a block keeps up to 512 of its groups in shared
# slots (rank -> slot by a short linear probe), folds its rows' counts,
# smallest rows and first eight aggregates there with shared atomics, and
# adds each slot into the outputs with one global atomic per output; a row
# whose group finds no slot adds straight into the outputs.
_FOLD_HELPERS = r"""
#define QK_FOLD_SLOTS 512
#define QK_FOLD_SHIFT 9
#define QK_FOLD_COLS 8
#define QK_FOLD_PROBES 8

template <typename T, int OP>
__device__ __forceinline__ void qk_fold_init(const GbCols& C, int a, unsigned long long* acc) {
  for (int s = threadIdx.x; s < QK_FOLD_SLOTS; s += blockDim.x) {
    if (OP == QK_COUNT) *(int32_t*)(acc + s) = 0;
    else *(T*)(acc + s) = OP == QK_MIN ? qk_ident_min<T>() : (OP == QK_MAX ? qk_ident_max<T>() : (T)0);
  }
}

template <typename T, int OP>
__device__ __forceinline__ void qk_fold_add(const GbCols& C, int a, unsigned long long* acc,
                                            const long long* row, const long long* r,
                                            const int* fs) {
  if (OP == QK_FIRST) return;
  const T* in = (const T*)C.in[a];
#pragma unroll
  for (int j = 0; j < QK_GB_ITEMS; ++j) {
    if (r[j] < 0) continue;
    const T x = in[row[j]];
    if (OP == QK_COUNT) {
      if (x == x)
        atomicAdd(fs[j] >= 0 ? (int32_t*)(acc + fs[j]) : (int32_t*)C.out[a] + r[j], 1);
      continue;
    }
    T* p = fs[j] >= 0 ? (T*)(acc + fs[j])
                      : (OP == QK_MEAN ? (T*)C.acc[a] + r[j] : (T*)C.out[a] + r[j]);
    if (OP == QK_SUM || OP == QK_MEAN) qk_atomic_add(p, x);
    else qk_atomic_minmax(p, x, OP == QK_MIN);
  }
}

template <typename T, int OP>
__device__ __forceinline__ void qk_fold_flush(const GbCols& C, int a,
                                              const unsigned long long* acc, const int* skey) {
  if (OP == QK_FIRST) return;
  for (int s = threadIdx.x; s < QK_FOLD_SLOTS; s += blockDim.x) {
    const int r = skey[s];
    if (r < 0) continue;
    if (OP == QK_COUNT) atomicAdd((int32_t*)C.out[a] + r, *(const int32_t*)(acc + s));
    else {
      const T v = *(const T*)(acc + s);
      if (OP == QK_SUM) qk_atomic_add((T*)C.out[a] + r, v);
      else if (OP == QK_MEAN) qk_atomic_add((T*)C.acc[a] + r, v);
      else qk_atomic_minmax((T*)C.out[a] + r, v, OP == QK_MIN);
    }
  }
}

"""
_FOLD = [
    ("// no early return: every block meets every barrier\n",
     _FOLD_HELPERS + "// no early return: every block meets every barrier\n"),
    ("  for (int a = 0; a < S.C.k; ++a) QK_GB_DISPATCH(S.C.kind[a], qk_fill_col, S.C, a, n, g0, step)\n",
     "  for (int a = 0; a < S.C.k; ++a) QK_GB_DISPATCH(S.C.kind[a], qk_fill_col, S.C, a, n, g0, step)\n"
     "  __shared__ int skey[QK_FOLD_SLOTS], scount[QK_FOLD_SLOTS], srep[QK_FOLD_SLOTS];\n"
     "  __shared__ unsigned long long sacc[QK_FOLD_COLS][QK_FOLD_SLOTS];\n"
     "  const int kf = S.C.k < QK_FOLD_COLS ? S.C.k : QK_FOLD_COLS;\n"
     "  for (int s = threadIdx.x; s < QK_FOLD_SLOTS; s += blockDim.x) {\n"
     "    skey[s] = -1;\n    scount[s] = 0;\n    srep[s] = 0x7fffffff;\n  }\n"
     "  for (int a = 0; a < kf; ++a) QK_GB_DISPATCH(S.C.kind[a], qk_fold_init, S.C, a, sacc[a])\n"),
    ("      atomicAdd(S.counts + r[j], 1);\n      atomicMin(S.rep + r[j], (int32_t)row[j]);\n",
     "      fs[j] = -1;\n"
     "      const uint32_t h = ((uint32_t)r[j] * 0x9E3779B1u) >> (32 - QK_FOLD_SHIFT);\n"
     "      for (int q = 0; q < QK_FOLD_PROBES; ++q) {\n"
     "        const int s = (h + q) & (QK_FOLD_SLOTS - 1);\n"
     "        const int prev = atomicCAS(&skey[s], -1, (int)r[j]);\n"
     "        if (prev == -1 || prev == (int)r[j]) {\n          fs[j] = s;\n          break;\n"
     "        }\n      }\n"
     "      if (fs[j] >= 0) {\n        atomicAdd(&scount[fs[j]], 1);\n"
     "        atomicMin(&srep[fs[j]], (int32_t)row[j]);\n      } else {\n"
     "        atomicAdd(S.counts + r[j], 1);\n        atomicMin(S.rep + r[j], (int32_t)row[j]);\n"
     "      }\n"),
    ("    long long row[QK_GB_ITEMS], r[QK_GB_ITEMS];\n",
     "    long long row[QK_GB_ITEMS], r[QK_GB_ITEMS];\n    int fs[QK_GB_ITEMS];\n"),
    ("    for (int a = 0; a < S.C.k; ++a) QK_GB_DISPATCH(S.C.kind[a], qk_add_col, S.C, a, row, r)\n  }\n",
     "    for (int a = 0; a < S.C.k; ++a) {\n"
     "      if (a < kf) QK_GB_DISPATCH(S.C.kind[a], qk_fold_add, S.C, a, sacc[a], row, r, fs)\n"
     "      else QK_GB_DISPATCH(S.C.kind[a], qk_add_col, S.C, a, row, r)\n    }\n  }\n"
     "  __syncthreads();\n"
     "  for (int s = threadIdx.x; s < QK_FOLD_SLOTS; s += blockDim.x) {\n"
     "    if (skey[s] < 0) continue;\n"
     "    atomicAdd(S.counts + skey[s], scount[s]);\n    atomicMin(S.rep + skey[s], srep[s]);\n  }\n"
     "  for (int a = 0; a < kf; ++a) QK_GB_DISPATCH(S.C.kind[a], qk_fold_flush, S.C, a, sacc[a], skey)\n"),
]
# K3 built from csrc/hashtable.cu with these (text, replacement) patches
K3_VARIANTS = {"shared-memory fold (512 slots a block)": _FOLD}


def k3_bytes(ht, lb, ar, op, va) -> int:
    """Every row's validity byte, the live rows' keys and inputs, and the
    outputs (counts, smallest rows, the group count, one array per
    aggregate; an integer count is the counts array itself)."""
    m, live = va.shape[0], int(va.sum())
    ko, kc, _, _ = ht.hash_groupby_plain(lb, ar, op, va)
    outs = sum(o.numel() * o.element_size() for o in ko if o is not kc)
    return m + live * sum(t.element_size() for t in (*lb, *ar)) + m * 8 + 4 + outs


def k3_agree(got, want) -> bool:
    """K3 against its plain version: groups matched by their smallest row,
    floats within rtol 1e-9, the rest exact."""
    import torch

    ko, kc, kr, kn = got
    po, pc, pr, pn = want
    g = int(kn)
    if g != int(pn):
        return False
    ki, pi = torch.argsort(kr[:g]), torch.argsort(pr[:g])
    if not (torch.equal(kr[:g][ki], pr[:g][pi]) and torch.equal(kc[:g][ki], pc[:g][pi])):
        return False
    for a, c in zip(ko, po):
        a, c = a[:g][ki], c[:g][pi]
        if a.is_floating_point():
            if not torch.allclose(a, c, rtol=1e-9, atol=1e-12, equal_nan=True):
                return False
        elif not torch.equal(a, c):
            return False
    return True


def values_equal(a, b) -> bool:
    """Value equality, NaN equal to NaN."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return False
        a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
    return torch.equal(a, b)


def host_read(fn) -> bool:
    """Whether one call of fn reads the device from the host."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def call_profile(name, fn, iters: int) -> dict:
    """One wrapper's figures per call (see the module note)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from search_profile import measure

    row = measure(name, fn, None, iters, 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    ev = chip_smoke.device_events(prof)
    row["device_ops_by_name"] = {k.split("(")[0]: c / 10 for k, (_, c) in ev.items()}
    row["device_ops"] = sum(row["device_ops_by_name"].values())
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    row["host_ms"] = host
    row["allocations"] = (torch.cuda.memory_stats()["allocation.all.allocated"] - a0) / iters
    row["host_read"] = host_read(fn)
    print(f"  {name}: {row['ms']:.4f} ms, host {host:.4f} ms, {row['device_us']:.1f} device us "
          f"in {row['device_ops']:g} device operations, {row['allocations']:g} allocations, "
          f"host read {row['host_read']}", flush=True)
    return row


def variant_sources() -> dict:
    """{label: .cu path} of K3_VARIANTS, written into build/window_profile/."""
    from quokka_tpu_torch.ops import native

    base = (native.CSRC_DIR / "hashtable.cu").read_text()
    out = {}
    for i, patches in enumerate(K3_VARIANTS.values()):
        src = base
        for a, b in patches:
            if src.count(a) != 1:
                raise RuntimeError(f"K3 variant {i}: {a!r} is not once in csrc/hashtable.cu")
            src = src.replace(a, b)
        path = ROOT / "build" / "window_profile" / f"k3_variant_{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        out[f"k3_variant_{i}"] = path
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=None,
                    help="root of another checkout whose quokka_tpu_torch is timed in turns "
                         "with this one's")
    ap.add_argument("--variants", action="store_true",
                    help="also time K3 built with each of K3_VARIANTS at its four shapes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "window_profile.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("window_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"window_profile: no quokka_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    other = Path(args.package).resolve() if args.package else None
    if other is not None and not (other / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"window_profile: no quokka_tpu_torch package in {other}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from quokka_tpu_torch.ops import native
    from vector_profile import compile_sources, load_package

    built = compile_sources({"hashtable": native.CSRC_DIR / "hashtable.cu",
                             "asof": native.CSRC_DIR / "asof.cu",
                             "window": native.CSRC_DIR / "window.cu",
                             **(variant_sources() if args.variants else {})})
    report = {"card": card, "package": str(other) if other else None,
              "ptxas": {**built["hashtable"][1], **built["asof"][1], **built["window"][1]}}
    dev = torch.device("cuda", 0)
    this = load_package(ROOT, ("hashtable", "asof", "window"))

    # the calls: captured on this checkout's package
    tables = chip_smoke.make_tpch(1.0, args.seed)
    ticks = chip_smoke.make_ticks(1.0, args.seed)
    ctx = this.pkg.QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    k3_target = {"K3": (this.ht, "hash_groupby", lambda l, a, o, v: v.shape[0])}
    this_asof = this.pkg.ops.asof
    bounds_target = {"K19 bounds": (this_asof, "segment_bounds", lambda fl: fl.shape[0])}
    k20b_target = {"K20b": (this.ts, "range_minmax", lambda x, lf, rt, op: x.shape[0]),
                   "K20a": (this.ts, "window_bounds", lambda t, ss, se, size: t.shape[0]),
                   **bounds_target}
    targets = {"sliding": k20b_target, "shift": bounds_target,
               "asof sort": {"K19": (this_asof, "seg_fill_forward", lambda v, st: v.shape[0])}}
    k3, calls, k19_flags = {}, {}, {}
    for path in K3_SHAPES + ("sliding", "shift", "asof sort"):
        # the as-of sort strategy's stream is the as-of path's, under asof=sort
        stream = (chip_smoke.tpch_stream(path, ctx, tables) if path in ("q1", "q3")
                  else chip_smoke.tick_stream("asof" if path == "asof sort" else path, ctx,
                                              ticks))
        if path == "asof sort":
            os.environ["QK_KERNEL_STRATEGY"] = "asof=sort"
        try:
            with chip_smoke.Capture(targets.get(path, k3_target),
                                    keep_every=["K20b", "K20a"] if path == "sliding"
                                    else ()) as cap:
                chip_smoke.collect_numpy(stream, path)
        finally:
            os.environ.pop("QK_KERNEL_STRATEGY", None)
        calls[path] = cap.calls
        if path in ("sliding", "shift"):
            k19_flags[path] = cap.args["K19 bounds"][0][0]
        if path == "asof sort":
            k19_sort = cap.args["K19"][0]
        elif path == "sliding":
            k20b_big = cap.args["K20b"][0]  # the last of the largest: the padded batch
            every = [a for a, _ in cap.every["K20b"]]
            k20b_full = next(a for a in every if a[0].shape[0] == k20b_big[0].shape[0])
            # the padded batch's windows as K20a gave them, before the cut
            raw = this.ts.window_bounds(*cap.args["K20a"][0])
            iota = torch.arange(raw[0].shape[0], dtype=torch.int32, device=dev)
            cut = (k20b_big[1] == iota) & (k20b_big[2] == iota)
            if not all(torch.equal(torch.where(cut, b, a), b) for a, b in zip(raw, k20b_big[1:3])):
                raise RuntimeError("sliding: the last K20a call is not the padded batch's")
            k20b_uncut = (k20b_big[0], *raw, k20b_big[3])
            k20b_cut = (cut, iota, *raw)
            k20a_padded = cap.args["K20a"][0]
            k20a_full = next(a for a, _ in cap.every["K20a"]
                             if a[0].shape[0] == k20a_padded[0].shape[0])
        elif path != "shift":
            k3[path] = cap.args["K3"][0]
    report["calls_per_query"] = calls
    print(f"calls per query: {calls}", flush=True)

    # K20b on one symbol holding every quote, as chip_smoke.py makes it
    qu = ticks["quotes"]
    bridge, asof = this.pkg.ops.bridge, this.pkg.ops.asof
    pad = this.pkg.config.bucket_size(len(qu["time"]))
    order = np.argsort(qu["time"], kind="stable")
    t_s = bridge.pad_tail(torch.from_numpy(qu["time"][order]).to(dev), pad)
    key = bridge.pad_tail(torch.zeros(len(order), dtype=torch.int64, device=dev), pad)
    io = torch.arange(pad, dtype=torch.int32, device=dev)
    flag = (key != torch.roll(key, 1)) | (io == 0)
    ss = asof._seg_fill_forward_plain(torch.where(flag, io, torch.full_like(io, -1)), flag)
    se = io + this.ts._rows_from_segment_end(io, flag, pad)
    lr = this.ts._window_bounds_cuda(t_s, ss, se, chip_smoke.TS_SLIDE)
    lr = [torch.where(io < len(order), b, io) for b in lr]  # the padding's cut
    x_one = bridge.pad_tail(torch.from_numpy(qu["bid"][order]).to(dev), pad)
    k20b = {"sliding, a full batch": k20b_full, "sliding, the padded batch": k20b_big,
            "sliding, the padded batch before the cut": k20b_uncut,
            "one symbol": (x_one, *lr, k20b_big[3])}
    k20a = {"sliding, a full batch": k20a_full, "sliding, the padded batch": k20a_padded,
            "one symbol holding every quote": (t_s, ss, se, chip_smoke.TS_SLIDE)}

    pkgs = {"this": this}
    if other is not None:
        pkgs["package"] = load_package(other, ("hashtable", "asof", "window"))
    turns = ["package", "this", "this", "package"] if other is not None else ["this", "this"]

    report["k3"] = {}
    for shape, (lb, ar, op, va) in k3.items():
        entry = {"shape": f"{va.shape[0]} rows ({int(va.sum())} live), {len(lb)} key columns "
                          f"{[str(t.dtype) for t in lb]}, aggregates {list(op)}",
                 "bound_ms": k3_bytes(this.ht, lb, ar, op, va) / HBM_BYTES_PER_S * 1e3,
                 "turns": []}
        print(f"K3 {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        want = this.ht.hash_groupby_plain(lb, ar, op, va)
        for t in turns:
            fn = lambda t=t: pkgs[t].ht.hash_groupby(lb, ar, op, va)  # noqa: E731
            row = call_profile(f"K3 {shape} ({t})", fn, 50 if shape == "q1" else 20)
            row["matches_plain"] = k3_agree(fn(), want)
            entry["turns"].append({"package": t, **row})
        report["k3"][shape] = entry

    if args.variants:
        prod = this.ht._lib()
        report["k3_variants"] = {}
        for i, label in enumerate(K3_VARIANTS):
            lib = ctypes.CDLL(str(built[f"k3_variant_{i}"][0]))
            for f in ("qk_gb_scratch", "qk_groupby", "qk_segment_ranked"):
                getattr(lib, f).argtypes = getattr(prod, f).argtypes
                getattr(lib, f).restype = getattr(prod, f).restype
            this.ht._lib = lambda lib=lib: lib
            rows = {}
            for shape, (lb, ar, op, va) in k3.items():
                fn = lambda: this.ht.hash_groupby(lb, ar, op, va)  # noqa: E731
                row = call_profile(f"K3 {shape}, variant: {label}", fn,
                                   50 if shape == "q1" else 20)
                row["matches_plain"] = k3_agree(fn(), this.ht.hash_groupby_plain(lb, ar, op, va))
                rows[shape] = row
            report["k3_variants"][label] = {"ptxas": built[f"k3_variant_{i}"][1], **rows}
        this.ht._lib = lambda: prod

    report["k20b"] = {}
    for shape, (x, lf, rt, op) in k20b.items():
        n = x.shape[0]
        entry = {"shape": f"{n} rows, {x.dtype}, {op}, widest window "
                          f"{int((rt.long() - lf.long()).max()) + 1} rows",
                 "bound_ms": n * (2 * x.element_size() + 8) / HBM_BYTES_PER_S * 1e3,
                 "turns": []}
        print(f"K20b {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        ref = this.ts._range_minmax_plain(x, lf, rt, op)
        for t in turns:
            fn = lambda t=t: pkgs[t].ts._range_minmax_cuda(x, lf, rt, op)  # noqa: E731
            row = call_profile(f"K20b {shape} ({t})", fn, 50)
            row["matches_plain"] = values_equal(fn(), ref)
            entry["turns"].append({"package": t, **row})
        report["k20b"][shape] = entry

    # K19: the general form, and the segment start and end of every row (the
    # parent: K19 on the start form, then row 20's flip and cummin)
    def start_form(fl):
        io = torch.arange(fl.shape[0], dtype=torch.int32, device=fl.device)
        return torch.where(fl, io, torch.full_like(io, -1)), fl

    def parent_bounds(pk, fl):
        io = torch.arange(fl.shape[0], dtype=torch.int32, device=fl.device)
        start = pk.pkg.ops.asof._seg_fill_forward_cuda(*start_form(fl))
        return start, io + pk.ts._rows_from_segment_end(io, fl, fl.shape[0])

    k19_cases = {"general form, asof sort": k19_sort,
                 "general form, sliding's start form": start_form(k19_flags["sliding"])}
    report["k19"] = {}
    for shape, (v, st) in k19_cases.items():
        n = v.shape[0]
        entry = {"shape": f"{n} rows, {int(st.sum())} starts",
                 "bound_ms": n * 9 / HBM_BYTES_PER_S * 1e3, "turns": []}
        print(f"K19 {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        ref = this_asof._seg_fill_forward_plain(v, st)
        for t in turns:
            fn = lambda t=t: pkgs[t].pkg.ops.asof._seg_fill_forward_cuda(v, st)  # noqa: E731
            row = call_profile(f"K19 {shape} ({t})", fn, 50)
            row["matches_plain"] = torch.equal(fn(), ref)
            entry["turns"].append({"package": t, **row})
        if shape.endswith("start form"):
            entry["cummax"] = call_profile(f"K19 {shape}: torch.cummax (yardstick)",
                                           lambda: torch.cummax(v, 0), 50)
        report["k19"][shape] = entry
    for path, fl in k19_flags.items():
        n = fl.shape[0]
        shape = f"segment bounds, {path}"
        entry = {"shape": f"{n} rows, {int(fl.sum())} starts",
                 "bound_ms": n * 9 / HBM_BYTES_PER_S * 1e3, "turns": []}
        print(f"K19 {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        ref = this_asof._segment_bounds_plain(fl)
        for t in turns:
            if t == "this":
                fn = lambda: this_asof._segment_bounds_cuda(fl)  # noqa: E731
            else:
                fn = lambda: parent_bounds(pkgs["package"], fl)  # noqa: E731
            row = call_profile(f"K19 {shape} ({t})", fn, 50)
            row["matches_plain"] = all(torch.equal(a, b) for a, b in zip(fn(), ref))
            entry["turns"].append({"package": t, **row})
        io = torch.arange(n, dtype=torch.int32, device=dev)
        entry["flip_cummin"] = call_profile(
            f"K19 {shape}: row 20's flip + cummin (yardstick)",
            lambda: this.ts._rows_from_segment_end(io, fl, n), 50)
        report["k19"][shape] = entry

    report["k20a"] = {}
    for shape, (tt, s0, e0, size) in k20a.items():
        n = tt.shape[0]
        entry = {"shape": f"{n} rows, {tt.dtype}, size {size}",
                 "bound_ms": n * 24 / HBM_BYTES_PER_S * 1e3, "turns": []}
        print(f"K20a {shape}: {entry['shape']}, bound {entry['bound_ms']:.5f} ms", flush=True)
        ref = this.ts._window_bounds_plain(tt, s0, e0, size)
        for t in turns:
            fn = lambda t=t: pkgs[t].ts._window_bounds_cuda(tt, s0, e0, size)  # noqa: E731
            row = call_profile(f"K20a {shape} ({t})", fn, 50)
            row["matches_plain"] = all(torch.equal(a, b) for a, b in zip(fn(), ref))
            entry["turns"].append({"package": t, **row})
        report["k20a"][shape] = entry

    # the cut itself, as the sliding executor makes it: two torch.where
    cut, iota, lf0, rt0 = k20b_cut
    report["k20b_cut"] = call_profile(
        "the padded batch's cut to one-row windows",
        lambda: (torch.where(cut, iota, lf0), torch.where(cut, iota, rt0)), 50)

    line = json.dumps(report)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    wrong = [f"K3 {s} {r['package']}" for s, e in report["k3"].items() for r in e["turns"]
             if not r["matches_plain"]]
    wrong += [f"{k.upper()} {s} {r['package']}" for k in ("k19", "k20a", "k20b")
              for s, e in report[k].items() for r in e["turns"] if not r["matches_plain"]]
    wrong += [f"K3 variant {v} {s}" for v, rows in report.get("k3_variants", {}).items()
              for s, r in rows.items() if s != "ptxas" and not r["matches_plain"]]
    if wrong:
        print(f"window_profile: results differ from the plain version: {wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
