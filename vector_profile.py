#!/usr/bin/env python3
"""Profile the vector tier's kernels K21 and K22 of the PyTorch port on one NVIDIA GPU.

    python3 vector_profile.py [--package DIR] [--variants] [--seed N] [--out FILE]

It times K21 (fused cosine top-k) at the vector path's shape (10,000
queries x one 2^20-row batch x 100, k = 10, the corpus chip_smoke.py makes
from the seed) and at the approximate path's (4 queries x one 2^14-row
row group), and K22 (masked Gramian) at the gramian path's (2^20 rows x
lineitem's four float64 columns), through this checkout's quokka_tpu_torch
and, with ``--package``, through the quokka_tpu_torch of another checkout
(e.g. the parent commit unpacked with ``git archive``) in turns: package,
this, this, package.  Per kernel and package it reports the wrapper's time
with CUDA events, its kernels' device time and launch attributes from
torch.profiler's trace (grid, block, registers per thread, shared memory,
estimated achieved occupancy; search_profile.py's measure), for K21 the
prologue's share of the device time, and the yardstick timed the same way
(K21: chunked torch.topk(q @ v_unit.T); K22: one torch.mm(a.T, a)),
beside the bound.
It checks that this checkout's K21 output equals the other package's bit
for bit at both shapes and on every made case of chip_smoke.py's K21 phase
(256 queries over the corpus batch and over 2^20-row made batches of d = 1,
7 and 768, at k = 1, 10 and 100, each merged again into its own result;
50 rows at k = 100), and that K22 gives the same bits on two runs.  It also
compiles this checkout's csrc/vector.cu and csrc/linalg.cu with
``-Xptxas -v`` and keeps each kernel's registers, shared memory and spills.
With ``--variants`` it also builds K21 from copies of csrc/vector.cu
patched here (``K21_VARIANTS``: other tile constants, or parts of the work
dropped) and times each at the vector shape, against this checkout's
bits where the variant computes K21.

It prints the card's name and power limit, one line per measurement and
one JSON line, and writes the JSON to ``--out``.  It imports neither JAX
nor quokka_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
K21_PREFIXES = ("qk_sims_", "qk_topk_merge_kernel")
K22_PREFIXES = ("qk_gram_",)
# the work of a tile's fold dropped (the scores summed into a sink that the
# end keeps live), and the loads past the first ring of slices
_NO_FOLD = [
    ("  int buf = 0;\n", "  int buf = 0;\n  float sink = 0.0f;\n"),
    ("    // the tile's scores are complete: fold them into the lists\n",
     "#pragma unroll\n    for (int i = 0; i < 64; ++i) {\n      sink += acc[i / 8][i % 8];\n"
     "      acc[i / 8][i % 8] = 0.0f;\n    }\n    continue;\n"),
    ("  __syncthreads();\n  qk_fold_queues(lists, queue, thr, cnt, k, 1,",
     "  if (sink == 1.5e-30f) lists[0] = 1ull;\n  __syncthreads();\n"
     "  qk_fold_queues(lists, queue, thr, cnt, k, 1,")]
_NO_LOADS = [("    if (ld_st < steps) {\n",
              "    if (ld_st < steps && ld_st * nsl + ld_ks < QK_STAGES - 1) {\n")]
# K21 built from csrc/vector.cu with these (text, replacement) patches; a
# label that ends "(not K21)" drops work, so its output is not compared
K21_VARIANTS = {
    "one block an SM (no register cap)": [("#define QK_MIN_BLOCKS 2",
                                           "#define QK_MIN_BLOCKS 1")],
    "16-deep slices": [("#define QK_TD 8 ", "#define QK_TD 16 ")],
    "8 stages": [("#define QK_STAGES 4", "#define QK_STAGES 8")],
    "64-key queues": [("#define QK_QCAP 32", "#define QK_QCAP 64")],
    "a full queue folds every non-empty one": [("#define QK_FOLD_AT (QK_QCAP / 2)",
                                                "#define QK_FOLD_AT 1")],
    "no fold (not K21)": _NO_FOLD,
    "no fold, no loads past the first ring (not K21)": _NO_FOLD + _NO_LOADS,
}


def load_package(root: Path, sources=("vector", "linalg")):
    """quokka_tpu_torch from the checkout at root, with the CUDA sources
    ``sources`` built: its vector, linalg, hashtable, fuse, join, kernels,
    bridge and batch modules, its time-series executors and the package
    itself.  Each load drops the
    modules of an earlier one from sys.modules; the module objects already
    held keep working."""
    for name in [m for m in sys.modules if m == "quokka_tpu_torch"
                 or m.startswith("quokka_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        import quokka_tpu_torch
        from quokka_tpu_torch.executors import ts_execs
        from quokka_tpu_torch.ops import batch, bridge, fuse, hashtable, join, kernels, linalg
        from quokka_tpu_torch.ops import native, vector
    finally:
        sys.path.remove(str(root))
    native.build_all(list(sources))
    return SimpleNamespace(root=str(root), vops=vector, lops=linalg, ht=hashtable, ts=ts_execs,
                           fuse=fuse, join=join, kernels=kernels, bridge=bridge, batch=batch,
                           pkg=quokka_tpu_torch)


def parse_ptxas(log: str) -> dict:
    """{kernel: registers, static shared memory, stack, spills} from the
    output of nvcc -Xptxas -v."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            if shutil.which("c++filt"):
                entry = subprocess.run(["c++filt", entry], capture_output=True,
                                       text=True).stdout.strip() or entry
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out[entry].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    return out


def compile_sources(sources):
    """{label: (library, {kernel: registers, static shared memory, stack,
    spills})} of ``sources`` ({label: .cu path}), each built with -Xptxas -v
    into build/vector_profile/, all at once."""
    from quokka_tpu_torch.ops import native

    out_dir = ROOT / "build" / "vector_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {label: subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_dir / f"lib{label}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, src in sources.items()}
    built = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        built[label] = (out_dir / f"lib{label}.so", parse_ptxas(log))
        for k, v in built[label][1].items():
            print(f"ptxas ({label}): {k}: {v}", flush=True)
    return built


def variant_sources() -> dict:
    """{label: .cu path} of K21_VARIANTS, written into build/vector_profile/."""
    from quokka_tpu_torch.ops import native

    base = (native.CSRC_DIR / "vector.cu").read_text()
    out = {}
    for i, patches in enumerate(K21_VARIANTS.values()):
        src = base
        for a, b in patches:
            if src.count(a) != 1:
                raise RuntimeError(f"K21 variant {i}: {a!r} is not once in csrc/vector.cu")
            src = src.replace(a, b)
        path = ROOT / "build" / "vector_profile" / f"k21_variant_{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
        out[f"k21_variant_{i}"] = path
    return out


def bits_equal(a, b) -> bool:
    import torch

    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=None,
                    help="root of another checkout whose quokka_tpu_torch is timed in turns "
                         "with this one's and whose K21 output this one's must equal")
    ap.add_argument("--variants", action="store_true",
                    help="also time K21 built with each of K21_VARIANTS at the vector shape")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "vector_profile.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("vector_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"vector_profile: no quokka_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    other = Path(args.package).resolve() if args.package else None
    if other is not None and not (other / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"vector_profile: no quokka_tpu_torch package in {other}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sys.path.insert(0, str(ROOT))
    from quokka_tpu_torch.ops import native

    built = compile_sources({"vector": native.CSRC_DIR / "vector.cu",
                             "linalg": native.CSRC_DIR / "linalg.cu",
                             **(variant_sources() if args.variants else {})})
    report = {"card": card, "package": str(other) if other else None,
              "ptxas": {**built["vector"][1], **built["linalg"][1]}}
    import numpy as np

    import chip_smoke
    from search_profile import measure

    dev = torch.device("cuda", 0)
    this = load_package(ROOT)
    pkgs = {"this": this}
    if other is not None:
        pkgs["package"] = load_package(other)
    turns = ["package", "this", "this", "package"] if other is not None else ["this", "this"]

    # K21's inputs: the corpus's first 2^20-row batch and its queries, as
    # chip_smoke.py makes them; the approximate path's 4 queries over one
    # 2^14-row row group of the same vectors
    vd = chip_smoke.make_vectors(1.0, args.seed)
    v = torch.from_numpy(vd["vecs"][:1 << 20]).to(dev, torch.float64)
    valid = torch.ones(v.shape[0], dtype=torch.bool, device=dev)
    q = torch.from_numpy(chip_smoke._unit_f32(vd["queries"])).to(dev)
    k = chip_smoke.VEC_K
    shapes = {"vector": (q, v, valid), "ann": (q[:chip_smoke.ANN_QUERIES].contiguous(),
                                               v[:1 << 14].contiguous(), valid[:1 << 14])}
    report["k21"] = {}
    for label, (q_, v_, valid_) in shapes.items():
        nq, (n, d) = q_.shape[0], v_.shape
        st = pkgs["this"].vops.empty_state(nq, k, dev)
        a21 = (q_, v_, valid_, k, *st, 0)
        ops = 2 * nq * int(valid_.sum()) * d
        n_bytes = n * d * 8 + n + nq * d * 4 + 2 * nq * k * 12
        bound = max(ops / FP32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
        entry = {"shape": f"{nq} queries x {n} rows x {d}, k {k}", "bound_ms": bound,
                 "bound_by": "operations" if ops / FP32_FLOP_PER_S > n_bytes / HBM_BYTES_PER_S
                 else "bytes", "turns": []}
        iters, profiled = (3, 3) if label == "vector" else (50, 10)
        for t in turns:
            row = measure(f"K21 {label} ({t})", lambda t=t: pkgs[t].vops.sims_topk_cuda(*a21),
                          K21_PREFIXES, iters, profiled)
            stage = sum(u for name, u in row["device_us_by_kernel"].items()
                        if name.startswith("qk_sims_stage_kernel"))
            row["prologue_share"] = stage / row["device_us"] if row["device_us"] else None
            entry["turns"].append({"package": t, **row})
        if other is not None:
            entry["bits_equal_package"] = bits_equal(pkgs["this"].vops.sims_topk_cuda(*a21),
                                                     pkgs["package"].vops.sims_topk_cuda(*a21))
            print(f"K21 {label}: bit for bit the package's: {entry['bits_equal_package']}",
                  flush=True)
        v_unit = v_.to(torch.float32)
        v_unit = v_unit / torch.clamp(torch.linalg.vector_norm(v_unit, dim=1, keepdim=True),
                                      min=1e-12)

        def library(q_=q_, v_unit=v_unit):
            best = None
            for r0 in range(0, v_unit.shape[0], 1 << 16):
                top = torch.topk(q_ @ v_unit[r0:r0 + (1 << 16)].T, k, dim=1)
                best = top if best is None else torch.topk(
                    torch.cat([best.values, top.values], 1), k, dim=1)
            return best

        entry["library"] = measure(f"K21 {label} yardstick (chunked torch.topk(q @ v.T))",
                                   library, None, iters, profiled)
        del v_unit
        report["k21"][label] = entry

    # K21's variants at the vector shape, each against this checkout's bits
    if args.variants:
        a21 = (*shapes["vector"], k, *this.vops.empty_state(q.shape[0], k, dev), 0)
        want = this.vops.sims_topk_cuda(*a21)
        lib_of, report["k21_variants"] = this.vops._lib, {}
        prod = lib_of()
        for i, label in enumerate(K21_VARIANTS):
            lib_path, ptx = built[f"k21_variant_{i}"]
            lib = ctypes.CDLL(str(lib_path))
            for f in ("qk_sims_topk", "qk_sims_slots"):
                getattr(lib, f).argtypes = getattr(prod, f).argtypes
                getattr(lib, f).restype = getattr(prod, f).restype
            this.vops._lib = lambda lib=lib: lib
            this.vops._SLOTS.clear()
            row = measure(f"K21 vector, variant: {label}",
                          lambda: this.vops.sims_topk_cuda(*a21), K21_PREFIXES, 3, 3)
            row["bits_equal_this"] = (None if label.endswith("(not K21)")
                                      else bits_equal(this.vops.sims_topk_cuda(*a21), want))
            row["ptxas"] = ptx
            report["k21_variants"][label] = row
        this.vops._lib = lib_of
        this.vops._SLOTS.clear()

    # chip_smoke.py's made K21 cases: this checkout against the package
    if other is not None:
        g21 = torch.Generator(device=dev).manual_seed(args.seed + 21)
        q256 = q[:256].contiguous()

        def made_batch(d, n=1 << 20):
            x = torch.randn((n, d), generator=g21, device=dev, dtype=torch.float64)
            x[torch.rand(n, generator=g21, device=dev) < 0.01] = 0.0  # null rows
            x[7] = x[33]  # an exact tie
            x[20, 0] = float("nan")
            return x, torch.rand(n, generator=g21, device=dev) < 0.95

        def q_of(d, nq=256):
            x = torch.randn((nq, d), generator=g21, device=dev)
            return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)

        cases = {"corpus batch, d = 100": (q256, v, valid)}
        for d in (1, 7, 768):
            cases[f"made batch, d = {d}"] = (q_of(d), *made_batch(d))
        made = {}
        for label, (q_, v_, valid_) in cases.items():
            for kk in (1, 10, 100):
                st = this.vops.empty_state(q_.shape[0], kk, dev)
                a = this.vops.sims_topk_cuda(q_, v_, valid_, kk, *st, 0)
                ok = bits_equal(a, pkgs["package"].vops.sims_topk_cuda(q_, v_, valid_, kk, *st, 0))
                ok = ok and bits_equal(this.vops.sims_topk_cuda(q_, v_, valid_, kk, *a, 1),
                                       pkgs["package"].vops.sims_topk_cuda(q_, v_, valid_, kk,
                                                                           *a, 1))
                made[f"{label}, k = {kk} (and merged again)"] = ok
            del v_
        del cases
        q9, (v50, valid50) = q_of(9), made_batch(9, 50)
        st = this.vops.empty_state(256, 100, dev)
        made["50 rows, k = 100"] = bits_equal(
            this.vops.sims_topk_cuda(q9, v50, valid50, 100, *st, 0),
            pkgs["package"].vops.sims_topk_cuda(q9, v50, valid50, 100, *st, 0))
        report["k21_made_cases_bits_equal_package"] = made
        print(f"K21 made cases, bit for bit the package's: {made}", flush=True)
    del v, shapes

    # K22 at the gramian path's shape: lineitem's four float64 columns
    tables = chip_smoke.make_tpch(0.2, args.seed)  # 1.2M lineitem rows
    li = tables["lineitem"].cols
    n22 = 1 << 20
    cols = [torch.from_numpy(np.ascontiguousarray(li[c][:n22])).to(dev)
            for c in chip_smoke.LINALG_COLS]
    valid22 = torch.ones(n22, dtype=torch.bool, device=dev)
    n_bytes = sum(c.numel() * c.element_size() for c in cols) + n22 + 8 * (4 * 5 // 2 + 4)
    report["k22"] = {"shape": f"{n22} rows x {len(cols)} float64 columns",
                     "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                     "turns": []}
    for t in turns:
        fn = lambda t=t: pkgs[t].lops.gramian_cuda(cols, valid22)  # noqa: E731
        row = measure(f"K22 gramian ({t})", fn, K22_PREFIXES, 200, 20)
        first = [x.clone() for x in fn()]
        row["same_bits_twice"] = all(torch.equal(a.view(torch.int64), b.view(torch.int64))
                                     for a, b in zip(first, fn()))
        report["k22"]["turns"].append({"package": t, **row})
    a22 = torch.cat([this.lops._masked_f32(cols, valid22).to(torch.float64),
                     valid22[:, None].to(torch.float64)], 1)
    report["k22"]["library"] = measure("K22 yardstick (torch.mm(a.T, a))",
                                       lambda: torch.mm(a22.T, a22), None, 200, 20)
    report["k22"]["max_rel_err_plain"] = float(
        ((this.lops.gramian_cuda(cols, valid22)[0] - this.lops.gramian_plain(cols, valid22)[0])
         .abs() / this.lops.gramian_plain(cols, valid22)[0].abs()).max())

    line = json.dumps(report)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    failed = [lbl for lbl, e in report["k21"].items() if e.get("bits_equal_package") is False]
    failed += [c for c, ok in report.get("k21_made_cases_bits_equal_package", {}).items()
               if not ok]
    failed += [t["package"] for t in report["k22"]["turns"] if not t["same_bits_twice"]]
    failed += [lbl for lbl, r in report.get("k21_variants", {}).items()
               if r["bits_equal_this"] is False]
    if failed:
        print(f"vector_profile: not bit for bit: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
