#!/usr/bin/env python3
"""Profile K10 (the dense rank's pass over the sorted order) and K13p (the
many-to-many plan) of the PyTorch port on one NVIDIA GPU.

    python3 rank_profile.py [--seed N] [--out FILE]

It runs TPC-H Q4, Q13 and Q21 at SF1 (chip_smoke.py's data and queries)
through this checkout's quokka_tpu_torch and keeps each path's largest
plan: Q4's semi join (2^21 + 2^16 rows, one int64 limb), Q13's left join
(2^20 + 2^18 rows) and Q21's largest anti join (two int64 limbs).  At each
it checks K10 and K13p bit for bit against their plain versions and times,
with CUDA events and the profiler's device events (every device operation
of the call):

- ``kernels.dense_rank`` and ``join._mm_plan`` / ``join._mm_counts`` whole,
  the sort's device operations apart from the rest (the rank pass, the
  fill, the memset), beside their plain versions, their bounds (the bytes
  the function must move over 3.35 TB/s) and a stable ``torch.sort`` of the
  first limb (a yardstick: not the same function);
- K10's pass alone, on the sort's permutation, as built (one launch whose
  tiles carry their counts by a decoupled look-back, after a memset) and as
  a two-pass variant appended to a copy of csrc/rank.cu here (K17's way: a
  count pass leaves each tile's run starts and its threads' flags, then a
  place pass sums the earlier tiles' counts; no block waits on another),
  both bit for bit against the plain ranks.

It compiles csrc/rank.cu with ``-Xptxas -v`` to keep each kernel's
registers, shared memory and spills, prints the card's name and power
limit, one line per measurement and one JSON line, and writes the JSON to
``--out``.  It imports neither JAX nor quokka_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12

# appended to a copy of csrc/rank.cu: K10's pass in two launches with no
# look-back (rank mode)
TWO_PASS = r"""
__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_rank2_count_kernel(QkRankArgs a, uint32_t* flags, uint32_t* tiles) {
  __shared__ uint32_t warp[QK_CT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long k = blockIdx.x;
  long long pr[QK_CT_ITEMS];
  uint32_t starts, builds;
  qk_rk_flags(a, k, pr, &starts, &builds);
  flags[k * QK_CT_THREADS + tid] = starts;
  uint32_t c = __popc(starts);
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
  if (lane == 0) warp[w] = c;
  __syncthreads();
  if (tid == 0) {
    uint32_t t = 0;
#pragma unroll
    for (int u = 0; u < QK_CT_WARPS; ++u) t += warp[u];
    tiles[k] = t;
  }
}

__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_rank2_place_kernel(QkRankArgs a, const uint32_t* flags, const uint32_t* tiles) {
  __shared__ uint32_t warp[QK_CT_WARPS];
  __shared__ uint32_t before;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long k = blockIdx.x;
  const long long nt = (a.n + QK_CT_TILE - 1) / QK_CT_TILE;
  if (w == 0) {
    uint32_t t = 0;
    for (long long j = lane; j < k; j += 32) t += tiles[j];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) t += __shfl_xor_sync(0xffffffffu, t, d);
    if (lane == 0) before = t;
  }
  const long long i0 = k * QK_CT_TILE + (long long)tid * QK_CT_ITEMS;
  const long long left = a.n - i0;
  const int cnt = left <= 0 ? 0 : (left < QK_CT_ITEMS ? (int)left : QK_CT_ITEMS);
  long long pr[QK_CT_ITEMS];
  if (cnt == QK_CT_ITEMS && (((uintptr_t)(a.perm + i0)) & 15u) == 0) {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; q += 2) {
      const longlong2 v = __ldcs((const longlong2*)(a.perm + i0 + q));
      pr[q] = v.x;
      pr[q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) pr[q] = q < cnt ? a.perm[i0 + q] : 0;
  }
  const uint32_t starts = flags[k * QK_CT_THREADS + tid];
  const uint32_t c = __popc(starts);
  uint32_t inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp[w] = inc;
  __syncthreads();
  uint32_t r1 = before + inc - c, all = before;
#pragma unroll
  for (int u = 0; u < QK_CT_WARPS; ++u) {
    r1 += u < w ? warp[u] : 0u;
    all += warp[u];
  }
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if (q < cnt) {
      r1 += (starts >> q) & 1u;
      a.ranks[pr[q]] = r1 > 0 ? (long long)r1 - 1 : 0;
    }
  }
  if (k == nt - 1 && tid == 0) *a.num = (int)all;
}

extern "C" {

long long qk_rank2_scratch(long long n) {
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE;
  return (nt * QK_CT_THREADS + nt + 1) / 2 + 1;
}

int qk_rank2(const void* perm, const void* valid, const void* const* limbs, const int* dts,
             int n_limbs, long long n, void* ranks, void* num, void* scratch, void* stream) {
  if (n_limbs < 0 || n_limbs > QK_MAX_LIMBS || n < 1 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  QkRankArgs a = {};
  a.perm = (const long long*)perm;
  a.valid = (const uint8_t*)valid;
  a.n = n;
  a.ranks = (long long*)ranks;
  a.num = (int*)num;
  a.mode = QK_RK_RANK;
  a.limbs.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    a.limbs.p[j] = limbs[j];
    a.limbs.dt[j] = dts[j];
  }
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE;
  uint32_t* flags = (uint32_t*)scratch;
  uint32_t* tiles = flags + nt * QK_CT_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  qk_rank2_count_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(a, flags, tiles);
  qk_rank2_place_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(a, flags, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
"""


def fail(msg: str) -> None:
    print(f"rank_profile: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def build_two_pass(native) -> ctypes.CDLL:
    """csrc/rank.cu with TWO_PASS appended, built as the package builds it."""
    out_dir = ROOT / "build" / "rank_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "rank_two_pass.cu"
    src.write_text((native.CSRC_DIR / "rank.cu").read_text() + TWO_PASS)
    lib = out_dir / "librank_two_pass.so"
    r = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC_DIR), "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    if r.returncode:
        fail(f"nvcc of the two-pass variant: {r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.qk_rank2_scratch.argtypes = [L]
    dll.qk_rank2_scratch.restype = L
    dll.qk_rank2.argtypes = [P, P, ctypes.POINTER(P), ctypes.POINTER(I), I, L, P, P, P, P]
    dll.qk_rank2.restype = I
    return dll


def ptxas(native) -> str:
    r = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                        str(ROOT / "build" / "rank_profile" / "librank_v.so"),
                        str(native.CSRC_DIR / "rank.cu")], capture_output=True, text=True)
    return "\n".join(l for l in (r.stdout + r.stderr).splitlines()
                     if "registers" in l or "spill" in l or "Compiling entry" in l)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "rank_profile.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rank_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from quokka_tpu_torch import QuokkaContext
    from quokka_tpu_torch.ops import join, kernels, native

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}")
    native.build_all(["rank"])
    (ROOT / "build" / "rank_profile").mkdir(parents=True, exist_ok=True)
    report = {"card": card, "ptxas": ptxas(native)}
    print(report["ptxas"])
    two = build_two_pass(native)
    dev = torch.device("cuda", 0)
    tables = cs.make_tpch(1.0, args.seed)
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    plans = {}
    for q, attr in (("q4", "_mm_counts"), ("q13", "_mm_plan"), ("q21", "_mm_counts")):
        with cs.Capture({q: (join, attr, lambda l, v, p: v.shape[0])}) as cap:
            cs.collect_numpy(cs.tpch_stream(q, ctx, tables), q)
        plans[q] = (cap.args[q][0], attr == "_mm_plan")
    rows = {}
    for q, ((limbs, valid, p), with_bps) in plans.items():
        n = valid.shape[0]
        row = rows[q] = {"rows": n, "probe": p, "limbs": [str(l.dtype) for l in limbs]}
        want = kernels.dense_rank_plain(limbs, valid)
        for got in (kernels.dense_rank(limbs, valid),):
            if not all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want)):
                fail(f"{q}: K10 differs from the plain version")
        pw = join._mm_plan_plain(limbs, valid, p)
        pg = join._mm_plan(limbs, valid, p)
        if not all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(pg, pw)):
            fail(f"{q}: K13p differs from the plain version")
        if not torch.equal(join._mm_counts(limbs, valid, p), pw[0]):
            fail(f"{q}: K13p's counts differ from the plain version")

        def split(fn):
            per, _ = cs.kernel_us(fn, expect=("qk_rank_kernel",))
            ours = sum(t for k, t in per.items()
                       if k.startswith(("qk_rank_kernel", "qk_mm_fill_kernel")))
            memset = sum(t for k, t in per.items() if k.startswith("Memset"))
            return {"device_us": sum(per.values()), "rank_pass_fill_us": ours,
                    "memset_us": memset, "sort_us": sum(per.values()) - ours - memset,
                    "by_operation": {k[:160]: t for k, t in per.items()}}

        rank_bytes = cs.nbytes(*limbs, valid) + 8 * n + 4
        plan_bytes = cs.nbytes(*limbs, valid) + 8 * ((p + 1 + 2 * n) if with_bps else p)
        plan_fn = ((lambda: join._mm_plan(limbs, valid, p)) if with_bps
                   else (lambda: join._mm_counts(limbs, valid, p)))
        plain_fn = ((lambda: join._mm_plan_plain(limbs, valid, p)) if with_bps
                    else (lambda: join._mm_counts_plain(limbs, valid, p)))
        row["K10"] = {"ms": cs.cuda_ms(lambda: kernels.dense_rank(limbs, valid)),
                      "plain_ms": cs.cuda_ms(lambda: kernels.dense_rank_plain(limbs, valid),
                                             iters=5),
                      "bound_ms": rank_bytes / HBM_BYTES_PER_S * 1e3,
                      **split(lambda: kernels.dense_rank(limbs, valid))}
        row["K13p"] = {"mode": "with build positions" if with_bps else "counts only",
                       "ms": cs.cuda_ms(plan_fn), "plain_ms": cs.cuda_ms(plain_fn, iters=5),
                       "bound_ms": plan_bytes / HBM_BYTES_PER_S * 1e3, **split(plan_fn)}
        row["sort_yardstick_ms"] = cs.cuda_ms(lambda: torch.sort(limbs[0], stable=True))
        # K10's pass alone on the sort's permutation: as built, and in two passes
        perm, v8, cols, dts, scratch = kernels.rank_pass_args("rank_profile", limbs, valid)
        lib = kernels._rank_lib()
        ranks = torch.empty(n, dtype=torch.int64, device=dev)
        num = torch.empty((), dtype=torch.int32, device=dev)
        scratch2 = torch.empty(two.qk_rank2_scratch(n), dtype=torch.int64, device=dev)
        ptrs, dta = native.ptr_array([c.data_ptr() for c in cols]), native.int_array(dts)
        stream = native.stream_ptr(dev)

        def built():
            native.check(lib.qk_rank(perm.data_ptr(), v8.data_ptr(), ptrs, dta, len(cols), n,
                                     ranks.data_ptr(), num.data_ptr(), scratch.data_ptr(),
                                     stream), "qk_rank")

        def two_pass():
            native.check(two.qk_rank2(perm.data_ptr(), v8.data_ptr(), ptrs, dta, len(cols), n,
                                      ranks.data_ptr(), num.data_ptr(), scratch2.data_ptr(),
                                      stream), "qk_rank2")

        for label, fn in (("look-back, one launch (built)", built),
                          ("two passes, sums of the earlier tiles", two_pass)):
            ranks.fill_(-1)
            fn()
            if not (torch.equal(ranks, want[0]) and int(num) == int(want[1])):
                fail(f"{q}: K10's pass ({label}) differs from the plain version")
        passes = {}
        for turn, (label, fn) in enumerate((("built", built), ("two_pass", two_pass),
                                            ("two_pass", two_pass), ("built", built))):
            per, _ = cs.kernel_us(fn)
            passes.setdefault(label, []).append(
                {"device_us": sum(per.values()), "ms": cs.cuda_ms(fn),
                 "by_operation": {k[:160]: t for k, t in per.items()}})
        row["K10_pass_alone"] = passes
        print(f"{q}: {n} rows ({p} probe), limbs {row['limbs']}")
        for k in ("K10", "K13p"):
            v = row[k]
            print(f"  {k}{' (' + v['mode'] + ')' if 'mode' in v else ''}: {v['ms']:.4f} ms, "
                  f"{v['device_us']:.1f} device us (sort {v['sort_us']:.1f}, memsets "
                  f"{v['memset_us']:.1f}, rank pass and fill {v['rank_pass_fill_us']:.1f}), bound "
                  f"{v['bound_ms']:.5f} "
                  f"ms, plain {v['plain_ms']:.4f} ms")
        print("  stable torch.sort of the first limb (yardstick): "
              f"{row['sort_yardstick_ms']:.4f} ms")
        for label, turns in passes.items():
            print(f"  K10's pass alone, {label}: device us "
                  f"{[round(t['device_us'], 1) for t in turns]}, ms "
                  f"{[round(t['ms'], 4) for t in turns]}")
    report["plans"] = rows
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"rank_profile": {q: {k: r[k]["device_us"] for k in ("K10", "K13p")}
                                       for q, r in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
