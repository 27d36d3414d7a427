#!/usr/bin/env python3
"""Profile K10 (the dense rank) and K13p (the many-to-many plan) of the
PyTorch port on one NVIDIA GPU, and the radix sort under both.

    python3 rank_profile.py [--seed N] [--out FILE]

It runs TPC-H Q4, Q13 and Q21 at SF1 (chip_smoke.py's data and queries)
through this checkout's quokka_tpu_torch and keeps each path's largest
plan: Q4's semi join (2^21 + 2^16 rows, one int64 limb), Q13's left join
(2^20 + 2^18 rows) and Q21's largest anti join (two int64 limbs).  At each
it checks K10, K13p and the sort bit for bit against their plain versions
and times, with CUDA events and the profiler's device events (every device
operation of the call):

- ``kernels.dense_rank`` and ``join._mm_plan`` / ``join._mm_counts`` whole
  and by part (the range and pack passes, the digit passes, the rank pass,
  the fill, the memset), beside their plain versions, their bounds (the
  bytes the function must move over 3.35 TB/s) and one stable
  ``torch.sort`` of the valid rows' packed key (a yardstick: not the same
  function);
- the sort alone (``kernels.sort_perm``) as built, whose digit passes carry
  each bucket's count across tiles by a decoupled look-back, against a
  variant appended to a copy of csrc/rank.cu here (K17's way: each digit
  in a count pass that leaves each tile's and each group of tiles' bucket
  counts and a place pass that sums the earlier groups' and tiles'; no
  block waits on another), in turns (built, variant, variant, built), and
  against the stable torch sorts it replaced (``kernels._sort_perm``).

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

# appended to a copy of csrc/rank.cu: the digit passes as a count and a
# place pass each, with no look-back
COUNT_PLACE = r"""
__device__ __forceinline__ long long qk_sr2_group(long long ntl) {
  long long g = 16;
  while (g * g < ntl) ++g;
  return g;
}

__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_sort_count_kernel(QkSort s, int d, unsigned int* tcnt, unsigned int* gsum) {
  __shared__ uint32_t h[QK_SR_BUCKETS];
  const QkSortPlan* P = s.plan;
  if (!P->live[d]) return;
  const int tid = threadIdx.x;
  const long long nv = P->n_valid, ntl = (nv + QK_CT_TILE - 1) / QK_CT_TILE;
  const long long k = blockIdx.x;
  if (k >= ntl) return;
  h[tid] = 0;
  __syncthreads();
  const QkDigitTile t = qk_sr_tile(s, d, P->src[d], nv, k);
  // one shared atomic a warp and digit (peers by qk_sr_match)
  for (int i0 = 0; i0 < t.tcnt; i0 += QK_CT_THREADS) {
    const int i = i0 + tid;
    const uint32_t dig = i < t.tcnt ? (uint32_t)(t.kd[i] >> t.shift) & 0xffu : QK_SR_BUCKETS;
    const uint32_t peers = qk_sr_match(dig);
    if (dig < QK_SR_BUCKETS && __ffs(peers) - 1 == (tid & 31)) atomicAdd(&h[dig], __popc(peers));
  }
  __syncthreads();
  const uint32_t c = h[tid];
  tcnt[(size_t)k * QK_SR_BUCKETS + tid] = c;
  if (c != 0u) atomicAdd(gsum + (size_t)(k / qk_sr2_group(ntl)) * QK_SR_BUCKETS + tid, c);
}

__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_sort_place_kernel(QkSort s, int d, const unsigned int* tcnt, const unsigned int* gsum) {
  __shared__ QkDigitShared sh;
  const QkSortPlan* P = s.plan;
  if (!P->live[d]) return;
  const int tid = threadIdx.x;
  const long long nv = P->n_valid, ntl = (nv + QK_CT_TILE - 1) / QK_CT_TILE;
  const long long k = blockIdx.x;
  if (k >= ntl) return;
  const long long G = qk_sr2_group(ntl), g = k / G;
  uint32_t before = s.hist[(size_t)d * QK_SR_BUCKETS + tid];
  for (long long j = 0; j < g; ++j) before += gsum[(size_t)j * QK_SR_BUCKETS + tid];
  for (long long j = g * G; j < k; ++j) before += tcnt[(size_t)j * QK_SR_BUCKETS + tid];
  sh.gbase[tid] = before;
  const int src = P->src[d];
  const QkDigitTile t = qk_sr_tile(s, d, src, nv, k);
  uint32_t pos[QK_CT_ITEMS], dg[QK_CT_ITEMS];
  qk_sr_rank_tile(sh, t, pos, dg);
  qk_sr_scatter_tile(sh, s, src, P->words, t, pos, dg);
}

extern "C" {

static long long qk_sort2_groups(long long nt) { return nt / 16 + 2; }

long long qk_sort2_scratch(long long n, const int* dts, int n_limbs) {
  const int w = qk_sr_max_words(dts, n_limbs);
  const long long nt = qk_sr_tiles(n);
  return qk_sr_scratch(n, w) + (nt * QK_SR_BUCKETS + 1) / 2
         + (8LL * w * qk_sort2_groups(nt) * QK_SR_BUCKETS + 1) / 2;
}

int qk_sort2_perm(const void* valid, const void* const* limbs, const int* dts, int n_limbs,
                  long long n, void* perm, void* scratch, void* stream) {
  QkSort s = {};
  int err = qk_sr_layout(s, valid, limbs, dts, n_limbs, n, scratch);
  if (err != 0) return err;
  const long long nt = qk_sr_tiles(n), ng = qk_sort2_groups(nt);
  unsigned int* tcnt =
      (unsigned int*)((unsigned long long*)scratch + qk_sr_scratch(n, s.max_words));
  unsigned int* gsum = tcnt + nt * QK_SR_BUCKETS + 1;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(gsum, 0, 4 * (size_t)(8LL * s.max_words * ng * QK_SR_BUCKETS), st);
  if (e != cudaSuccess) return (int)e;
  err = qk_sort_prepare(s, st);
  if (err != 0) return err;
  for (int d = 0; d < 8 * s.max_words; ++d) {
    unsigned int* gd = gsum + (size_t)d * ng * QK_SR_BUCKETS;
    qk_sort_count_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(s, d, tcnt, gd);
    qk_sort_place_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(s, d, tcnt, gd);
  }
  qk_sort_perm_kernel<<<(unsigned int)((n + 255) / 256), 256, 0, st>>>(s, (long long*)perm);
  return (int)cudaGetLastError();
}

}  // extern "C"

// the digit pass cut short, to see where its time goes: MODE 1 loads the
// tile's digits, 2 also ranks them, 3 also looks back, 4 also scatters
// (the built pass)
template <int MODE>
__global__ void __launch_bounds__(QK_CT_THREADS) qk_probe_kernel(QkSort s, int d,
                                                                 unsigned int* sink) {
  __shared__ QkDigitShared sh;
  const QkSortPlan* P = s.plan;
  if (!P->live[d]) return;
  const int tid = threadIdx.x;
  const long long nv = P->n_valid;
  const long long ntl = (nv + QK_CT_TILE - 1) / QK_CT_TILE;
  const int src = P->src[d], words = P->words;
  const unsigned long long ep = (unsigned long long)(d + 1) << 34;
  for (;;) {
    if (tid == 0) sh.ticket = atomicAdd(s.tickets + 3 + d, 1u);
    sh.gbase[tid] = s.hist[(size_t)d * QK_SR_BUCKETS + tid];
    __syncthreads();
    const long long k = sh.ticket;
    if (k >= ntl) return;
    const QkDigitTile t = qk_sr_tile(s, d, src, nv, k);
    uint32_t pos[QK_CT_ITEMS], dg[QK_CT_ITEMS];
    if (MODE == 1) {
      const int w = tid >> 5, lane = tid & 31;
      uint32_t x = 0;
#pragma unroll
      for (int q = 0; q < QK_CT_ITEMS; ++q) {
        const int idx = w * (32 * QK_CT_ITEMS) + q * 32 + lane;
        x += idx < t.tcnt ? (uint32_t)(t.kd[idx] >> t.shift) & 0xffu : 0u;
      }
      if (x == 0xffffffffu) sink[0] = x;
      __syncthreads();
      continue;
    }
    const uint32_t run = qk_sr_rank_tile(sh, t, pos, dg);
    uint32_t acc = 0;
    if (MODE >= 3) {
      unsigned long long* st = s.sstat + (size_t)k * QK_SR_BUCKETS + tid;
      qk_sr_store(st, run | ((k == 0 ? 2ull : 1ull) << 32) | ep);
      if (k > 0) {
        const unsigned long long ready = ep | (2ull << 32);
        bool stop = false;
        for (long long j0 = k - 1; !stop; j0 -= QK_SR_LOOK) {
          unsigned long long v[QK_SR_LOOK];
#pragma unroll
          for (int i = 0; i < QK_SR_LOOK; ++i)
            v[i] = j0 - i >= 0 ? qk_sr_load(s.sstat + (size_t)(j0 - i) * QK_SR_BUCKETS + tid)
                               : ready;
#pragma unroll
          for (int i = 0; i < QK_SR_LOOK; ++i) {
            if (stop) break;
            while ((v[i] >> 34) != (unsigned long long)(d + 1) || ((v[i] >> 32) & 3ull) == 0ull)
              v[i] = qk_sr_load(s.sstat + (size_t)(j0 - i) * QK_SR_BUCKETS + tid);
            acc += (uint32_t)v[i];
            stop = ((v[i] >> 32) & 3ull) == 2ull;
          }
        }
        qk_sr_store(st, (acc + run) | (2ull << 32) | ep);
      }
    }
    if (MODE == 4) {
      sh.gbase[tid] += acc;
      qk_sr_scatter_tile(sh, s, src, words, t, pos, dg);
    } else {
      if (run == 0xffffffffu) sink[1] = acc;
      __syncthreads();
    }
  }
}

extern "C" int qk_probe(const void* valid, const void* const* limbs, const int* dts,
                        int n_limbs, long long n, int mode, void* sink, void* scratch,
                        void* stream) {
  QkSort s = {};
  int err = qk_sr_layout(s, valid, limbs, dts, n_limbs, n, scratch);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  err = qk_sort_prepare(s, st);
  if (err != 0) return err;
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_probe_kernel<4>, QK_CT_THREADS, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nt = qk_sr_tiles(n);
  const unsigned int grid = (unsigned int)(nt < per_sm * sms ? nt : per_sm * sms);
  unsigned int* k = (unsigned int*)sink;
  for (int d = 0; d < 8 * s.max_words; ++d) {
    if (mode == 1) qk_probe_kernel<1><<<grid, QK_CT_THREADS, 0, st>>>(s, d, k);
    else if (mode == 2) qk_probe_kernel<2><<<grid, QK_CT_THREADS, 0, st>>>(s, d, k);
    else if (mode == 3) qk_probe_kernel<3><<<grid, QK_CT_THREADS, 0, st>>>(s, d, k);
    else qk_probe_kernel<4><<<grid, QK_CT_THREADS, 0, st>>>(s, d, k);
  }
  return (int)cudaGetLastError();
}
"""

PARTS = {"range_pack": ("qk_sort_range_kernel", "qk_sort_pack_kernel"),
         "digits": ("qk_sort_digit_kernel", "qk_sort_count_kernel", "qk_sort_place_kernel"),
         "pass": ("qk_rank_kernel",), "fill": ("qk_mm_fill_kernel",),
         "perm": ("qk_sort_perm_kernel",)}


def fail(msg: str) -> None:
    print(f"rank_profile: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def build_variant(native) -> ctypes.CDLL:
    """csrc/rank.cu with COUNT_PLACE appended, built as the package builds it."""
    out_dir = ROOT / "build" / "rank_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "rank_count_place.cu"
    src.write_text((native.CSRC_DIR / "rank.cu").read_text() + COUNT_PLACE)
    lib = out_dir / "librank_count_place.so"
    r = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC_DIR), "-o",
                        str(lib), str(src)], capture_output=True, text=True)
    if r.returncode:
        fail(f"nvcc of the count-and-place variant: {r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.qk_sort2_scratch.argtypes = [L, ctypes.POINTER(I), I]
    dll.qk_sort2_scratch.restype = L
    dll.qk_sort2_perm.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(I), I, L, P, P, P]
    dll.qk_sort2_perm.restype = I
    dll.qk_probe.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(I), I, L, I, P, P, P]
    dll.qk_probe.restype = I
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
    variant = build_variant(native)
    dev = torch.device("cuda", 0)
    tables = cs.make_tpch(1.0, args.seed)
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    plans = {}
    for q, attr in (("q4", "_mm_counts"), ("q13", "_mm_plan"), ("q21", "_mm_counts")):
        with cs.Capture({q: (join, attr, lambda l, v, p: v.shape[0])}) as cap:
            cs.collect_numpy(cs.tpch_stream(q, ctx, tables), q)
        plans[q] = (cap.args[q][0], attr == "_mm_plan")

    def same(got, want):
        return all(torch.equal(a.reshape(-1), b.reshape(-1)) for a, b in zip(got, want))

    def split(fn):
        """Device us a call, whole and by part ("other": the memsets)."""
        per = {}
        for _ in range(3):
            got, _ = cs.kernel_us(fn, expect=("qk_sort_pack_kernel",))
            if sum(got.values()) > sum(per.values()):
                per = got
            if any(k.startswith(PARTS["digits"]) for k in got):
                break
        out = {part: sum(t for k, t in per.items() if k.startswith(names))
               for part, names in PARTS.items()}
        out["other"] = sum(per.values()) - sum(out.values())
        return {"device_us": sum(per.values()), "by_part": out,
                "by_operation": {k[:160]: t for k, t in per.items()}}

    rows = {}
    for q, ((limbs, valid, p), with_bps) in plans.items():
        n = valid.shape[0]
        nv = int(valid.sum())
        _, words, bits = kernels.pack_keys_plain(limbs, valid)
        row = rows[q] = {"rows": n, "valid": nv, "probe": p, "key_bits": bits,
                         "key_words": len(words), "limbs": [str(l.dtype) for l in limbs]}
        if not same(kernels.dense_rank(limbs, valid), kernels.dense_rank_plain(limbs, valid)):
            fail(f"{q}: K10 differs from the plain version")
        pw = join._mm_plan_plain(limbs, valid, p)
        if not same(join._mm_plan(limbs, valid, p), pw):
            fail(f"{q}: K13p differs from the plain version")
        if not torch.equal(join._mm_counts(limbs, valid, p), pw[0]):
            fail(f"{q}: K13p's counts differ from the plain version")
        want_perm = kernels.sort_perm_plain(limbs, valid)
        if not torch.equal(kernels.sort_perm(limbs, valid), want_perm):
            fail(f"{q}: the radix sort differs from the plain version")

        rank_bytes = cs.nbytes(*limbs, valid) + 8 * n + 4
        plan_bytes = cs.nbytes(*limbs, valid) + 8 * ((p + 1 + 2 * n) if with_bps else p)
        plan_fn = ((lambda: join._mm_plan(limbs, valid, p)) if with_bps
                   else (lambda: join._mm_counts(limbs, valid, p)))
        plain_fn = ((lambda: join._mm_plan_plain(limbs, valid, p)) if with_bps
                    else (lambda: join._mm_counts_plain(limbs, valid, p)))
        key = words[0] if words else torch.zeros(nv, dtype=torch.int64, device=dev)
        row["yardstick_ms"] = cs.cuda_ms(lambda: torch.sort(key, stable=True))
        row["K10"] = {"ms": cs.cuda_ms(lambda: kernels.dense_rank(limbs, valid)),
                      "plain_ms": cs.cuda_ms(lambda: kernels.dense_rank_plain(limbs, valid),
                                             iters=5),
                      "bound_ms": rank_bytes / HBM_BYTES_PER_S * 1e3,
                      **split(lambda: kernels.dense_rank(limbs, valid))}
        row["K13p"] = {"mode": "with build positions" if with_bps else "counts only",
                       "ms": cs.cuda_ms(plan_fn), "plain_ms": cs.cuda_ms(plain_fn, iters=5),
                       "bound_ms": plan_bytes / HBM_BYTES_PER_S * 1e3, **split(plan_fn)}

        # the sort alone: as built, the count-and-place variant, the torch sorts
        v8, cols, dts, ptrs, _ = kernels.rank_pass_args("rank_profile", limbs, valid)
        perm = torch.empty(n, dtype=torch.int64, device=dev)
        scratch2 = torch.empty(variant.qk_sort2_scratch(n, dts, len(cols)), dtype=torch.int64,
                               device=dev)
        stream = native.stream_ptr(dev)

        def built():
            return kernels.sort_perm(limbs, valid)

        def count_place():
            native.check(variant.qk_sort2_perm(v8.data_ptr(), ptrs, dts, len(cols), n,
                                               perm.data_ptr(), scratch2.data_ptr(), stream),
                         "qk_sort2_perm")
            return perm

        perm.fill_(-1)
        if not torch.equal(count_place(), want_perm):
            fail(f"{q}: the count-and-place variant differs from the plain version")
        sorts = {}
        for label, fn in (("built", built), ("count_place", count_place),
                          ("count_place", count_place), ("built", built)):
            sorts.setdefault(label, []).append({"ms": cs.cuda_ms(fn), **split(fn)})
        torch_sorts = lambda: kernels._sort_perm(limbs, valid)
        per, _ = cs.kernel_us(torch_sorts)
        sorts["torch_sorts"] = [{"ms": cs.cuda_ms(torch_sorts), "device_us": sum(per.values()),
                                 "by_operation": {k[:160]: t for k, t in per.items()}}]
        row["sort_alone"] = sorts
        # the digit pass cut short (see qk_probe_kernel), and each launch of
        # the built pass
        sink = torch.zeros(2, dtype=torch.int32, device=dev)
        scratch3 = torch.empty(kernels._rank_lib().qk_rank_scratch(n, dts, len(cols)),
                               dtype=torch.int64, device=dev)
        probes = {}
        for mode, label in ((1, "load digits"), (2, "and rank"), (3, "and look back"),
                            (4, "and scatter (built)")):
            fn = lambda: native.check(variant.qk_probe(
                v8.data_ptr(), ptrs, dts, len(cols), n, mode, sink.data_ptr(),
                scratch3.data_ptr(), stream), "qk_probe")
            per, _ = cs.kernel_us(fn, expect=("qk_probe_kernel",))
            probes[label] = sum(t for k, t in per.items() if k.startswith("void qk_probe")
                                or k.startswith("qk_probe"))
        row["digit_pass_probes_us"] = probes
        from torch.profiler import ProfilerActivity, profile
        built()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            built()
            torch.cuda.synchronize()
        row["digit_launches_us"] = [
            round(e.time_range.elapsed_us(), 2) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name.startswith("qk_sort_digit_kernel")]
        print(f"{q}: {n} rows ({nv} valid, {p} probe), limbs {row['limbs']}, "
              f"{bits} key bits in {len(words)} words")
        for k in ("K10", "K13p"):
            v = row[k]
            parts = ", ".join(f"{pt} {us:.1f}" for pt, us in v["by_part"].items() if us)
            print(f"  {k}{' (' + v['mode'] + ')' if 'mode' in v else ''}: {v['ms']:.4f} ms, "
                  f"{v['device_us']:.1f} device us ({parts}), bound {v['bound_ms']:.5f} ms, "
                  f"plain {v['plain_ms']:.4f} ms")
        print(f"  stable torch.sort of the packed key (yardstick): {row['yardstick_ms']:.4f} ms")
        print(f"  digit passes cut short (device us a call): {row['digit_pass_probes_us']}")
        print(f"  each digit launch of the built sort (us): {row['digit_launches_us']}")
        for label, turns in sorts.items():
            print(f"  the sort alone, {label}: device us "
                  f"{[round(t['device_us'], 1) for t in turns]}, ms "
                  f"{[round(t['ms'], 4) for t in turns]}"
                  + (f", digits {[round(t['by_part']['digits'], 1) for t in turns]}"
                     if "by_part" in turns[0] else ""))
    report["plans"] = rows
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"rank_profile": {q: {k: r[k]["device_us"] for k in ("K10", "K13p")}
                                       for q, r in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
