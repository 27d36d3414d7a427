#!/usr/bin/env python3
"""Profile the sorted searches K18 and K12 of the PyTorch port on one NVIDIA GPU.

    python3 search_profile.py [--package DIR] [--seed N] [--out FILE]

It runs the backward as-of backtest over bench.py's ticks (K18) and TPC-H
Q3 under QK_KERNEL_STRATEGY=join_build=sort at SF1 (K12) through the
quokka_tpu_torch package of ``--package`` (a checkout's root; this one by
default, or e.g. the parent commit unpacked with ``git archive``), with
chip_smoke.py's data and queries, and keeps the arguments of each kernel's
largest call.  At those arguments it reports, per kernel: the wrapper's
time with CUDA events, its kernels' device time and launch attributes from
torch.profiler's trace (grid, block, registers per thread, shared memory,
estimated achieved occupancy), and the yardstick, torch.searchsorted over
one packed int64 limb, timed the same way.  For K18, whose yardstick
searches the live probe rows only while the kernel searches every row, it
also times the kernel on the live rows alone and the yardstick on every
row.  Built here from this checkout's csrc/search.cuh, it times variants
of both kernels at the same arguments:

- K12 on a persistent grid (as many blocks as the card keeps resident)
  whose blocks stage the first 11 levels' pivots of the sorted build in
  shared memory once, then walk them before the rest of the search in
  device memory;
- K18 (two int32 key limbs, int64 times, where the package builds K18's
  run table) as csrc/asof.cu runs it, with
  the run table read from device memory instead of shared memory, without
  the time search (the run search and the tail alone: its outputs are not
  the as-of match), and with the time search started at the row the
  run's first and last times interpolate, then galloping outwards to a
  bracket that the power-of-two search finishes (an exact search: its
  outputs are checked against the plain version), and with a 4-ary time
  search;
- K12 with the same 4-ary search.

The 4-ary search merges two levels of the power-of-two walk into one
round: it tests rows pos + q - 1, pos + 2q - 1 and pos + 3q - 1 at once
and moves pos by q for each that holds (the predicate is monotone, so they
hold as a prefix), so a row's dependent reads halve and its reads grow by
half.

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
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PIVOT_LEVELS = 11
PIVOT_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

#define QK_PIVOT_LEVELS %(levels)d
#define QK_PIVOTS ((1 << QK_PIVOT_LEVELS) - 1)

// K12 over one int64 limb, the first QK_PIVOT_LEVELS levels of qk_bound's
// walk from pivots staged once per block: with hp the largest power of two
// <= n, those levels test rows (m + 1) * stride - 1, stride = hp >> (L - 1)
__global__ void __launch_bounds__(256)
    qk_sorted_probe_pivots_kernel(const long long* __restrict__ s,
                                  const long long* __restrict__ x,
                                  const int32_t* __restrict__ perm,
                                  const long long* __restrict__ n_valid_p, uint32_t nb,
                                  const uint8_t* __restrict__ ok, uint32_t p,
                                  int32_t* __restrict__ build_idx,
                                  uint8_t* __restrict__ matched) {
  __shared__ long long piv[QK_PIVOTS];
  const uint32_t n = (uint32_t)*n_valid_p;
  const uint32_t hp = n ? 1u << (31 - __clz((int)n)) : 0u;
  int levels = 0;
  while (levels < QK_PIVOT_LEVELS && (hp >> levels) != 0) ++levels;
  const uint32_t stride = levels ? hp >> (levels - 1) : 1u;
  const uint32_t np = (1u << levels) - 1;
  for (uint32_t m = threadIdx.x; m < np; m += blockDim.x) {
    const uint32_t idx = (m + 1) * stride - 1;
    if (idx < n) piv[m] = s[idx];
  }
  __syncthreads();
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += gridDim.x * blockDim.x) {
    const long long xv = x[i];
    uint32_t pm = 0;
    bool e = false;
    for (uint32_t step = (np + 1) >> 1; step != 0; step >>= 1) {
      const uint32_t m = pm + step - 1;
      if ((m + 1) * stride - 1 < n) {
        const long long v = piv[m];
        if (v < xv) pm += step;
        else e = v == xv;
      } else {
        e = false;
      }
    }
    uint32_t pos = pm * stride;
    for (uint32_t step = stride >> 1; step != 0; step >>= 1) {
      const uint32_t idx = pos + step - 1;
      if (idx < n) {
        const long long v = __ldg(s + idx);
        if (v < xv) pos += step;
        else e = v == xv;
      } else {
        e = false;
      }
    }
    const uint32_t at = pos > nb - 1 ? nb - 1 : pos;
    const int32_t b = perm[at];
    build_idx[i] = b < 0 ? 0 : (b > (int32_t)(nb - 1) ? (int32_t)(nb - 1) : b);
    matched[i] = (ok[i] && e) ? 1 : 0;
  }
}

extern "C" int qk_sorted_probe_pivots(const void* s, const void* x, const void* perm,
                                      const void* n_valid, long long nb, const void* ok,
                                      long long p, void* build_idx, void* matched,
                                      void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_sorted_probe_pivots_kernel, 256, 0);
  qk_sorted_probe_pivots_kernel<<<sms * per_sm, 256, 0, (cudaStream_t)stream>>>(
      (const long long*)s, (const long long*)x, (const int32_t*)perm,
      (const long long*)n_valid, (uint32_t)nb, (const uint8_t*)ok, (uint32_t)p,
      (int32_t*)build_idx, (uint8_t*)matched);
  return (int)cudaGetLastError();
}
"""


K18_VARIANTS = r"""
#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

typedef QkCols<int32_t, int32_t> Keys;
typedef QkRow<int32_t, int32_t> Row;

// the first row in [lo, hi) of the sorted times that is not <= t (kUpper)
// or not < t, from the row the run's ends interpolate, galloping outwards
template <bool kUpper>
__device__ __forceinline__ uint32_t qk_interp_bound(const long long* __restrict__ s,
                                                    uint32_t lo, uint32_t hi, long long t) {
  const uint32_t n = hi - lo;
  const long long a0 = __ldg(s + lo), a1 = __ldg(s + hi - 1);
  uint32_t g = lo;
  if (a1 > a0) {
    double f = ((double)t - (double)a0) / ((double)a1 - (double)a0) * (double)n;
    f = f < 0.0 ? 0.0 : (f > (double)(n - 1) ? (double)(n - 1) : f);
    g = lo + (uint32_t)f;
  }
  uint32_t a, b;  // the result lies in [a, b]
  long long v = __ldg(s + g);
  if (kUpper ? v <= t : v < t) {
    a = g + 1;
    b = hi;
    for (uint32_t step = 1; g + step < hi; step <<= 1) {
      v = __ldg(s + g + step);
      if (kUpper ? v <= t : v < t) {
        a = g + step + 1;
      } else {
        b = g + step;
        break;
      }
    }
  } else {
    a = lo;
    b = g;
    for (uint32_t step = 1; g >= lo + step; step <<= 1) {
      v = __ldg(s + g - step);
      if (kUpper ? v <= t : v < t) {
        a = g - step + 1;
        break;
      }
      b = g - step;
    }
  }
  QkCols<long long> c;
  c.p = s;
  QkRow<long long> x;
  x.v = t;
  bool e;
  return qk_bound<kUpper>(c, a, b - a, x, &e);
}

// the 4-ary form of qk_bound over one int64 limb; *eq as qk_bound's
template <bool kUpper>
__device__ __forceinline__ uint32_t qk_bound4(const long long* __restrict__ s, uint32_t lo,
                                              uint32_t n, long long x, bool* eq) {
  uint32_t pos = lo;
  const uint32_t end = lo + n;
  bool e = false;
  uint32_t step = n ? 1u << (31 - __clz((int)n)) : 0u;
  if (step != 0 && (31 - __clz((int)step)) % 2 == 0) {  // an odd number of levels: one alone
    const uint32_t idx = pos + step - 1;
    const long long v = __ldg(s + idx);
    if (kUpper ? v <= x : v < x) pos += step;
    else e = v == x;
    step >>= 1;
  }
  for (uint32_t q = step >> 1; q != 0; q >>= 2) {
    const uint32_t i1 = pos + q - 1, i2 = i1 + q, i3 = i2 + q;
    const long long v1 = i1 < end ? __ldg(s + i1) : 0;
    const long long v2 = i2 < end ? __ldg(s + i2) : 0;
    const long long v3 = i3 < end ? __ldg(s + i3) : 0;
    const bool c1 = i1 < end && (kUpper ? v1 <= x : v1 < x);
    const bool c2 = c1 && i2 < end && (kUpper ? v2 <= x : v2 < x);
    const bool c3 = c2 && i3 < end && (kUpper ? v3 <= x : v3 < x);
    if (!c1) e = i1 < end && v1 == x;
    else if (!c2) e = i2 < end && v2 == x;
    else if (!c3) e = i3 < end && v3 == x;
    pos += q * ((uint32_t)c1 + (uint32_t)c2 + (uint32_t)c3);
  }
  *eq = e;
  return pos;
}

__global__ void __launch_bounds__(256)
    qk_sorted_probe4_kernel(const long long* __restrict__ s, const long long* __restrict__ x,
                            const int32_t* __restrict__ perm,
                            const long long* __restrict__ n_valid_p, uint32_t nb,
                            const uint8_t* __restrict__ ok, uint32_t p,
                            int32_t* __restrict__ build_idx, uint8_t* __restrict__ matched) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  bool e;
  const uint32_t lo = qk_bound4<false>(s, 0, (uint32_t)*n_valid_p, x[i], &e);
  const uint32_t at = lo > nb - 1 ? nb - 1 : lo;
  const int32_t b = perm[at];
  build_idx[i] = b < 0 ? 0 : (b > (int32_t)(nb - 1) ? (int32_t)(nb - 1) : b);
  matched[i] = (ok[i] && e) ? 1 : 0;
}

extern "C" int qk_sorted_probe4(const void* s, const void* x, const void* perm,
                                const void* n_valid, long long nb, const void* ok, long long p,
                                void* build_idx, void* matched, void* stream) {
  qk_sorted_probe4_kernel<<<(unsigned int)((p + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const long long*)s, (const long long*)x, (const int32_t*)perm,
      (const long long*)n_valid, (uint32_t)nb, (const uint8_t*)ok, (uint32_t)p,
      (int32_t*)build_idx, (uint8_t*)matched);
  return (int)cudaGetLastError();
}

// kStage: the run table in shared memory; kTime 0: no time search, 1: the
// power-of-two search, 2: interpolation and gallop, 3: the 4-ary search
template <bool kStage, int kTime>
__global__ void __launch_bounds__(256)
    qk_asof_variant_kernel(Keys runs, Keys probe, const long long* __restrict__ times,
                           const long long* __restrict__ ptime,
                           const int32_t* __restrict__ bounds, uint32_t n_runs, int upper,
                           const int32_t* __restrict__ perm, uint32_t nq,
                           const uint8_t* __restrict__ valid, uint32_t p,
                           int32_t* __restrict__ quote_idx, uint8_t* __restrict__ matched) {
  extern __shared__ __align__(16) unsigned char smem[];
  Row* s_rows = (Row*)smem;
  int32_t* s_bounds = (int32_t*)(smem + (((size_t)n_runs * sizeof(Row) + 15) & ~(size_t)15));
  if (kStage) {
    for (uint32_t j = threadIdx.x; j < n_runs; j += blockDim.x) s_rows[j] = runs.load(j);
    for (uint32_t j = threadIdx.x; j <= n_runs; j += blockDim.x) s_bounds[j] = bounds[j];
    __syncthreads();
  }
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const Row key = probe.load(i);
  const long long t = ptime[i];
  bool keq;
  const uint32_t r = kStage ? qk_bound<false>(QkStaged<Row>{s_rows}, 0, n_runs, key, &keq)
                            : qk_bound<false>(runs, 0, n_runs, key, &keq);
  const int32_t* b = kStage ? s_bounds : bounds;
  const uint32_t lo = (uint32_t)b[r];
  const uint32_t hi = keq ? (uint32_t)b[r + 1] : lo;
  uint32_t pos = lo;
  bool hit = false;
  if (keq && kTime != 0) {
    if (kTime == 2) {
      pos = upper ? qk_interp_bound<true>(times, lo, hi, t)
                  : qk_interp_bound<false>(times, lo, hi, t);
    } else if (kTime == 3) {
      bool e;
      pos = upper ? qk_bound4<true>(times, lo, hi - lo, t, &e)
                  : qk_bound4<false>(times, lo, hi - lo, t, &e);
    } else {
      QkCols<long long> c;
      c.p = times;
      QkRow<long long> x;
      x.v = t;
      bool e;
      pos = upper ? qk_bound<true>(c, lo, hi - lo, x, &e) : qk_bound<false>(c, lo, hi - lo, x, &e);
    }
    hit = upper ? pos > lo : pos < hi;
  }
  const int64_t at = upper ? (int64_t)pos - 1 : (int64_t)pos;
  const int64_t cpos = at < 0 ? 0 : (at > (int64_t)nq - 1 ? (int64_t)nq - 1 : at);
  const int32_t q = perm[cpos];
  quote_idx[i] = q < 0 ? 0 : (q > (int32_t)(nq - 1) ? (int32_t)(nq - 1) : q);
  matched[i] = (valid[i] && hit) ? 1 : 0;
}

template <bool kStage, int kTime>
static void qk_asof_variant_launch(const void* const* run_keys, const void* const* probe,
                                   const void* times, const void* bounds, long long n_runs,
                                   int upper, const void* perm, long long nq,
                                   const void* valid, long long p, void* quote_idx,
                                   void* matched, cudaStream_t st) {
  const size_t stage = (((size_t)n_runs * sizeof(Row) + 15) & ~(size_t)15) + 4 * (n_runs + 1);
  qk_asof_variant_kernel<kStage, kTime><<<(unsigned int)((p + 255) / 256), 256,
                                          kStage ? stage : 0, st>>>(
      Keys::at(run_keys), Keys::at(probe), (const long long*)times,
      (const long long*)probe[2], (const int32_t*)bounds, (uint32_t)n_runs, upper,
      (const int32_t*)perm, (uint32_t)nq, (const uint8_t*)valid, (uint32_t)p,
      (int32_t*)quote_idx, (uint8_t*)matched);
}

// variant: 0 unstaged, 1 no time search, 2 interpolation and gallop, 3 4-ary
extern "C" int qk_asof_variant(int variant, const void* const* run_keys,
                               const void* const* probe, const void* times,
                               const void* bounds, long long n_runs, int upper,
                               const void* perm, long long nq, const void* valid, long long p,
                               void* quote_idx, void* matched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0)
    qk_asof_variant_launch<false, 1>(run_keys, probe, times, bounds, n_runs, upper, perm, nq,
                                     valid, p, quote_idx, matched, st);
  else if (variant == 1)
    qk_asof_variant_launch<true, 0>(run_keys, probe, times, bounds, n_runs, upper, perm, nq,
                                    valid, p, quote_idx, matched, st);
  else if (variant == 2)
    qk_asof_variant_launch<true, 2>(run_keys, probe, times, bounds, n_runs, upper, perm, nq,
                                    valid, p, quote_idx, matched, st);
  else
    qk_asof_variant_launch<true, 3>(run_keys, probe, times, bounds, n_runs, upper, perm, nq,
                                    valid, p, quote_idx, matched, st);
  return (int)cudaGetLastError();
}
"""


def kernel_attrs(prof, prefixes):
    """Launch attributes of the profiled kernels whose names start with one
    of ``prefixes`` (after a leading "void "), from the profiler's trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path)).get("traceEvents", [])
    out = {}
    for ev in events:
        name = ev.get("name", "")
        short = name[5:] if name.startswith("void ") else name
        if ev.get("cat") != "kernel" or not short.startswith(prefixes):
            continue
        a = ev.get("args", {})
        out.setdefault(short.split("(")[0], {
            "grid": a.get("grid"), "block": a.get("block"),
            "registers per thread": a.get("registers per thread"),
            "shared memory": a.get("shared memory"),
            "blocks per SM": a.get("blocks per SM"),
            "warps per SM": a.get("warps per SM"),
            "est. achieved occupancy %": a.get("est. achieved occupancy %")})
    return out


def measure(name, fn, prefixes, iters: int = 20, profiled: int = 10):
    """Event-timed ms of fn over ``iters`` calls, and from a profiled window
    of ``profiled`` calls its kernels' device us per call (chip_smoke's
    kernel_us), in all and by kernel, with their launch attributes."""
    import chip_smoke

    ms = chip_smoke.cuda_ms(fn, iters=iters)
    per_kernel, prof = chip_smoke.kernel_us(fn, prefixes, profiled)
    us = sum(per_kernel.values())
    row = {"ms": ms, "device_us": us,
           "device_us_by_kernel": {k.split("(")[0]: t for k, t in per_kernel.items()},
           "kernels": kernel_attrs(prof, prefixes) if prefixes else {}}
    print(f"{name}: {ms:.4f} ms, {us:.1f} device us, {row['device_us_by_kernel']}, "
          f"{row['kernels']}", flush=True)
    return row


def build_variant(name, source):
    """A variant's shared library, built with this checkout's csrc/ headers."""
    out = ROOT / "build" / "search_profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(source)
    from quokka_tpu_torch.ops import native

    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I",
                    str(ROOT / "quokka_tpu_torch" / "csrc"), "-o", str(out / f"lib{name}.so"),
                    str(out / f"{name}.cu")], check=True)
    return ctypes.CDLL(str(out / f"lib{name}.so"))


def build_pivots(dev):
    """The K12 pivot-staged alternative."""
    cdll = build_variant("pivots", PIVOT_SOURCE % {"levels": PIVOT_LEVELS})
    P, L = ctypes.c_void_p, ctypes.c_longlong
    cdll.qk_sorted_probe_pivots.argtypes = [P, P, P, P, L, P, L, P, P, P]
    cdll.qk_sorted_probe_pivots.restype = ctypes.c_int
    return cdll


def build_k18_variants(dev):
    """The K18 variants (two int32 key limbs, int64 times)."""
    cdll = build_variant("k18_variants", K18_VARIANTS)
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    PP = ctypes.POINTER(ctypes.c_void_p)
    cdll.qk_asof_variant.argtypes = [I, PP, PP, P, P, L, I, P, L, P, L, P, P, P]
    cdll.qk_asof_variant.restype = I
    cdll.qk_sorted_probe4.argtypes = [P, P, P, P, L, P, L, P, P, P]
    cdll.qk_sorted_probe4.restype = I
    return cdll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "search_profile.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("search_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    pkg = Path(args.package).resolve()
    if not (pkg / "quokka_tpu_torch" / "__init__.py").is_file():
        print(f"search_profile: no quokka_tpu_torch package in {pkg}", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(pkg / "build" / "quokka_tpu_torch" / "triton"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pkg))
    import chip_smoke
    from quokka_tpu_torch import QuokkaContext
    from quokka_tpu_torch.ops import asof, join, native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    native.build_all(["join", "asof"])
    report = {"card": card, "package": str(pkg)}

    # K18 at the backward as-of backtest's largest call
    ctx = QuokkaContext(io_channels=2, exec_channels=2, device=dev)
    os.environ.pop("QK_KERNEL_STRATEGY", None)
    ticks = chip_smoke.make_ticks(1.0, args.seed)
    with chip_smoke.Capture({"K18": (asof, "asof_probe",
                                     lambda *a, **kw: a[4].shape[0])}) as cap:
        chip_smoke.collect_numpy(chip_smoke.tick_stream("asof", ctx, ticks), "asof")
    (a18, _) = cap.args["K18"]
    so, pm, nv, po, pv, up, nk = a18[:7]  # and the run table, where the package has one
    n_sorted, live = int(nv), pv.bool()
    report["k18_shape"] = {"probe_rows": pv.shape[0], "live": int(live.sum()),
                           "sorted_quotes": pm.shape[0], "valid_quotes": n_sorted,
                           "limbs": [str(o.dtype) for o in po],
                           "launches": cap.calls["K18"]}
    print(f"K18 shape: {report['k18_shape']}")
    report["k18"] = measure("K18", lambda: asof._asof_probe_cuda(*a18), ("qk_asof_probe",))
    _, rank = torch.unique(torch.cat([torch.stack([o[:n_sorted].long() for o in so[:nk]], 1),
                                      torch.stack([o[live].long() for o in po[:nk]], 1)]),
                           dim=0, return_inverse=True)
    tq, tp = so[nk][:n_sorted].long(), po[nk][live].long()
    t0 = torch.cat([tq, tp]).min()
    packed_q = torch.sort((rank[:n_sorted] << 40) | (tq - t0)).values
    packed_p = (rank[n_sorted:] << 40) | (tp - t0)
    report["k18_yardstick"] = measure(
        "K18 yardstick (torch.searchsorted, live rows, one packed int64 limb)",
        lambda: torch.searchsorted(packed_q, packed_p, right=True), None)
    # like for like: the kernel on the live rows alone, the yardstick on every row
    rows = live.nonzero().flatten()
    a18_live = (so, pm, nv, [o[rows].contiguous() for o in po], pv[rows].contiguous(), up,
                nk) + tuple(a18[7:])
    report["k18_live_rows"] = measure("K18 on the live probe rows alone",
                                      lambda: asof._asof_probe_cuda(*a18_live),
                                      ("qk_asof_probe",))
    _, rank_all = torch.unique(torch.cat([torch.stack([o[:n_sorted].long() for o in so[:nk]], 1),
                                          torch.stack([o.long() for o in po[:nk]], 1)]),
                               dim=0, return_inverse=True)
    ta = po[nk].long()
    t1 = torch.cat([tq, ta]).min()
    packed_q_all = torch.sort((rank_all[:n_sorted] << 40) | (tq - t1)).values
    packed_p_all = (rank_all[n_sorted:] << 40) | (ta - t1)
    report["k18_yardstick_all_rows"] = measure(
        "K18 yardstick on every probe row",
        lambda: torch.searchsorted(packed_q_all, packed_p_all, right=True), None)
    if len(a18) > 7 and [o.dtype for o in po] == [torch.int32, torch.int32, torch.int64]:
        runs = a18[7]
        lib = build_k18_variants(dev)
        p = pv.shape[0]
        qi = torch.empty(p, dtype=torch.int32, device=dev)
        mt = torch.empty(p, dtype=torch.bool, device=dev)
        run_keys = native.ptr_array([k.data_ptr() for k in runs.keys])
        probe = native.ptr_array([o.data_ptr() for o in po])
        valid8 = pv.contiguous().view(torch.uint8)

        def variant(v):
            native.check(lib.qk_asof_variant(
                v, run_keys, probe, so[nk].data_ptr(), runs.bounds.data_ptr(),
                runs.bounds.shape[0] - 1, 1 if up else 0, pm.data_ptr(), pm.shape[0],
                valid8.data_ptr(), p, qi.data_ptr(), mt.view(torch.uint8).data_ptr(),
                native.stream_ptr(dev)), "qk_asof_variant")

        want = asof._asof_probe_plain(*a18[:7])
        for v, what in ((0, "the run table read from device memory"),
                        (1, "no time search (the run search and the tail)"),
                        (2, "interpolation and gallop in the run"),
                        (3, "a 4-ary time search")):
            variant(v)
            if v != 1 and not (torch.equal(qi, want[0]) and torch.equal(mt, want[1])):
                print(f"search_profile: the K18 variant {what} differs from the plain "
                      "version", file=sys.stderr)
                return 1
            report[f"k18_variant_{v}"] = measure(f"K18 variant: {what}",
                                                 lambda: variant(v), ("qk_asof_variant",))

    # K12 at Q3's sort path's largest call
    tables = chip_smoke.make_tpch(1.0, args.seed)
    os.environ["QK_KERNEL_STRATEGY"] = "join_build=sort"
    with chip_smoke.Capture({"K12": (join, "pk_probe_sorted",
                                     lambda s, pm_, nv_, pl, ok: ok.shape[0])}) as cap:
        chip_smoke.collect_numpy(chip_smoke.tpch_stream("q3", ctx, tables), "q3 sort")
    os.environ.pop("QK_KERNEL_STRATEGY", None)
    (a12, _) = cap.args["K12"]
    s_limbs, s_perm, s_nv, s_pl, s_ok = a12
    report["k12_shape"] = {"probe_rows": s_ok.shape[0], "ok": int(s_ok.sum()),
                           "build_rows": s_perm.shape[0], "valid_build": int(s_nv),
                           "limbs": [str(l.dtype) for l in s_limbs],
                           "launches": cap.calls["K12"]}
    print(f"K12 shape: {report['k12_shape']}")
    report["k12"] = measure("K12", lambda: join._pk_probe_sorted_cuda(*a12),
                            ("qk_sorted_probe",))
    valid0 = s_limbs[0][:int(s_nv)].contiguous()
    report["k12_yardstick"] = measure("K12 yardstick (torch.searchsorted, one int64 limb)",
                                      lambda: torch.searchsorted(valid0, s_pl[0]), None)
    if len(s_limbs) == 1 and s_limbs[0].dtype == torch.int64:
        lib = build_pivots(dev)
        nv_dev = s_nv.to(device=dev, dtype=torch.int64).reshape(1)
        x = s_pl[0].contiguous()
        ok8 = s_ok.contiguous().view(torch.uint8)
        bi = torch.empty(x.shape[0], dtype=torch.int32, device=dev)
        mt = torch.empty(x.shape[0], dtype=torch.bool, device=dev)

        def pivots():
            native.check(lib.qk_sorted_probe_pivots(
                s_limbs[0].data_ptr(), x.data_ptr(), s_perm.data_ptr(), nv_dev.data_ptr(),
                s_perm.shape[0], ok8.data_ptr(), x.shape[0], bi.data_ptr(),
                mt.view(torch.uint8).data_ptr(), native.stream_ptr(dev)),
                "qk_sorted_probe_pivots")

        pivots()
        ik, mk = join._pk_probe_sorted_plain(*a12)
        if not (torch.equal(mt, mk) and torch.equal(bi[mt], ik[mk])):
            print("search_profile: the pivot-staged K12 differs from the plain version",
                  file=sys.stderr)
            return 1
        report["k12_pivots"] = measure(
            f"K12 with {PIVOT_LEVELS} levels of pivots staged, persistent grid", pivots,
            ("qk_sorted_probe_pivots",))
        lib4 = build_k18_variants(dev)

        def probe4():
            native.check(lib4.qk_sorted_probe4(
                s_limbs[0].data_ptr(), x.data_ptr(), s_perm.data_ptr(), nv_dev.data_ptr(),
                s_perm.shape[0], ok8.data_ptr(), x.shape[0], bi.data_ptr(),
                mt.view(torch.uint8).data_ptr(), native.stream_ptr(dev)), "qk_sorted_probe4")

        probe4()
        if not (torch.equal(mt, mk) and torch.equal(bi[mt], ik[mk])):
            print("search_profile: the 4-ary K12 differs from the plain version",
                  file=sys.stderr)
            return 1
        report["k12_4ary"] = measure("K12 with the 4-ary search", probe4,
                                     ("qk_sorted_probe4",))
        report["k12_again"] = measure("K12 (again, after the alternative)",
                                      lambda: join._pk_probe_sorted_cuda(*a12),
                                      ("qk_sorted_probe",))
    line = json.dumps(report)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
