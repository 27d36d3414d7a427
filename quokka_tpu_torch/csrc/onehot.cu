// Small-key bucket aggregate for Hopper (sm_90a): the core of K2 and K6.
//
// One device core, two callers, each with its own wrapper and launch count
// (ops/fuse.py):
// - K2 replaces quokka_tpu/ops/fuse.py:462 `_build_small_scatter` (the
//   scatter strategy, the GPU default): its plain partial inputs are read
//   here as they lie, and only expression inputs come from a Triton
//   pre-pass;
// - K6 replaces quokka_tpu/ops/fuse.py:367 / :386 `_build_small` (the
//   one-hot matmul strategy, groupby=sort): K5 evaluates its inputs first.
//
// Each valid row's bucket is the mixed radix sum((code_k + 1) * stride_k)
// of its dictionary codes (a null code, -1, takes slot 0 of its key);
// invalid rows go to a dump bucket G that no output reads, so a NaN in a
// padded row never reaches a sum.  Per bucket g < G: the float64 sum of
// every float column (float64 or float32, read in place), the exact int64
// sum of every integer column (int64 or int32), the row count (int32 or
// int64) and the smallest row index (n when empty).  A column tagged
// QK_AGG_NN0 adds 0 for a null (NaN, or the int sentinel), the reference's
// `__nn0` wrapper of sum(x); one tagged QK_AGG_NNCOUNT, summed among the
// integer columns, adds 1 for each value that is not null, its
// `__nncount` wrapper of count(x) and avg(x).
//
// What bounds it: bytes.  A row reads its codes (4 B a key), validity and
// each column once; the outputs are a few hundred entries.  The one-hot
// the reference builds costs n x G x columns; the Triton kernel this core
// replaced selected a [block, G] tile per partial and reduced it across
// warps (G x the adds, 16x its bound at Q1).
//
// Design, deterministic, with no atomics and no block barrier in the row
// loop: each warp owns private per-bucket accumulators in shared memory
// and takes 32 rows a step.  A step groups its lanes into one run per
// bucket (__match_any_sync gives a lane's run; a shuffle scan of the run
// sizes at each run's first lane gives where the run starts, the runs in
// the order of their first lanes), stages each column through shared
// memory in that order, and sums each run with a segmented shuffle scan,
// as many levels as log2 of the widest run (five at Q1's four heavy
// buckets, one or two at the tick paths' 128 light ones).  The run's last
// lane adds the sum into the warp's accumulator, the run's first lane the
// count and its row, the smallest of the bucket in this step.  The first
// columns' loads are issued before the grouping.  At the end a block adds
// its warps' accumulators in warp order into [entries][blocks] partials,
// and a second kernel adds each entry's blocks in block order (a warp per
// entry: lanes take every 32nd block, loads issued four at a time, then a
// fixed shuffle tree), so the result is the same bits every run.  Eight
// warps a block unless their accumulators (entries x 8 B each) pass the
// shared memory; the grid is the card's resident blocks.  Tensor cores
// are not used.  On the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md,
// PR 14) a step's grouping and waits take about 40% of the core's time at
// Q1 and most of it at the tick paths' shape; ordering the runs by bucket
// with one ballot per bit of the bucket id was 8-19% slower, and keeping
// the next steps' rows in flight with cp.async slower still.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define QK_AGG_MAX_KEYS 8
#define QK_AGG_MAX_COLS 32
#define QK_AGG_MAX_BUCKETS 256
#define QK_AGG_WARPS 8       // warps a block holds at most
#define QK_AGG_PREFETCH 4    // columns loaded ahead
#define QK_AGG_SMEM 232448   // shared memory a block may use on sm_90

// a column's tag: its type in the low two bits, QK_AGG_NN0 or
// QK_AGG_NNCOUNT above
enum { QK_AGG_F64 = 0, QK_AGG_F32 = 1, QK_AGG_I64 = 2, QK_AGG_I32 = 3 };
#define QK_AGG_NN0 4
#define QK_AGG_NNCOUNT 8

struct QkAggIn {
  const void* col[QK_AGG_MAX_COLS];  // nf float columns, then ni integer columns
  int tag[QK_AGG_MAX_COLS];
  const int32_t* codes[QK_AGG_MAX_KEYS];
  int stride[QK_AGG_MAX_KEYS];
  int nf, ni, nk;
};

// a column's value at row as raw 64 bits (float32 and int32 widened later)
__device__ __forceinline__ long long qk_agg_raw(const QkAggIn& in, int a, long long row) {
  const void* p = in.col[a];
  switch (in.tag[a] & 3) {
    case QK_AGG_F64: return __ldg((const long long*)p + row);
    case QK_AGG_F32: return (long long)(uint32_t)__ldg((const int*)p + row);
    case QK_AGG_I64: return __ldg((const long long*)p + row);
    default: return (long long)__ldg((const int*)p + row);
  }
}

__device__ __forceinline__ double qk_agg_float(int tag, long long raw) {
  const double x = (tag & 3) == QK_AGG_F32 ? (double)__int_as_float((int)raw)
                                           : __longlong_as_double(raw);
  return ((tag & QK_AGG_NN0) && x != x) ? 0.0 : x;
}

__device__ __forceinline__ long long qk_agg_int(int tag, long long raw) {
  const int t = tag & 3;
  bool null;
  if (t == QK_AGG_F64) {
    const double x = __longlong_as_double(raw);
    null = x != x;
  } else if (t == QK_AGG_F32) {
    const float x = __int_as_float((int)raw);
    null = x != x;
  } else {
    null = raw == (t == QK_AGG_I32 ? (long long)INT_MIN : LLONG_MIN);
  }
  if (tag & QK_AGG_NNCOUNT) return null ? 0 : 1;
  return ((tag & QK_AGG_NN0) && null) ? 0 : raw;
}

// inclusive sum over the lanes of one run: lane's run starts at lane
// `head`, and no run is wider than `widest` lanes, which bounds the levels
template <class T>
__device__ __forceinline__ T qk_seg_scan(T s, int lane, int head, int widest) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= widest) break;
    const T y = __shfl_up_sync(0xffffffffu, s, d);
    if (lane - d >= head) s += y;
  }
  return s;
}

// acc (per warp): [A][G] slots, A = columns + count + smallest row; then
// the warps' staging: [W][32] values, [W][32] run heads, [W][32] buckets.
// partial: [A * G][gridDim.x] raw 64-bit entries.
__global__ void qk_bucket_agg_kernel(QkAggIn in, const uint8_t* __restrict__ valid, long long n,
                                     int G, long long* __restrict__ partial) {
  extern __shared__ long long smem[];
  const int W = blockDim.x >> 5;
  const int C = in.nf + in.ni, A = C + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = A * G;
  long long* acc = smem;
  long long* stage = acc + (long long)W * slots + warp * 32;
  int* heads = (int*)(acc + (long long)W * slots + W * 32) + warp * 32;
  int* bucket = heads + W * 32;
  long long* my = acc + (long long)warp * slots;
  for (int j = lane; j < slots; j += 32) my[j] = j >= (A - 1) * G ? n : 0;
  const unsigned lower = (1u << lane) - 1u;
  const long long step = (long long)gridDim.x * W * 32;
  for (long long base = ((long long)blockIdx.x * W + warp) * 32; base < n; base += step) {
    const long long row = base + lane;
    const bool have = row < n;
    long long v[QK_AGG_PREFETCH];
#pragma unroll
    for (int k = 0; k < QK_AGG_PREFETCH; ++k) v[k] = (k < C && have) ? qk_agg_raw(in, k, row) : 0;
    int g = G;
    if (have) {
      int id = 0;
      for (int k = 0; k < in.nk; ++k) id += (__ldg(in.codes[k] + row) + 1) * in.stride[k];
      if (valid[row] && (unsigned)id < (unsigned)G) g = id;
    }
    // order the lanes by run: eq holds the lanes of g; a run starts after
    // the runs whose first lane is below its own (a scan of run sizes)
    const unsigned eq = __match_any_sync(0xffffffffu, g);
    const int size = __popc(eq);
    const bool lead = (eq & lower) == 0u;  // the run's first lane
    int start = lead ? size : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, start, d);
      if (lane >= d) start += y;
    }
    start -= lead ? size : 0;
    const int head = __shfl_sync(0xffffffffu, start, __ffs(eq) - 1);
    const int dest = head + __popc(eq & lower);
    const int widest = (int)__reduce_max_sync(0xffffffffu, (unsigned)size);
    if (g < G && lead) {  // the run's count and smallest row
      my[C * G + g] += size;
      long long* m = my + (C + 1) * G + g;
      if (row < *m) *m = row;
    }
    heads[dest] = head;
    bucket[dest] = g;
    __syncwarp();
    const int h = heads[lane], gs = bucket[lane];
    const int next = __shfl_down_sync(0xffffffffu, h, 1);
    const bool add = gs < G && (lane == 31 || next != h);  // the run's last lane
    for (int a0 = 0; a0 < C; a0 += QK_AGG_PREFETCH) {
#pragma unroll
      for (int k = 0; k < QK_AGG_PREFETCH; ++k) {
        const int a = a0 + k;
        if (a >= C) break;
        stage[dest] = v[k];
        if (a + QK_AGG_PREFETCH < C && have) v[k] = qk_agg_raw(in, a + QK_AGG_PREFETCH, row);
        __syncwarp();
        const long long raw = stage[lane];
        __syncwarp();
        if (a < in.nf) {
          const double s = qk_seg_scan(qk_agg_float(in.tag[a], raw), lane, h, widest);
          if (add) my[a * G + gs] = __double_as_longlong(__longlong_as_double(my[a * G + gs]) + s);
        } else {
          const long long s = qk_seg_scan(qk_agg_int(in.tag[a], raw), lane, h, widest);
          if (add) my[a * G + gs] += s;
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int e = tid; e < slots; e += blockDim.x) {
    const int a = e / G;
    long long out;
    if (a < in.nf) {
      double s = 0.0;
      for (int w = 0; w < W; ++w) s += __longlong_as_double(acc[(long long)w * slots + e]);
      out = __double_as_longlong(s);
    } else if (a < A - 1) {
      out = 0;
      for (int w = 0; w < W; ++w) out += acc[(long long)w * slots + e];
    } else {
      out = n;
      for (int w = 0; w < W; ++w) out = min(out, acc[(long long)w * slots + e]);
    }
    partial[(long long)e * gridDim.x + blockIdx.x] = out;
  }
}

// one warp per entry (a, g): lane l combines blocks l, l + 32, ... in
// order, four loads in flight, then a fixed shuffle tree
__global__ void qk_bucket_reduce_kernel(const long long* __restrict__ partial, int blocks,
                                        int G, int nf, int ni, long long n,
                                        double* __restrict__ fout, long long* __restrict__ iout,
                                        void* __restrict__ cnt, int cnt64,
                                        long long* __restrict__ rep) {
  const int e = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int A = nf + ni + 2;
  if (e >= A * G) return;
  const int a = e / G, g = e % G;
  const long long* p = partial + (long long)e * blocks;
  if (a < nf) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 128) {
      double x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = b + 32 * k < blocks ? __longlong_as_double(p[b + 32 * k]) : 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += x[k];
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) fout[(long long)a * G + g] = s;
    return;
  }
  const bool is_min = a == A - 1;
  long long s = is_min ? n : 0;
  for (int b = lane; b < blocks; b += 128) {
    long long x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = b + 32 * k < blocks ? p[b + 32 * k] : (is_min ? n : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) s = is_min ? min(s, x[k]) : s + x[k];
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, s, o);
    s = is_min ? min(s, y) : s + y;
  }
  if (lane != 0) return;
  if (is_min)
    rep[g] = s;
  else if (a == A - 2 && cnt64)
    ((long long*)cnt)[g] = s;
  else if (a == A - 2)
    ((int32_t*)cnt)[g] = (int32_t)s;
  else
    iout[(long long)(a - nf) * G + g] = s;
}

extern "C" {

// The bucket aggregate (K2 and K6).  cols: nf float columns then ni integer
// columns of n rows, tags[c] their QK_AGG_* types (| QK_AGG_NN0 or, for an
// integer column, | QK_AGG_NNCOUNT over a column of any type); codes:
// nk int32 columns; valid: n uint8.  partial holds cap_blocks x (nf + ni +
// 2) x n_groups 8-byte entries of scratch.  Outputs: fout [nf][n_groups]
// float64, iout [ni][n_groups] int64, cnt [n_groups] (int64 when cnt64,
// else int32), rep [n_groups] int64 (n where a bucket is empty).
int qk_small_agg(const void* const* cols, const int* tags, int nf, int ni,
                 const void* const* codes, const int* strides, int nk, const void* valid,
                 long long n, int n_groups, void* partial, int cap_blocks, void* fout,
                 void* iout, void* cnt, int cnt64, void* rep, void* stream) {
  if (nf < 0 || ni < 0 || nf + ni > QK_AGG_MAX_COLS || nk < 1 || nk > QK_AGG_MAX_KEYS
      || n_groups < 1 || n_groups > QK_AGG_MAX_BUCKETS - 1 || n < 0 || cap_blocks < 1)
    return (int)cudaErrorInvalidValue;
  QkAggIn in;
  in.nf = nf;
  in.ni = ni;
  in.nk = nk;
  for (int c = 0; c < nf + ni; ++c) {
    const int t = tags[c] & 3;
    const bool fl = (t == QK_AGG_F64 || t == QK_AGG_F32) && !(tags[c] & QK_AGG_NNCOUNT);
    if ((c < nf) != fl || tags[c] & ~(3 | QK_AGG_NN0 | QK_AGG_NNCOUNT))
      return (int)cudaErrorInvalidValue;
    in.col[c] = cols[c];
    in.tag[c] = tags[c];
  }
  for (int k = 0; k < nk; ++k) {
    in.codes[k] = (const int32_t*)codes[k];
    in.stride[k] = strides[k];
  }
  const int A = nf + ni + 2;
  const size_t per_warp = (size_t)A * n_groups * 8 + 32 * 16;
  int warps = (int)(QK_AGG_SMEM / per_warp);
  warps = warps > QK_AGG_WARPS ? QK_AGG_WARPS : warps;
  const size_t smem = warps * per_warp;
  static size_t smem_set = 48 * 1024;  // the opt-in granted so far
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(qk_bucket_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int dev = 0, sms = 1, per_sm = 1;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_bucket_agg_kernel,
                                                               warps * 32, smem)) != cudaSuccess)
    return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + warps * 32 - 1) / (warps * 32);
  blocks = blocks < need ? blocks : need;
  blocks = blocks < cap_blocks ? blocks : cap_blocks;
  blocks = blocks < 1 ? 1 : blocks;
  cudaStream_t st = (cudaStream_t)stream;
  qk_bucket_agg_kernel<<<(unsigned)blocks, warps * 32, smem, st>>>(
      in, (const uint8_t*)valid, n, n_groups, (long long*)partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int entries = A * n_groups;
  qk_bucket_reduce_kernel<<<(entries + 7) / 8, 256, 0, st>>>(
      (const long long*)partial, (int)blocks, n_groups, nf, ni, n, (double*)fout,
      (long long*)iout, cnt, cnt64, (long long*)rep);
  return (int)cudaGetLastError();
}

}  // extern "C"
