// One-hot small-key partial aggregate for Hopper (sm_90a): K6.
//
// Replaces quokka_tpu/ops/fuse.py:367 / :386 `_build_small` (the matmul
// strategy, use_tables=False): each valid row's bucket is the mixed radix
// sum((code_k + 1) * stride_k) of its dictionary codes (a null code, -1,
// takes slot 0 of its key); invalid rows go to a dump bucket that no output
// reads, so a NaN in a padded row never reaches a sum.  Per bucket g < G:
// the float64 sum of every float column (the reference's one-hot matmul in
// float64), the exact int64 sum of every integer column (its segment
// reduce), the row count and the smallest row index (n when empty).  The
// pre-expressions are evaluated before this kernel (K5), so it reads plain
// columns.
//
// What bounds it: bytes.  A row reads its codes (4 B a key), validity and
// each column (8 B) once; the outputs are a few hundred entries.  Design,
// deterministic, with no atomics: a block takes 256-row chunks; per chunk
// it stages the rows' columns in shared memory and sorts the rows by bucket
// with a stable counting sort (__match_any_sync and a popcount of the lower
// lanes give a row's rank in its warp, the warps' counts and one scan over
// the buckets give the offsets, as in K17), so each output entry (bucket,
// column) adds only its own bucket's rows, in row order: n x columns adds
// in all, not the one-hot's n x G x columns.  An entry's thread keeps its
// sum across the block's chunks; block partials go to [blocks, entries],
// and a second pass combines them per entry in block order (a warp per
// entry: lanes take every 32nd block, then a fixed shuffle tree).  The
// result is the same every run.  A thread owns 1, 2, 4 or 8 entries, the
// fewest that cover them in one launch, so small outputs keep few
// registers and many blocks in flight; wider ones take several launches.
// Tensor cores (FP64 DMMA) are not used.

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_K6_THREADS 256
#define QK_K6_WARPS (QK_K6_THREADS / 32)
#define QK_K6_PER_THREAD 8  // most entries a thread owns in one launch
#define QK_K6_MAX_KEYS 8
#define QK_K6_MAX_COLS 32
#define QK_K6_MAX_BUCKETS 256

struct QkAggIn {
  const double* f[QK_K6_MAX_COLS];
  const long long* i[QK_K6_MAX_COLS];
  const int32_t* codes[QK_K6_MAX_KEYS];
  int stride[QK_K6_MAX_KEYS];
  int nf, ni, nk;
};

#define QK_K6_STRIDE (QK_K6_THREADS + 1)

template <int PER>
__global__ void __launch_bounds__(QK_K6_THREADS)
qk_onehot_partial_kernel(QkAggIn in, const uint8_t* __restrict__ valid, long long n,
                         int n_groups, int e0, int ne, int n_entries,
                         double* __restrict__ partial) {
  extern __shared__ double stage[];  // [nf + ni][QK_K6_STRIDE]
  __shared__ int32_t wpos[QK_K6_WARPS][QK_K6_MAX_BUCKETS];
  __shared__ int32_t start[QK_K6_MAX_BUCKETS + 1];
  __shared__ int32_t sorted[QK_K6_THREADS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int A = in.nf + in.ni + 2;
  const int nb = n_groups + 1;
  long long* istage = (long long*)(stage + (long long)in.nf * QK_K6_STRIDE);
  int eg[PER], ea[PER];
  double af[PER];
  long long ai[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    int local = tid + m * QK_K6_THREADS;
    eg[m] = -1;
    ea[m] = -1;
    af[m] = 0.0;
    ai[m] = 0;
    if (local < ne) {
      eg[m] = (e0 + local) / A;
      ea[m] = (e0 + local) % A;
      if (ea[m] == A - 1) ai[m] = n;
    }
  }
  for (long long c0 = (long long)blockIdx.x * QK_K6_THREADS; c0 < n;
       c0 += (long long)gridDim.x * QK_K6_THREADS) {
    const int rows = (int)(n - c0 < QK_K6_THREADS ? n - c0 : QK_K6_THREADS);
    const long long row = c0 + tid;
    const bool have = tid < rows;
    int g = n_groups;
    if (have) {  // codes and validity loaded together, not one after the other
      int id = 0;
      for (int k = 0; k < in.nk; ++k) id += (in.codes[k][row] + 1) * in.stride[k];
      if (valid[row]) g = id;
    }
    for (int a = 0; a < in.nf; ++a) stage[a * QK_K6_STRIDE + tid] = have ? in.f[a][row] : 0.0;
    for (int a = 0; a < in.ni; ++a) istage[a * QK_K6_STRIDE + tid] = have ? in.i[a][row] : 0;
    for (int j = tid; j < QK_K6_WARPS * nb; j += QK_K6_THREADS) wpos[j / nb][j % nb] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const int rank = __popc(peers & lower);
    if (rank == 0) wpos[warp][g] = __popc(peers);
    __syncthreads();
    int total = 0;
    if (tid < nb) {  // warps' counts -> offsets inside the bucket
      for (int w = 0; w < QK_K6_WARPS; ++w) {
        int c = wpos[w][tid];
        wpos[w][tid] = total;
        total += c;
      }
      start[tid + 1] = total;
    }
    if (tid == 0) start[0] = 0;
    __syncthreads();
    for (int d = 1; d < nb; d <<= 1) {  // inclusive scan of start[1..nb]
      int add = (tid < nb && tid >= d) ? start[tid + 1 - d] : 0;
      __syncthreads();
      if (tid < nb) start[tid + 1] += add;
      __syncthreads();
    }
    sorted[start[g] + wpos[warp][g] + rank] = tid;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int b = eg[m], a = ea[m];
      if (b < 0) continue;
      const int lo = start[b], hi = start[b + 1];
      if (a < in.nf) {
        const double* x = stage + a * QK_K6_STRIDE;
        double s = af[m];
        for (int j = lo; j < hi; ++j) s += x[sorted[j]];
        af[m] = s;
      } else if (a < in.nf + in.ni) {
        const long long* x = istage + (a - in.nf) * QK_K6_STRIDE;
        long long s = ai[m];
        for (int j = lo; j < hi; ++j) s += x[sorted[j]];
        ai[m] = s;
      } else if (a == A - 2) {
        ai[m] += hi - lo;
      } else if (ai[m] == n && hi > lo) {
        ai[m] = c0 + sorted[lo];
      }
    }
    __syncthreads();
  }
  double* out = partial + (long long)blockIdx.x * n_entries + e0;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    int local = tid + m * QK_K6_THREADS;
    if (local >= ne) continue;
    out[local] = ea[m] < in.nf ? af[m] : __longlong_as_double(ai[m]);
  }
}

// one warp per entry: lane l combines blocks l, l + 32, ... in order, then
// a fixed shuffle tree; the same order every run
__global__ void qk_onehot_reduce_kernel(const double* __restrict__ partial, int blocks,
                                        int n_entries, int n_groups, int nf, int ni, long long n,
                                        double* __restrict__ fout, long long* __restrict__ iout,
                                        int32_t* __restrict__ cnt, long long* __restrict__ rep) {
  const int e = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (e >= n_entries) return;
  const int A = nf + ni + 2;
  const int g = e / A, a = e % A;
  if (a < nf) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * n_entries + e];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) fout[(long long)a * n_groups + g] = s;
    return;
  }
  const bool is_min = a == A - 1;
  long long s = is_min ? n : 0;
  for (int b = lane; b < blocks; b += 32) {
    long long v = __double_as_longlong(partial[(long long)b * n_entries + e]);
    s = is_min ? (v < s ? v : s) : s + v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    long long v = __shfl_down_sync(0xffffffffu, s, o);
    s = is_min ? (v < s ? v : s) : s + v;
  }
  if (lane != 0) return;
  if (is_min)
    rep[g] = s;
  else if (a == A - 2)
    cnt[g] = (int32_t)s;
  else
    iout[(long long)(a - nf) * n_groups + g] = s;
}

template <int PER>
static cudaError_t qk_launch_partial(const QkAggIn& in, const void* valid, long long n,
                                     int n_groups, int e0, int ne, int n_entries, int blocks,
                                     size_t smem, cudaStream_t st, void* partial) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(qk_onehot_partial_kernel<PER>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  qk_onehot_partial_kernel<PER><<<blocks, QK_K6_THREADS, smem, st>>>(
      in, (const uint8_t*)valid, n, n_groups, e0, ne, n_entries, (double*)partial);
  return cudaGetLastError();
}

extern "C" {

int qk_onehot_agg(const void* const* fcols, int nf, const void* const* icols, int ni,
                  const void* const* codes, const int* strides, int nk, const void* valid,
                  long long n, int n_groups, int blocks, void* partial, void* fout, void* iout,
                  void* cnt, void* rep, void* stream) {
  if (nf < 0 || ni < 0 || nf + ni > QK_K6_MAX_COLS || nk < 1 || nk > QK_K6_MAX_KEYS
      || n_groups < 1 || n_groups > QK_K6_MAX_BUCKETS - 1 || n < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  QkAggIn in;
  in.nf = nf;
  in.ni = ni;
  in.nk = nk;
  for (int c = 0; c < nf; ++c) in.f[c] = (const double*)fcols[c];
  for (int c = 0; c < ni; ++c) in.i[c] = (const long long*)icols[c];
  for (int k = 0; k < nk; ++k) {
    in.codes[k] = (const int32_t*)codes[k];
    in.stride[k] = strides[k];
  }
  size_t smem = (size_t)(nf + ni) * QK_K6_STRIDE * sizeof(double);
  cudaStream_t st = (cudaStream_t)stream;
  const int n_entries = n_groups * (nf + ni + 2);
  // the fewest entries a thread owns that cover them in one launch (fewer
  // registers, more blocks on an SM), else the most and several launches
  int per = 1;
  while (per < QK_K6_PER_THREAD && per * QK_K6_THREADS < n_entries) per <<= 1;
  for (int e0 = 0; e0 < n_entries; e0 += per * QK_K6_THREADS) {
    int ne = n_entries - e0 < per * QK_K6_THREADS ? n_entries - e0 : per * QK_K6_THREADS;
    cudaError_t (*launch)(const QkAggIn&, const void*, long long, int, int, int, int, int,
                          size_t, cudaStream_t, void*) =
        per == 1 ? qk_launch_partial<1> : per == 2 ? qk_launch_partial<2>
        : per == 4 ? qk_launch_partial<4> : qk_launch_partial<8>;
    cudaError_t err = launch(in, valid, n, n_groups, e0, ne, n_entries, blocks, smem, st,
                             partial);
    if (err != cudaSuccess) return (int)err;
  }
  qk_onehot_reduce_kernel<<<(n_entries + 7) / 8, 256, 0, st>>>(
      (const double*)partial, blocks, n_entries, n_groups, nf, ni, n, (double*)fout,
      (long long*)iout, (int32_t*)cnt, (long long*)rep);
  return (int)cudaGetLastError();
}

}  // extern "C"
