// Fused cosine similarity + per-query top-k for Hopper (sm_90a): K21.
//
// Replaces quokka_tpu/executors/vector.py:49 `_sims` with the
// `jax.lax.top_k` of :61 and the host merge of the running state at
// :82-91.  The reference normalises a batch's vectors, forms the whole
// [Q, N] similarity matrix (queries @ v.T), masks invalid rows to -inf,
// takes each query's top k, and merges that with the running [Q, k] state
// on the host.  At 10,000 queries and a 2^20-row batch that matrix is 42 GB;
// this kernel never writes it.
//
// What bounds it: operations.  2 Q N d float32 multiply-adds (2.37e12 at
// glove-100-angular's shape, 35 ms at 67 TFLOP/s) against N d 8 bytes of
// float64 vectors (0.28 ms at 3.35 TB/s).  Design: pass 1 tiles 64 queries x
// 128 rows per step; each step stages a 16-deep slice of both through
// shared memory (the vectors converted to float32 as they are loaded, as
// `vec.data.astype(float32)` does), every thread keeps a 4 x 8 block of dot
// products in float32 registers, and the row's sum of squares accumulates
// in the same loop over d, so d can be any width.  The dot products are
// scaled by 1 / max(|v|, 1e-12) (a null, zero row scores 0; an invalid row
// -inf), and one thread per query folds the step's 128 scores into the
// query's running top k, held sorted in shared memory.  Blocks split the
// rows S ways, and each writes its k best per query: [Q, S, k] candidates,
// a few MB.  Pass 2, one thread per query, merges the S sorted lists into
// the batch's top kb and that into the running state.  No tensor cores and
// no TF32: full float32 FMAs, so near neighbours keep their order.
//
// Orders (held against the reference on the CPU, tests/test_torch_vector.py):
// - a batch's top k is lax.top_k's: the IEEE total order of the float bits
//   (NaN above +inf, +0.0 above -0.0), ties to the lower row.  NaN scores
//   are made the positive quiet NaN first;
// - the running merge is the reference's host merge, argsort(-scores):
//   by value with -0.0 equal to +0.0, NaN below -inf, ties keeping the
//   running state first, then the batch in its own order (a stable sort);
//   an empty slot (handle < 0) ranks below everything.
// Candidate keys pack (total-order key << 32) | (0xFFFFFFFF - row), so one
// unsigned compare orders score, then row; an empty candidate is 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QK_TQ 64       // queries per block
#define QK_TN 128      // rows per step
#define QK_TD 16       // depth of one staged slice
#define QK_QS (QK_TQ + 4)
#define QK_VS (QK_TN + 4)
#define QK_THREADS 256
#define QK_MAX_K 128
#define QK_MAX_S 64

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t qk_total_key(float s) {
  uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float qk_from_total_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the host merge's order: empty 0, NaN 1, then by value (-0.0 == +0.0)
__device__ __forceinline__ u64 qk_merge_key(float s, long long h) {
  if (h < 0) return 0ull;
  if (s != s) return 1ull;
  if (s == 0.0f) s = 0.0f;
  return 2ull + (u64)qk_total_key(s);
}

__global__ void __launch_bounds__(QK_THREADS)
qk_sims_topk_kernel(const float* __restrict__ q, int nq, int d, const double* __restrict__ v,
                    long long n, const uint8_t* __restrict__ valid, int k,
                    long long rows_per_split, int n_split, u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = (float*)smem;                 // [TD][QS]
  float* vs = qs + QK_TD * QK_QS;           // [TD][VS]
  float* sims = vs + QK_TD * QK_VS;         // [TQ][TN + 1]
  float* ss = sims + QK_TQ * (QK_TN + 1);   // [TN] sums of squares
  u64* lists = (u64*)(ss + QK_TN);          // [TQ][k], sorted, best first

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * QK_TQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  long long r_end = r_begin + rows_per_split;
  if (r_end > n) r_end = n;

  for (int i = tid; i < QK_TQ * k; i += QK_THREADS) lists[i] = 0ull;

  for (long long r0 = r_begin; r0 < r_end; r0 += QK_TN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    if (tid < QK_TN) ss[tid] = 0.0f;
    for (int d0 = 0; d0 < d; d0 += QK_TD) {
      __syncthreads();  // the last slice (and the last step's scores) are consumed
      for (int i = tid; i < QK_TD * QK_TQ; i += QK_THREADS) {
        int qq = i / QK_TD, dd = i % QK_TD;
        int qi = q0 + qq, col = d0 + dd;
        qs[dd * QK_QS + qq] = (qi < nq && col < d) ? q[(long long)qi * d + col] : 0.0f;
      }
      for (int i = tid; i < QK_TD * QK_TN; i += QK_THREADS) {
        int rr = i / QK_TD, dd = i % QK_TD;
        long long row = r0 + rr;
        int col = d0 + dd;
        vs[dd * QK_VS + rr] = (row < r_end && col < d) ? (float)v[row * d + col] : 0.0f;
      }
      __syncthreads();
      if (tid < QK_TN) {
        float s = ss[tid];
#pragma unroll
        for (int dd = 0; dd < QK_TD; ++dd) {
          float x = vs[dd * QK_VS + tid];
          s = fmaf(x, x, s);
        }
        ss[tid] = s;
      }
#pragma unroll
      for (int dd = 0; dd < QK_TD; ++dd) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[dd * QK_QS + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = vs[dd * QK_VS + tx * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // every sum of squares of the step is complete
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int rr = tx * 8 + j;
      long long row = r0 + rr;
      float inv = 0.0f;
      bool ok = false;
      if (row < r_end) {
        inv = 1.0f / fmaxf(sqrtf(ss[rr]), 1e-12f);
        ok = valid[row] != 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j] * inv;
        if (s != s) s = __uint_as_float(0x7fc00000u);
        if (!ok) s = -INFINITY;
        sims[(ty * 4 + i) * (QK_TN + 1) + rr] = s;
      }
    }
    __syncthreads();
    if (tid < QK_TQ && q0 + tid < nq) {
      u64* L = lists + tid * k;
      u64 thr = L[k - 1];
      int nr = (int)(r_end - r0 < QK_TN ? r_end - r0 : QK_TN);
      for (int rr = 0; rr < nr; ++rr) {
        float s = sims[tid * (QK_TN + 1) + rr];
        u64 key = ((u64)qk_total_key(s) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)(r0 + rr));
        if (key > thr) {
          int p = k - 1;
          while (p > 0 && L[p - 1] < key) {
            L[p] = L[p - 1];
            --p;
          }
          L[p] = key;
          thr = L[k - 1];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < QK_TQ * k; i += QK_THREADS) {
    int qq = i / k, j = i % k;
    if (q0 + qq < nq) cand[((long long)(q0 + qq) * n_split + split) * k + j] = lists[i];
  }
}

__global__ void qk_topk_merge_kernel(const u64* __restrict__ cand, int nq, int n_split, int k,
                                     int kb, const float* __restrict__ state_s,
                                     const long long* __restrict__ state_h, long long handle_hi,
                                     float* __restrict__ out_s, long long* __restrict__ out_h) {
  int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float* os = out_s + (long long)qi * k;
  long long* oh = out_h + (long long)qi * k;
  // the running state is already in merge order: it starts the stable merge
  for (int j = 0; j < k; ++j) {
    os[j] = state_s[(long long)qi * k + j];
    oh[j] = state_h[(long long)qi * k + j];
  }
  const u64* C = cand + (long long)qi * n_split * k;
  int pos[QK_MAX_S];
  for (int s = 0; s < n_split; ++s) pos[s] = 0;
  for (int t = 0; t < kb; ++t) {
    // the batch's next best candidate (lax.top_k order)
    u64 best = 0ull;
    int bs = -1;
    for (int s = 0; s < n_split; ++s) {
      if (pos[s] < k) {
        u64 c = C[(long long)s * k + pos[s]];
        if (c > best) {
          best = c;
          bs = s;
        }
      }
    }
    if (bs < 0) break;
    pos[bs]++;
    float sc = qk_from_total_key((uint32_t)(best >> 32));
    long long h = handle_hi | (long long)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFull));
    u64 mk = qk_merge_key(sc, h);
    if (mk <= qk_merge_key(os[k - 1], oh[k - 1])) continue;  // ties keep the earlier entry
    int p = k - 1;
    while (p > 0 && qk_merge_key(os[p - 1], oh[p - 1]) < mk) {
      os[p] = os[p - 1];
      oh[p] = oh[p - 1];
      --p;
    }
    os[p] = sc;
    oh[p] = h;
  }
}

static int qk_launch_sims(const float* q, int nq, int d, const double* v, long long n,
                          const uint8_t* valid, int k, long long rows_per_split, int n_split,
                          u64* cand, cudaStream_t st) {
  size_t smem = (size_t)(QK_TD * QK_QS + QK_TD * QK_VS + QK_TQ * (QK_TN + 1) + QK_TN) *
                    sizeof(float) + (size_t)QK_TQ * k * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(qk_sims_topk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)((nq + QK_TQ - 1) / QK_TQ), (unsigned int)n_split);
  qk_sims_topk_kernel<<<grid, QK_THREADS, smem, st>>>(q, nq, d, v, n, valid, k, rows_per_split,
                                                     n_split, cand);
  return (int)cudaGetLastError();
}

extern "C" {

// q [nq, d] float32 (normalised), v [n, d] float64,
// valid [n] uint8, state_s [nq, k] float32 and state_h [nq, k] int64 (the
// running state in merge order; handle -1 = empty), cand [nq, n_split, k]
// uint64 scratch.  Rows [s * rows_per_split, (s + 1) * rows_per_split) go to
// split s.  out_s / out_h [nq, k] receive the merged state; a row of this
// batch gets the handle (batch << 32) | row, with handle_hi = batch << 32.
int qk_sims_topk(const void* q, int nq, int d, const void* v, long long n,
                 const void* valid, int k, int kb, int n_split, long long rows_per_split,
                 void* cand, const void* state_s, const void* state_h, long long handle_hi,
                 void* out_s, void* out_h, void* stream) {
  if (nq < 0 || d < 1 || n < 0 || k < 1 || k > QK_MAX_K || kb < 0 || kb > k ||
      n_split < 1 || n_split > QK_MAX_S || rows_per_split < 1 || n > 0xFFFFFFFFll ||
      (long long)n_split * rows_per_split < n)
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && kb > 0) {
    int err = qk_launch_sims((const float*)q, nq, d, (const double*)v, n,
                             (const uint8_t*)valid, k, rows_per_split, n_split, (u64*)cand, st);
    if (err != 0) return err;
  } else {
    kb = 0;
  }
  qk_topk_merge_kernel<<<(nq + 127) / 128, 128, 0, st>>>(
      (const u64*)cand, nq, n_split, k, kb, (const float*)state_s, (const long long*)state_h,
      handle_hi, (float*)out_s, (long long*)out_h);
  return (int)cudaGetLastError();
}

}  // extern "C"
