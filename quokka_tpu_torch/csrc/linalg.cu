// Masked Gramian + column sums for Hopper (sm_90a): K22.
//
// Replaces quokka_tpu/executors/linalg.py:37 `_accumulate`: m = the batch's
// d columns stacked and cast to float32 (:46), invalid rows zeroed, then
// m^T m and the column sums.  A null float stays NaN and propagates, as in
// the reference, which masks rows only.  The reference sums in float32;
// here every product of two float32 values is formed exactly in float64 and
// summed in float64, so the result is the exact sum of the reference's
// products up to float64 rounding.
//
// What bounds it: bytes.  Each row's d values (8 bytes each) and its
// validity byte are read once: n (8d + 1) bytes, 10 us per 2^20-row batch
// at d = 4 over 3.35 TB/s; the d(d+1)/2 + d float64 multiply-adds per row
// stay under the float64 rate up to d of about 64.  Design: a block stages a
// chunk of rows of every column through shared memory as float32 (the
// column reads coalesced, one column at a time), and each thread owns one
// or more output entries (the upper triangle row by row, then the sums).
// When there are fewer entries than threads, the threads split the rows of
// each chunk into groups and the groups' sums are added in a fixed order at
// the end.  Block partials go to [blocks, entries]; a second pass adds them
// per entry in block order.  No atomics: the result is the same every run.
// A launch covers at most 2304 entries; the wrapper tiles larger outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_COLS 128
#define QK_THREADS 256
#define QK_PER_THREAD 9

struct QkCols {
  const void* p[QK_MAX_COLS];
  int dt[QK_MAX_COLS];  // 0 f64, 1 f32, 2 i64, 3 i32, 4 bool (u8)
};

__device__ __forceinline__ float qk_load_f32(const QkCols& c, int col, long long row) {
  switch (c.dt[col]) {
    case 0: return (float)((const double*)c.p[col])[row];
    case 1: return ((const float*)c.p[col])[row];
    case 2: return __ll2float_rn(((const long long*)c.p[col])[row]);
    case 3: return (float)((const int32_t*)c.p[col])[row];
    default: return (float)((const uint8_t*)c.p[col])[row];
  }
}

// entry e of the output: (i, j) of the upper triangle for e < d(d+1)/2,
// then (i, -1) for the sum of column i
__device__ __forceinline__ void qk_entry(int e, int d, int* i, int* j) {
  int tri = d * (d + 1) / 2;
  if (e >= tri) {
    *i = e - tri;
    *j = -1;
    return;
  }
  int r = 0;
  while (e >= d - r) {
    e -= d - r;
    ++r;
  }
  *i = r;
  *j = r + e;
}

__global__ void __launch_bounds__(QK_THREADS)
qk_gram_partial_kernel(QkCols cols, int d, long long n, const uint8_t* __restrict__ valid,
                       int e0, int ne, int chunk, int n_entries,
                       double* __restrict__ partial) {
  extern __shared__ float xs[];  // [d][chunk + 1]
  __shared__ double red[QK_THREADS];
  const int tid = threadIdx.x;
  const int stride = chunk + 1;
  const int groups = ne <= QK_THREADS ? QK_THREADS / ne : 1;
  const bool grouped = ne <= QK_THREADS;
  const int g = grouped ? tid / ne : 0;
  const bool active = grouped ? tid < groups * ne : true;
  int ei[QK_PER_THREAD], ej[QK_PER_THREAD];
  double acc[QK_PER_THREAD];
#pragma unroll
  for (int m = 0; m < QK_PER_THREAD; ++m) {
    int local = grouped ? (m == 0 ? tid % ne : ne) : tid + m * QK_THREADS;
    acc[m] = 0.0;
    ei[m] = -1;
    ej[m] = -1;
    if (active && local < ne) qk_entry(e0 + local, d, &ei[m], &ej[m]);
  }
  for (long long c0 = (long long)blockIdx.x * chunk; c0 < n;
       c0 += (long long)gridDim.x * chunk) {
    int rows = (int)(n - c0 < chunk ? n - c0 : chunk);
    __syncthreads();
    for (int idx = tid; idx < d * chunk; idx += QK_THREADS) {
      int c = idx / chunk, r = idx % chunk;
      float x = 0.0f;
      if (r < rows && valid[c0 + r]) x = qk_load_f32(cols, c, c0 + r);
      xs[c * stride + r] = x;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < QK_PER_THREAD; ++m) {
      if (ei[m] < 0) continue;
      const float* xi = xs + ei[m] * stride;
      double a = acc[m];
      if (ej[m] < 0) {
        for (int r = g; r < rows; r += groups) a += (double)xi[r];
      } else {
        const float* xj = xs + ej[m] * stride;
        for (int r = g; r < rows; r += groups) a += (double)xi[r] * (double)xj[r];
      }
      acc[m] = a;
    }
  }
  double* out = partial + (long long)blockIdx.x * n_entries + e0;
  if (!grouped) {
#pragma unroll
    for (int m = 0; m < QK_PER_THREAD; ++m) {
      int local = tid + m * QK_THREADS;
      if (local < ne) out[local] = acc[m];
    }
    return;
  }
  red[tid] = active ? acc[0] : 0.0;
  __syncthreads();
  if (tid < ne) {
    double s = 0.0;
    for (int gg = 0; gg < groups; ++gg) s += red[gg * ne + tid];
    out[tid] = s;
  }
}

__global__ void qk_gram_reduce_kernel(const double* __restrict__ partial, int blocks,
                                      int n_entries, double* __restrict__ out) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * n_entries + e];
  out[e] = s;
}

extern "C" {

// cols / dts: d column pointers and their types (n rows each); valid [n]
// uint8.  partial [blocks, d(d+1)/2 + d] float64 scratch; out [d(d+1)/2 +
// d] float64: the upper triangle of m^T m row by row, then the column sums.
int qk_gramian(const void* const* cols, const int* dts, int d, long long n, const void* valid,
               int blocks, void* partial, void* out, void* stream) {
  if (d < 1 || d > QK_MAX_COLS || n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  QkCols c;
  for (int i = 0; i < d; ++i) {
    if (dts[i] < 0 || dts[i] > 4) return (int)cudaErrorInvalidValue;
    c.p[i] = cols[i];
    c.dt[i] = dts[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  int n_entries = d * (d + 1) / 2 + d;
  int chunk = 11776 / d - 1;  // d (chunk + 1) floats within 46 KB, beside red
  if (chunk > 256) chunk = 256;
  if (chunk < 1) chunk = 1;
  size_t smem = (size_t)d * (chunk + 1) * sizeof(float);
  for (int e0 = 0; e0 < n_entries; e0 += QK_THREADS * QK_PER_THREAD) {
    int ne = n_entries - e0 < QK_THREADS * QK_PER_THREAD ? n_entries - e0
                                                         : QK_THREADS * QK_PER_THREAD;
    qk_gram_partial_kernel<<<blocks, QK_THREADS, smem, st>>>(
        c, d, n, (const uint8_t*)valid, e0, ne, chunk, n_entries, (double*)partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  qk_gram_reduce_kernel<<<(n_entries + 255) / 256, 256, 0, st>>>((const double*)partial,
                                                                 blocks, n_entries,
                                                                 (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
