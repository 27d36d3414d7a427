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
// validity byte are read once: n (8d + 1) bytes, 10.3 us per 2^20-row batch
// at d = 4 over 3.35 TB/s; the d(d+1)/2 + d float64 multiply-adds per row
// stay under the float64 rate up to d of about 64.
//
// Design, d <= 8 (`qk_gram_small_kernel<D>`, the paths' case: four
// lineitem columns): one pass with the d(d+1)/2 + d float64 sums in each
// thread's registers (D is a template argument, so the array is never
// indexed at run time).  A thread walks rows grid-stride, four at a time;
// it issues the validity byte and every column's raw bits of the four rows
// before it converts any (the type switch branches on a warp-uniform
// value, and no load waits on another), then selects (x = valid ? x : 0: an
// invalid row's NaN becomes 0, a valid row's propagates).  The grid fills
// the card at the kernel's occupancy.
//
// Design, d > 8 (`qk_gram_wide_kernel`, no path today): a block stages a
// chunk of rows of every column through shared memory as float32, and each
// thread owns one or more output entries (the upper triangle row by row,
// then the sums); with fewer entries than threads, groups of threads split
// the chunk's rows and are added in a fixed order.  A launch covers at most
// 2304 entries; larger outputs take one launch per 2304.
//
// Both end the same way, in one launch and in a fixed order, with no float
// atomics: warp shuffles (d <= 8), the block's warps or groups in order,
// block partials, then the last block to finish (an integer ticket after a
// __threadfence; it leaves the ticket at 0 for the next launch) adds the
// partials in block order and writes the symmetric [d, d] and the [d]
// sums.  The same inputs give the same bits every run.

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_COLS 128
#define QK_THREADS 256
#define QK_WARPS (QK_THREADS / 32)
#define QK_PER_THREAD 9
#define QK_UNROLL 4

struct QkCols {
  const void* p[QK_MAX_COLS];
  int dt[QK_MAX_COLS];  // 0 f64, 1 f32, 2 i64, 3 i32, 4 bool (u8)
};

// a value's raw bits, zero-extended to 64
__device__ __forceinline__ unsigned long long qk_load_raw(const QkCols& c, int col,
                                                          long long row) {
  switch (c.dt[col]) {
    case 0:
    case 2: return __ldg((const unsigned long long*)c.p[col] + row);
    case 1:
    case 3: return __ldg((const unsigned int*)c.p[col] + row);
    default: return __ldg((const unsigned char*)c.p[col] + row);
  }
}

// the raw bits as the reference's float32 cast
__device__ __forceinline__ float qk_to_f32(int dt, unsigned long long raw) {
  switch (dt) {
    case 0: return (float)__longlong_as_double((long long)raw);
    case 1: return __uint_as_float((unsigned int)raw);
    case 2: return __ll2float_rn((long long)raw);
    case 3: return (float)(int)(unsigned int)raw;
    default: return (float)(unsigned int)raw;
  }
}

// entry e of the output: (i, j) of the upper triangle for e < d(d+1)/2,
// then (i, -1) for the sum of column i
__host__ __device__ __forceinline__ void qk_entry(int e, int d, int* i, int* j) {
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

// The last block of a launch: entries [e0, e0 + ne) of partial [blocks,
// n_entries], added in block order, into out (gram [d, d], then sums [d]);
// the ticket back to 0.  Entry e is summed by warp e % 8: lanes take blocks
// lane, lane + 32, ..., then a shuffle tree.
__device__ void qk_gram_finish(const double* partial, int blocks, int n_entries, int e0, int ne,
                               int d, double* out, unsigned int* ticket) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = e0 + warp; e < e0 + ne; e += QK_WARPS) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s += __ldcg(partial + (long long)b * n_entries + e);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) {
      int i, j;
      qk_entry(e, d, &i, &j);
      if (j < 0) {
        out[d * d + i] = s;
      } else {
        out[i * d + j] = s;
        out[j * d + i] = s;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// after the block's partials are stored: whether this block is the last
__device__ __forceinline__ bool qk_last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <int D>
__global__ void __launch_bounds__(QK_THREADS)
    qk_gram_small_kernel(QkCols cols, long long n, const uint8_t* __restrict__ valid,
                         double* __restrict__ partial, unsigned int* __restrict__ ticket,
                         double* __restrict__ out) {
  constexpr int TRI = D * (D + 1) / 2;
  constexpr int NE = TRI + D;
  __shared__ double red[QK_WARPS][NE];
  int dt[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dt[c] = cols.dt[c];
  double acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.0;

  auto add_row = [&](const float (&x)[D]) {
    int e = 0;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) acc[e++] += (double)x[i] * (double)x[j];
#pragma unroll
    for (int i = 0; i < D; ++i) acc[TRI + i] += (double)x[i];
  };

  const long long stride = (long long)gridDim.x * QK_THREADS;
  long long row = (long long)blockIdx.x * QK_THREADS + threadIdx.x;
  for (; row + (QK_UNROLL - 1) * stride < n; row += QK_UNROLL * stride) {
    unsigned long long raw[QK_UNROLL][D];
    uint8_t ok[QK_UNROLL];
#pragma unroll
    for (int u = 0; u < QK_UNROLL; ++u) {
      ok[u] = __ldg(valid + row + u * stride);
#pragma unroll
      for (int c = 0; c < D; ++c) raw[u][c] = qk_load_raw(cols, c, row + u * stride);
    }
#pragma unroll
    for (int u = 0; u < QK_UNROLL; ++u) {
      float x[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float v = qk_to_f32(dt[c], raw[u][c]);
        x[c] = ok[u] ? v : 0.0f;
      }
      add_row(x);
    }
  }
  for (; row < n; row += stride) {
    const uint8_t ok = __ldg(valid + row);
    unsigned long long raw[D];
#pragma unroll
    for (int c = 0; c < D; ++c) raw[c] = qk_load_raw(cols, c, row);
    float x[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float v = qk_to_f32(dt[c], raw[c]);
      x[c] = ok ? v : 0.0f;
    }
    add_row(x);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    double s = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][e] = s;
  }
  __syncthreads();
  if (threadIdx.x < NE) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < QK_WARPS; ++w) s += red[w][threadIdx.x];
    partial[(long long)blockIdx.x * NE + threadIdx.x] = s;
  }
  if (qk_last_block(ticket)) qk_gram_finish(partial, gridDim.x, NE, 0, NE, D, out, ticket);
}

__device__ __forceinline__ float qk_load_f32(const QkCols& c, int col, long long row) {
  return qk_to_f32(c.dt[col], qk_load_raw(c, col, row));
}

__global__ void __launch_bounds__(QK_THREADS)
    qk_gram_wide_kernel(QkCols cols, int d, long long n, const uint8_t* __restrict__ valid,
                        int e0, int ne, int chunk, int n_entries, double* __restrict__ partial,
                        unsigned int* __restrict__ ticket, double* __restrict__ out) {
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
      if (r < rows) {
        const uint8_t ok = __ldg(valid + c0 + r);
        const float v = qk_load_f32(cols, c, c0 + r);
        x = ok ? v : 0.0f;
      }
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
  double* part = partial + (long long)blockIdx.x * n_entries + e0;
  if (!grouped) {
#pragma unroll
    for (int m = 0; m < QK_PER_THREAD; ++m) {
      int local = tid + m * QK_THREADS;
      if (local < ne) part[local] = acc[m];
    }
  } else {
    red[tid] = active ? acc[0] : 0.0;
    __syncthreads();
    if (tid < ne) {
      double s = 0.0;
      for (int gg = 0; gg < groups; ++gg) s += red[gg * ne + tid];
      part[tid] = s;
    }
  }
  if (qk_last_block(ticket)) qk_gram_finish(partial, gridDim.x, n_entries, e0, ne, d, out, ticket);
}

template <int D>
static int qk_small_per_sm() {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qk_gram_small_kernel<D>, QK_THREADS, 0);
  return err != cudaSuccess ? -(int)err : per_sm;
}

template <int D>
static int qk_small_launch(const QkCols& c, long long n, const void* valid, int blocks,
                           void* partial, void* ticket, void* out, cudaStream_t st) {
  qk_gram_small_kernel<D><<<blocks, QK_THREADS, 0, st>>>(c, n, (const uint8_t*)valid,
                                                         (double*)partial,
                                                         (unsigned int*)ticket, (double*)out);
  return (int)cudaGetLastError();
}

extern "C" {

// Blocks of qk_gram_small_kernel<d> an SM holds at once (d <= 8), or minus
// a CUDA error.
int qk_gram_blocks_per_sm(int d) {
  switch (d) {
    case 1: return qk_small_per_sm<1>();
    case 2: return qk_small_per_sm<2>();
    case 3: return qk_small_per_sm<3>();
    case 4: return qk_small_per_sm<4>();
    case 5: return qk_small_per_sm<5>();
    case 6: return qk_small_per_sm<6>();
    case 7: return qk_small_per_sm<7>();
    case 8: return qk_small_per_sm<8>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

// cols / dts: d column pointers and their types (n rows each); valid [n]
// uint8.  partial [blocks, d(d+1)/2 + d] float64 scratch; ticket one
// uint32 that is 0 (and is 0 again when the launch ends); out [d * d + d]
// float64: m^T m row major, then the column sums.  d > 8 takes chunks of
// 11760 / d - 1 rows (at most 256) per block step.
int qk_gramian(const void* const* cols, const int* dts, int d, long long n, const void* valid,
               int blocks, void* partial, void* ticket, void* out, void* stream) {
  if (d < 1 || d > QK_MAX_COLS || n < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  QkCols c;
  for (int i = 0; i < d; ++i) {
    if (dts[i] < 0 || dts[i] > 4) return (int)cudaErrorInvalidValue;
    c.p[i] = cols[i];
    c.dt[i] = dts[i];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 1: return qk_small_launch<1>(c, n, valid, blocks, partial, ticket, out, st);
    case 2: return qk_small_launch<2>(c, n, valid, blocks, partial, ticket, out, st);
    case 3: return qk_small_launch<3>(c, n, valid, blocks, partial, ticket, out, st);
    case 4: return qk_small_launch<4>(c, n, valid, blocks, partial, ticket, out, st);
    case 5: return qk_small_launch<5>(c, n, valid, blocks, partial, ticket, out, st);
    case 6: return qk_small_launch<6>(c, n, valid, blocks, partial, ticket, out, st);
    case 7: return qk_small_launch<7>(c, n, valid, blocks, partial, ticket, out, st);
    case 8: return qk_small_launch<8>(c, n, valid, blocks, partial, ticket, out, st);
    default: break;
  }
  int n_entries = d * (d + 1) / 2 + d;
  // d (chunk + 1) floats within 45.9 KB, beside red and the last-block flag
  int chunk = 11760 / d - 1;
  if (chunk > 256) chunk = 256;
  if (chunk < 1) chunk = 1;
  size_t smem = (size_t)d * (chunk + 1) * sizeof(float);
  for (int e0 = 0; e0 < n_entries; e0 += QK_THREADS * QK_PER_THREAD) {
    int ne = n_entries - e0 < QK_THREADS * QK_PER_THREAD ? n_entries - e0
                                                         : QK_THREADS * QK_PER_THREAD;
    qk_gram_wide_kernel<<<blocks, QK_THREADS, smem, st>>>(
        c, d, n, (const uint8_t*)valid, e0, ne, chunk, n_entries, (double*)partial,
        (unsigned int*)ticket, (double*)out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
