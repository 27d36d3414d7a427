// Sliding-window kernels for Hopper (sm_90a): the segmented window bounds
// (K20a) and the range min/max (K20b).
//
// K20a replaces quokka_tpu/executors/ts_execs.py:_bisect_left_segmented
// and :_bisect_right_segmented: over rows sorted by (key, time), row i's
// window is [left_i, right_i] where left_i is the first row of its key
// segment with time >= t_i - size and right_i the last row with time <=
// t_i.  The reference runs two lockstep binary searches of 32 fixed steps
// with clamped gathers; this kernel runs the same 32 steps per row for
// both bounds in one pass, so every row, padding included, gets the
// reference's bounds bit for bit.  What bounds it: bytes (the time, segment
// start and end of each row read once, two int32 written) and the latency
// of the dependent reads, which stay inside one key segment and mostly hit
// L1 and L2.  Design: one thread per row, both searches in registers.
//
// K20b replaces :_range_minmax: the min or max of x over [left_i,
// right_i].  As the reference, a sparse table: level k holds the combine of
// 2^k rows starting at each row (rows past the end repeat the last), built
// one level per pass (an elementwise kernel), and each row combines two
// overlapping power-of-two blocks that cover its range.  min / max are
// exact, so the result equals every other evaluation of the same ranges.
// What bounds it: bytes; the table costs log2(n) passes over n values
// (about 22 x 2^21 x 8 B = 370 MB for one float64 column at 2^21 rows),
// against 24 B per row that the function must move.  NaN propagates, as
// jnp.minimum / jnp.maximum do.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int64_t qk_clamp(int64_t v, int64_t n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

__device__ __forceinline__ int64_t qk_floordiv2(int64_t v) {
  return v >= 0 ? v / 2 : -((-v + 1) / 2);
}

template <typename T>
__global__ void qk_window_bounds_kernel(const T* __restrict__ t,
                                        const int32_t* __restrict__ seg_start,
                                        const int32_t* __restrict__ seg_end, int64_t n,
                                        T size, int32_t* __restrict__ left,
                                        int32_t* __restrict__ right) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T ti = t[i];
  T lo_t = ti - size;
  // smallest j in [seg_start, i] with t[j] >= t_i - size
  int64_t lo = seg_start[i], hi = i;
  for (int s = 0; s < 32; ++s) {
    int64_t mid = qk_floordiv2(lo + hi);
    bool go_right = t[qk_clamp(mid, n)] < lo_t;
    if (go_right) lo = mid + 1;
    else hi = mid;
  }
  left[i] = (int32_t)lo;
  // largest j in [i, seg_end] with t[j] <= t_i
  lo = i;
  hi = seg_end[i];
  for (int s = 0; s < 32; ++s) {
    int64_t mid = qk_floordiv2(lo + hi + 1);
    bool le = t[qk_clamp(mid, n)] <= ti;
    if (le) lo = mid;
    else hi = mid - 1;
  }
  right[i] = (int32_t)lo;
}

template <typename T>
__device__ __forceinline__ T qk_minmax(T a, T b, int is_min) {
  if (a != a) return a;  // NaN propagates (floats only; ints never differ from themselves)
  if (b != b) return b;
  if (is_min) return b < a ? b : a;
  return b > a ? b : a;
}

// level k from level k - 1: out[i] = op(prev[i], prev[min(i + span, n - 1)])
template <typename T>
__global__ void qk_minmax_level_kernel(const T* __restrict__ prev, int64_t n,
                                       int64_t span, int is_min, T* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t j = i + span < n ? i + span : n - 1;
  out[i] = qk_minmax(prev[i], prev[j], is_min);
}

template <typename T>
__global__ void qk_minmax_query_kernel(const T* __restrict__ table, int64_t n, int levels,
                                       const int32_t* __restrict__ left,
                                       const int32_t* __restrict__ right, int is_min,
                                       T* __restrict__ out) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t l = left[i], r = right[i];
  int64_t len = r - l + 1;
  if (len < 1) len = 1;
  int k = 63 - __clzll((unsigned long long)len);  // floor(log2(len))
  if (k > levels - 1) k = levels - 1;
  const T* lvl = table + (int64_t)k * n;
  T a = lvl[qk_clamp(l, n)];
  T b = lvl[qk_clamp(r - ((int64_t)1 << k) + 1, n)];
  out[i] = qk_minmax(a, b, is_min);
}

template <typename T>
static int qk_range_minmax_t(const void* x, long long n, int levels, const void* left,
                             const void* right, int is_min, void* table, void* out,
                             cudaStream_t st) {
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  T* tab = (T*)table;
  cudaMemcpyAsync(tab, x, (size_t)n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  long long span = 1;
  for (int k = 1; k < levels; ++k) {
    qk_minmax_level_kernel<T><<<blocks, threads, 0, st>>>(
        tab + (int64_t)(k - 1) * n, n, span, is_min, tab + (int64_t)k * n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    span *= 2;
  }
  qk_minmax_query_kernel<T><<<blocks, threads, 0, st>>>(
      tab, n, levels, (const int32_t*)left, (const int32_t*)right, is_min, (T*)out);
  return (int)cudaGetLastError();
}

extern "C" {

// t (n rows, dt 0 f64 / 2 i64), seg_start and seg_end (n int32); size as
// the column's type (size_f for f64, size_i for i64).  left and right (n
// int32) are outputs.
int qk_window_bounds(const void* t, int dt, const void* seg_start, const void* seg_end,
                     long long n, long long size_i, double size_f, void* left,
                     void* right, void* stream) {
  if (n < 0 || (dt != 0 && dt != 2)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (dt == 0)
    qk_window_bounds_kernel<double><<<blocks, threads, 0, st>>>(
        (const double*)t, (const int32_t*)seg_start, (const int32_t*)seg_end, n, size_f,
        (int32_t*)left, (int32_t*)right);
  else
    qk_window_bounds_kernel<long long><<<blocks, threads, 0, st>>>(
        (const long long*)t, (const int32_t*)seg_start, (const int32_t*)seg_end, n,
        size_i, (int32_t*)left, (int32_t*)right);
  return (int)cudaGetLastError();
}

// x (n rows, dt 0 f64 / 1 f32 / 2 i64 / 3 i32), left and right (n int32),
// table (levels * n values of x's type, scratch), out (n values).  levels
// is the reference's count: 1 + ceil(log2(n)).
int qk_range_minmax(const void* x, int dt, long long n, int levels, const void* left,
                    const void* right, int is_min, void* table, void* out, void* stream) {
  if (n < 0 || levels < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dt) {
    case 0: return qk_range_minmax_t<double>(x, n, levels, left, right, is_min, table, out, st);
    case 1: return qk_range_minmax_t<float>(x, n, levels, left, right, is_min, table, out, st);
    case 2: return qk_range_minmax_t<long long>(x, n, levels, left, right, is_min, table, out,
                                                st);
    case 3: return qk_range_minmax_t<int32_t>(x, n, levels, left, right, is_min, table, out,
                                              st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
