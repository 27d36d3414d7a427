// Sliding-window kernels for Hopper (sm_90a): the segmented window bounds
// (K20a) and the range min/max (K20b).
//
// K20a replaces quokka_tpu/executors/ts_execs.py:_bisect_left_segmented
// and :_bisect_right_segmented: over rows sorted by (key, time), row i's
// window is [left_i, right_i] where left_i is the first row of its key
// segment with time >= t_i - size and right_i the last row with time <=
// t_i.  The reference runs two lockstep binary searches of 32 fixed steps
// with clamped gathers.  What bounds it: bytes (the time, segment start and
// end of each row read once, two int32 written) and the latency of the
// dependent reads.  Design: two launches, one thread a row.
// `qk_window_check_kernel` reads each row and its successor and raises one
// flag where the segment bounds are not a partition of the rows into runs
// or a run's times are out of order (NaN last, the sort's order).  Where
// they are, both searches see a monotone predicate, and
// `qk_window_bounds_kernel` searches outward from the row: back 1, 2, 4, ...
// rows until the time drops below t_i - size or the step reaches the
// segment start, forward over times <= t_i until the segment end in the
// same way, then bisects inside the last step; a row costs about 2 log2 of
// its window in rows, whatever its segment's length, and neighbouring
// threads read neighbouring lines.  Where the flag is up, every row runs
// the reference's two searches (stopping once the range is one row, whose
// remaining steps are then known), so every row, padding included, gets
// the reference's bounds bit for bit on any input.

// K20b replaces :902 `_range_minmax`: the min or max of x over [left_i,
// right_i], NaN propagating as jnp.minimum / jnp.maximum do; a range with
// left > right gives op(x[left], x[right]), and bounds out of range clamp
// as the reference's sparse-table lookups clamp them.  What bounds it:
// bytes, 24 B a row at float64 (x, the two bounds, the output).  The
// earlier design built the reference's table, log2(n) levels of n values
// (168 MB at 2^20 float64 rows, in 21 launches), and gathered twice from
// it.  Design, two launches and no level over all n rows:
// `qk_range_summary_kernel` folds x into one value per 32, 1024 and 32768
// rows, and the last block to finish builds a sparse table over the
// 32768-row values (about n / 31 values of scratch in all);
// `qk_range_query_kernel` gives each block a tile of 1024 consecutive rows,
// four a thread, and takes one of two ways, the same for the whole tile:
//  - over rows sorted by (key, time) the windows of a tile cover one short
//    span of x: the block stages that span in shared memory with cp.async,
//    builds sparse levels over it up to three under the tile's longest
//    window (as many as fit; none for sliding's windows of a few rows), and
//    answers each row from a few lookups at its level;
//  - anything else (arbitrary ranges, a window over every row) answers each
//    row from device memory: at each level (rows, 32-row, 1024-row values)
//    the pieces at both ends, at most 31 values each, read eight
//    independent loads at a time, and between full 32768-row chunks two
//    lookups in a sparse table over them: at most 188 reads.
// The sliding executor gives its padding rows a window of their own row,
// so their tiles take the first way (their results are never read).
// min / max are exact, so every way of covering a range gives the same
// value.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int64_t qk_clamp(int64_t v, int64_t n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

__device__ __forceinline__ int64_t qk_floordiv2(int64_t v) {
  return v >= 0 ? v / 2 : -((-v + 1) / 2);
}

// a pair of neighbouring times in the order the sort leaves them: NaN last
template <typename T>
__device__ __forceinline__ bool qk_ordered(T a, T b) {
  return b != b || a <= b;
}

// one flag for the whole call: some row's segment bounds are not its run's
// ends, or some run's times are out of order
template <typename T>
__global__ void qk_window_check_kernel(const T* __restrict__ t,
                                       const int32_t* __restrict__ seg_start,
                                       const int32_t* __restrict__ seg_end, int64_t n,
                                       unsigned int* __restrict__ unsorted) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = seg_start[i], e = seg_end[i];
  bool ok = 0 <= s && s <= i && i <= e && e < n;
  if (i + 1 < n) {
    const int64_t s1 = seg_start[i + 1], e1 = seg_end[i + 1];
    if (s1 == s && e1 == e) ok = ok && qk_ordered(t[i], t[i + 1]);  // one run
    else ok = ok && s1 == i + 1 && e == i;                          // a run ends at i
  }
  if (!ok) *unsorted = 1u;
}

template <typename T>
__global__ void qk_window_bounds_kernel(const T* __restrict__ t,
                                        const int32_t* __restrict__ seg_start,
                                        const int32_t* __restrict__ seg_end, int64_t n,
                                        T size, const unsigned int* __restrict__ unsorted,
                                        int32_t* __restrict__ left,
                                        int32_t* __restrict__ right) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T ti = t[i];
  const T lo_t = ti - size;
  const int64_t s = seg_start[i], e = seg_end[i];
  if (*unsorted) {
    // the reference's searches: smallest j in [s, i] with t[j] >= t_i -
    // size, largest j in [i, e] with t[j] <= t_i.  Once lo == hi, the left
    // search's remaining steps give lo + (t[lo] < t_i - size) and the
    // right one's lo.
    int64_t lo = s, hi = i;
    int k = 0;
    for (; k < 32 && lo != hi; ++k) {
      const int64_t mid = qk_floordiv2(lo + hi);
      if (t[qk_clamp(mid, n)] < lo_t) lo = mid + 1;
      else hi = mid;
    }
    if (k < 32 && t[qk_clamp(lo, n)] < lo_t) ++lo;
    left[i] = (int32_t)lo;
    lo = i;
    hi = e;
    for (k = 0; k < 32 && lo != hi; ++k) {
      const int64_t mid = qk_floordiv2(lo + hi + 1);
      if (t[qk_clamp(mid, n)] <= ti) lo = mid;
      else hi = mid - 1;
    }
    right[i] = (int32_t)lo;
    return;
  }
  // the left bound: the first j in [s, i] with t[j] >= t_i - size (i + 1
  // if none); t[hi] >= t_i - size and t[lo] < t_i - size (s - 1 stands for
  // a row before the segment)
  int64_t lo, hi;
  if (ti < lo_t) {
    lo = i + 1;
  } else {
    lo = s - 1;
    hi = i;
    for (int64_t d = 1;; d <<= 1) {
      const bool last = i - d <= s;
      const int64_t j = last ? s : i - d;
      if (t[j] < lo_t) {
        lo = j;
        break;
      }
      hi = j;
      if (last) break;
    }
    while (hi - lo > 1) {
      const int64_t m = lo + ((hi - lo) >> 1);
      if (t[m] < lo_t) lo = m;
      else hi = m;
    }
    lo = hi;
  }
  left[i] = (int32_t)lo;
  // the right bound: the last j in [i, e] with t[j] <= t_i (i itself is
  // never compared); t[lo] <= t_i and t[hi] > t_i (e + 1 stands for a row
  // after the segment)
  lo = i;
  hi = e + 1;
  for (int64_t d = 1; i < e; d <<= 1) {
    const bool last = i + d >= e;
    const int64_t j = last ? e : i + d;
    if (!(t[j] <= ti)) {
      hi = j;
      break;
    }
    lo = j;
    if (last) break;
  }
  while (hi - lo > 1) {
    const int64_t m = lo + ((hi - lo) >> 1);
    if (t[m] <= ti) lo = m;
    else hi = m;
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

#define QK_RM_THREADS 256   // threads of a block, both kernels
#define QK_RM_ITEMS 4        // rows per thread: a block takes 1024 consecutive rows
#define QK_RM_ROWS (QK_RM_THREADS * QK_RM_ITEMS)
#define QK_RM_SMEM 16384     // bytes of a tile's staged span and its levels
#define QK_RM_LOOKUPS 64     // shared-memory lookups a staged range may take

template <typename T>
__device__ __forceinline__ T qk_shfl_xor(T v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}

// v and o combined over the lanes that hold a value
template <typename T>
__device__ __forceinline__ void qk_fold_lanes(T& v, bool& has, int m, int is_min) {
  const T o = qk_shfl_xor(v, m);
  const bool oh = __shfl_xor_sync(0xffffffffu, has, m);
  if (has && oh) v = qk_minmax(v, o, is_min);
  else if (oh) v = o;
  has = has || oh;
}

// the summaries: one value per 32 rows (s1), per 1024 rows (s2) and per
// 32768 rows (s3, level 0 of a sparse table over them)
template <typename T>
struct QkSummary {
  T* s1;
  T* s2;
  T* t;  // levels x nc3: level k at c covers s3 chunks c .. c + 2^k - 1
  long long nc3;
};

template <typename T>
__device__ __forceinline__ QkSummary<T> qk_summary(T* scratch, long long n) {
  QkSummary<T> S;
  S.s1 = scratch;
  S.s2 = S.s1 + ((n + 31) >> 5);
  S.t = S.s2 + ((n + 1023) >> 10);
  S.nc3 = (n + 32767) >> 15;
  return S;
}

// a block takes 1024 rows, four a thread: s1 by groups of eight lanes, s2
// by the block.  The last of the 32 blocks of a 32768-row chunk (an
// integer ticket of the chunk, taken after the thread that wrote the
// block's s2 fenced it) folds their s2 into the chunk's s3, and the last
// chunk to finish (a ticket of all chunks) builds the sparse table; each
// ticket is left at 0
template <typename T>
__global__ void __launch_bounds__(QK_RM_THREADS)
    qk_range_summary_kernel(const T* __restrict__ x, long long n, int is_min, T* scratch,
                            unsigned int* tickets) {
  __shared__ T warp_v[QK_RM_THREADS / 32];
  __shared__ bool warp_has[QK_RM_THREADS / 32];
  __shared__ bool last;
  const QkSummary<T> S = qk_summary(scratch, n);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long i0 = (long long)blockIdx.x * QK_RM_ROWS + threadIdx.x * QK_RM_ITEMS;
  bool has = i0 < n;
  T v = has ? x[i0] : (T)0;
#pragma unroll
  for (int q = 1; q < QK_RM_ITEMS; ++q)
    if (i0 + q < n) v = qk_minmax(v, x[i0 + q], is_min);
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) qk_fold_lanes(v, has, m, is_min);
  if ((lane & 7) == 0 && has) S.s1[i0 >> 5] = v;
#pragma unroll
  for (int m = 8; m < 32; m <<= 1) qk_fold_lanes(v, has, m, is_min);
  if (lane == 0) {
    warp_v[wid] = v;
    warp_has[wid] = has;
  }
  __syncthreads();
  // warp 0 writes the block's s2 and takes the chunk's ticket; the chunk's
  // last block folds the chunk's s2 into its s3
  const long long nc2 = gridDim.x, c = blockIdx.x >> 5;
  const long long in_chunk = nc2 - c * 32 < 32 ? nc2 - c * 32 : 32;
  if (wid == 0) {
    T u = lane < QK_RM_THREADS / 32 ? warp_v[lane] : (T)0;
    bool uh = lane < QK_RM_THREADS / 32 && warp_has[lane];
#pragma unroll
    for (int m = 1; m < QK_RM_THREADS / 32; m <<= 1) qk_fold_lanes(u, uh, m, is_min);
    bool lst = false;
    if (lane == 0) {
      S.s2[blockIdx.x] = u;
      __threadfence();
      lst = atomicAdd(tickets + c, 1u) == in_chunk - 1;
    }
    if (__shfl_sync(0xffffffffu, lst, 0)) {
      __threadfence();
      uh = lane < in_chunk;
      u = uh ? __ldcg(S.s2 + c * 32 + lane) : (T)0;
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) qk_fold_lanes(u, uh, m, is_min);
      if (lane == 0) {
        S.t[c] = u;
        tickets[c] = 0u;
        __threadfence();
        lst = atomicAdd(tickets + S.nc3, 1u) == S.nc3 - 1;
      }
    }
    if (lane == 0) last = lst;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last chunk to finish: the sparse table over s3 (level 0 written by
  // other blocks, read through L2; each later level by this block, visible
  // to it after the barrier)
  for (long long half = 1; 2 * half <= S.nc3; half <<= 1) {
    const T* prev = S.t + (63 - __clzll(half)) * S.nc3;
    T* cur = (T*)prev + S.nc3;
    for (long long k = threadIdx.x; k < S.nc3; k += blockDim.x)
      cur[k] = k + half < S.nc3 ? qk_minmax(__ldcg(prev + k), __ldcg(prev + k + half), is_min)
                                : __ldcg(prev + k);
    __syncthreads();
  }
  if (threadIdx.x == 0) tickets[S.nc3] = 0u;
}

// acc folded with p[a..b) (a < b), eight independent loads at a time;
// the last batch repeats p[a], which min / max absorb
template <typename T>
__device__ __forceinline__ T qk_fold_run(T acc, const T* __restrict__ p, long long a,
                                         long long b, int is_min) {
  for (long long i = a; i < b; i += 8) {
    T u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = p[i + k < b ? i + k : a];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = qk_minmax(acc, u[k], is_min);
  }
  return acc;
}

// the min / max of x[s..e] (0 <= s <= e < n) from device memory, one
// thread: at each level the pieces at both ends (at most 31 values each)
// and, between full 32768-row chunks, two sparse-table lookups; at most
// 188 reads
template <typename T>
__device__ T qk_range_global(const T* __restrict__ x, const QkSummary<T>& S, long long s,
                             long long e, int is_min) {
  T acc = x[s];
  const long long h0 = (s + 31) & ~31LL, t0 = (e + 1) & ~31LL;  // full 32-row chunks
  if (h0 >= t0) return s < e ? qk_fold_run(acc, x, s + 1, e + 1, is_min) : acc;
  if (s + 1 < h0) acc = qk_fold_run(acc, x, s + 1, h0, is_min);
  if (t0 <= e) acc = qk_fold_run(acc, x, t0, e + 1, is_min);
  const long long h1 = (h0 + 1023) & ~1023LL, t1 = t0 & ~1023LL;  // full 1024-row chunks
  if (h1 >= t1) return qk_fold_run(acc, S.s1, h0 >> 5, t0 >> 5, is_min);
  if (h0 < h1) acc = qk_fold_run(acc, S.s1, h0 >> 5, h1 >> 5, is_min);
  if (t1 < t0) acc = qk_fold_run(acc, S.s1, t1 >> 5, t0 >> 5, is_min);
  const long long h2 = (h1 + 32767) & ~32767LL, t2 = t1 & ~32767LL;  // full 32768-row chunks
  if (h2 >= t2) return qk_fold_run(acc, S.s2, h1 >> 10, t1 >> 10, is_min);
  if (h1 < h2) acc = qk_fold_run(acc, S.s2, h1 >> 10, h2 >> 10, is_min);
  if (t2 < t1) acc = qk_fold_run(acc, S.s2, t2 >> 10, t1 >> 10, is_min);
  const long long c0 = h2 >> 15, c1 = (t2 >> 15) - 1;
  const int k = 63 - __clzll((unsigned long long)(c1 - c0 + 1));
  const T* lvl = S.t + (long long)k * S.nc3;
  return qk_minmax(acc, qk_minmax(lvl[c0], lvl[c1 - (1LL << k) + 1], is_min), is_min);
}

// the min / max of x[s..e] from a staged span starting at row lo whose
// level q (q < nl) at j covers rows lo + j .. lo + j + 2^q - 1, clipped to
// the span
template <typename T>
__device__ __forceinline__ T qk_range_staged(const T* sh, int m, int nl, int lo, int s, int e,
                                             int is_min) {
  int q = 31 - __clz(e - s + 1);
  if (q > nl - 1) q = nl - 1;
  const T* lvl = sh + q * m - lo;
  const int step = 1 << q;
  T acc = lvl[s];
  for (int p = s + step; p + step - 1 < e; p += step) acc = qk_minmax(acc, lvl[p], is_min);
  return qk_minmax(acc, lvl[e - step + 1], is_min);
}

__device__ __forceinline__ long long qk_clamp_ll(long long v, long long n) {
  return v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
}

// a row's ranges, as the reference's sparse-table lookups read them: [l,
// r] when 0 <= l <= r < n; else its two power-of-two blocks, clamped,
// merged where they meet ([sb, eb] empty then)
__device__ __forceinline__ void qk_row_ranges(long long l, long long r, long long n, int levels,
                                              int& sa, int& ea, int& sb, int& eb) {
  sb = 0;
  eb = -1;
  if (0 <= l && l <= r && r < n) {
    sa = (int)l;
    ea = (int)r;
    return;
  }
  long long len = r - l + 1;
  if (len < 1) len = 1;
  int k = 63 - __clzll((unsigned long long)len);
  if (k > levels - 1) k = levels - 1;
  const long long p = 1LL << k;
  long long a0 = qk_clamp_ll(l, n), a1 = a0 + p - 1 < n - 1 ? a0 + p - 1 : n - 1;
  long long b0 = qk_clamp_ll(r - p + 1, n), b1 = b0 + p - 1 < n - 1 ? b0 + p - 1 : n - 1;
  if (b0 <= a1 + 1 && a0 <= b1 + 1) {
    a0 = a0 < b0 ? a0 : b0;
    a1 = a1 > b1 ? a1 : b1;
  } else {
    sb = (int)b0;
    eb = (int)b1;
  }
  sa = (int)a0;
  ea = (int)a1;
}

template <typename T>
__global__ void __launch_bounds__(QK_RM_THREADS)
    qk_range_query_kernel(const T* __restrict__ x, long long n, int levels,
                          const int32_t* __restrict__ left, const int32_t* __restrict__ right,
                          int is_min, T* scratch, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char qk_rm_smem[];
  T* sh = (T*)qk_rm_smem;
  __shared__ int red[3][QK_RM_THREADS / 32];
  const QkSummary<T> S = qk_summary(scratch, n);
  const long long i0 = (long long)blockIdx.x * QK_RM_ROWS + threadIdx.x;
  int lv[QK_RM_ITEMS], rv[QK_RM_ITEMS];
#pragma unroll
  for (int j = 0; j < QK_RM_ITEMS; ++j) {
    const long long i = i0 + j * QK_RM_THREADS;
    lv[j] = i < n ? left[i] : 0;
    rv[j] = i < n ? right[i] : 0;
  }
  // the rows' ranges (ea < sa past the end); the tile's span and its
  // longest range
  int sa[QK_RM_ITEMS], ea[QK_RM_ITEMS], sb[QK_RM_ITEMS], eb[QK_RM_ITEMS];
  int lo = 0x7fffffff, hi = -1, mlen = 0;
#pragma unroll
  for (int j = 0; j < QK_RM_ITEMS; ++j) {
    sa[j] = sb[j] = 0;
    ea[j] = eb[j] = -1;
    if (i0 + j * QK_RM_THREADS >= n) continue;
    qk_row_ranges(lv[j], rv[j], n, levels, sa[j], ea[j], sb[j], eb[j]);
    lo = min(lo, sa[j]);
    hi = max(hi, ea[j]);
    mlen = max(mlen, ea[j] - sa[j] + 1);
    if (eb[j] >= sb[j]) {  // two ranges
      lo = min(lo, sb[j]);
      hi = max(hi, eb[j]);
      mlen = max(mlen, eb[j] - sb[j] + 1);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, m));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, m));
    mlen = max(mlen, __shfl_xor_sync(0xffffffffu, mlen, m));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][wid] = lo;
    red[1][wid] = hi;
    red[2][wid] = mlen;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < QK_RM_THREADS / 32; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
    mlen = max(mlen, red[2][w]);
  }
  const int m = hi - lo + 1;
  const int cap = QK_RM_SMEM / (int)sizeof(T);
  // levels: up to three under the longest range's (about eight lookups a
  // range), as many as fit; staged unless a range would take more than
  // QK_RM_LOOKUPS lookups
  int nl = 32 - __clz(mlen) - 2;
  if (nl < 1) nl = 1;
  if (m <= cap && nl > cap / m) nl = cap / m;
  if (m <= cap && ((mlen - 1) >> (nl - 1)) + 2 <= QK_RM_LOOKUPS) {
    for (int j = threadIdx.x; j < m; j += QK_RM_THREADS)
      __pipeline_memcpy_async(sh + j, x + lo + j, sizeof(T));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int q = 1; q < nl; ++q) {
      const T* prev = sh + (q - 1) * m;
      T* cur = sh + q * m;
      const int half = 1 << (q - 1);
      for (int j = threadIdx.x; j < m; j += QK_RM_THREADS)
        cur[j] = j + half < m ? qk_minmax(prev[j], prev[j + half], is_min) : prev[j];
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < QK_RM_ITEMS; ++j) {
      if (ea[j] < sa[j]) continue;
      T v = qk_range_staged(sh, m, nl, lo, sa[j], ea[j], is_min);
      if (eb[j] >= sb[j]) v = qk_minmax(v, qk_range_staged(sh, m, nl, lo, sb[j], eb[j], is_min),
                                         is_min);
      out[i0 + j * QK_RM_THREADS] = v;
    }
    return;
  }
  // otherwise each row from the summaries
#pragma unroll
  for (int j = 0; j < QK_RM_ITEMS; ++j) {
    if (ea[j] < sa[j]) continue;
    T v = qk_range_global(x, S, sa[j], ea[j], is_min);
    if (eb[j] >= sb[j]) v = qk_minmax(v, qk_range_global(x, S, sb[j], eb[j], is_min), is_min);
    out[i0 + j * QK_RM_THREADS] = v;
  }
}

template <typename T>
static int qk_range_minmax_t(const void* x, long long n, const void* left, const void* right,
                             int is_min, void* scratch, void* tickets, void* out,
                             cudaStream_t st) {
  int levels = 1;  // the reference's table height: 1 + ceil(log2(n))
  while ((1LL << (levels - 1)) < n) ++levels;
  const unsigned int blocks = (unsigned int)((n + QK_RM_ROWS - 1) / QK_RM_ROWS);
  qk_range_summary_kernel<T><<<blocks, QK_RM_THREADS, 0, st>>>((const T*)x, n, is_min,
                                                               (T*)scratch,
                                                               (unsigned int*)tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_range_query_kernel<T><<<blocks, QK_RM_THREADS, QK_RM_SMEM, st>>>(
      (const T*)x, n, levels, (const int32_t*)left, (const int32_t*)right, is_min, (T*)scratch,
      (T*)out);
  return (int)cudaGetLastError();
}

extern "C" {

// t (n rows, dt 0 f64 / 2 i64), seg_start and seg_end (n int32); size as
// the column's type (size_f for f64, size_i for i64); unsorted (one uint32
// of scratch, zeroed here).  left and right (n int32) are outputs.
int qk_window_bounds(const void* t, int dt, const void* seg_start, const void* seg_end,
                     long long n, long long size_i, double size_f, void* unsorted, void* left,
                     void* right, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || (dt != 0 && dt != 2)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(unsorted, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* ss = (const int32_t*)seg_start;
  const int32_t* se = (const int32_t*)seg_end;
  unsigned int* flag = (unsigned int*)unsorted;
  if (dt == 0) {
    qk_window_check_kernel<double><<<blocks, threads, 0, st>>>((const double*)t, ss, se, n, flag);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qk_window_bounds_kernel<double><<<blocks, threads, 0, st>>>(
        (const double*)t, ss, se, n, size_f, flag, (int32_t*)left, (int32_t*)right);
  } else {
    qk_window_check_kernel<long long><<<blocks, threads, 0, st>>>((const long long*)t, ss, se, n,
                                                                  flag);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    qk_window_bounds_kernel<long long><<<blocks, threads, 0, st>>>(
        (const long long*)t, ss, se, n, size_i, flag, (int32_t*)left, (int32_t*)right);
  }
  return (int)cudaGetLastError();
}

// x (n rows, dt 0 f64 / 1 f32 / 2 i64 / 3 i32), left and right (n int32),
// scratch (qk_range_scratch(n) values of x's type), tickets
// (qk_range_tickets(n) uint32, zero, left at zero), out (n values).
int qk_range_minmax(const void* x, int dt, long long n, const void* left, const void* right,
                    int is_min, void* scratch, void* tickets, void* out, void* stream) {
  if (n < 0 || n >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dt) {
    case 0: return qk_range_minmax_t<double>(x, n, left, right, is_min, scratch, tickets, out, st);
    case 1: return qk_range_minmax_t<float>(x, n, left, right, is_min, scratch, tickets, out, st);
    case 2:
      return qk_range_minmax_t<long long>(x, n, left, right, is_min, scratch, tickets, out, st);
    case 3:
      return qk_range_minmax_t<int32_t>(x, n, left, right, is_min, scratch, tickets, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the scratch values of n rows: the 32-row and 1024-row values and the
// sparse table over the 32768-row ones
long long qk_range_scratch(long long n) {
  const long long nc3 = (n + 32767) >> 15;
  int levels = 1;
  while ((1LL << levels) <= nc3) ++levels;
  return ((n + 31) >> 5) + ((n + 1023) >> 10) + nc3 * levels;
}

// the tickets of n rows: one per 32768-row chunk and one for all of them
long long qk_range_tickets(long long n) { return ((n + 32767) >> 15) + 1; }

}  // extern "C"
