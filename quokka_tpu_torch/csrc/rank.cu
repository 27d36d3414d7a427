// K10, the dense rank, and K13p, the many-to-many join's plan, for Hopper
// (sm_90a): the sort of csrc/sort.cuh, then one pass over the sorted keys.
//
// K10 replaces quokka_tpu/ops/kernels.py:138 `_dense_rank_impl`: the
// stable sort (valid rows first, the limbs, the row id), the run test of
// every limb against the row before in the sorted order, the run starts of
// the valid rows, their cumsum, the clamp and the scatter of the ranks back
// to row order, and `num`.  The port's plain version,
// `kernels.dense_rank_plain`, is `_sort_perm` (stable torch sorts), a
// gather a limb, a roll, a `!=`, a cumsum, a clamp, a sum and a scatter.
//
// K13p replaces quokka_tpu/ops/join.py:220 `_mm_plan` (and, for semi and
// anti joins, its match counts): the dense rank of the probe rows (ids
// below p) and the build rows together, the valid build rows per rank,
// the build rows sorted by (invalid, rank, row), the exclusive cumsum of
// the counts and each probe row's match count.  It is the same sort and
// pass in a plan mode, then one short fill launch.  The sort is stable on
// the row id, so the valid build rows, read in the sorted order, already
// come in (rank, build row) order: their places in that order are the head
// of build_pos_sorted, and the valid build rows before each run's first
// row are that rank's offset.  The invalid build rows all hold rank
// max(num - 1, 0) and the sort left every invalid row behind the valid
// ones in row order, probe rows first, so the invalid build rows are the
// sorted order's last positions and land at the same place less p.  The
// port's plain version is `join._mm_plan_plain`.
//
// What bounds them: bytes.  After the sort the pass reads each sorted
// position's row id and live key words once, in order, and gathers only
// float limbs (a NaN starts a run of its own, which the packed key, where
// NaNs are equal, cannot show).  K10 writes one int64 rank a row, scattered
// to its row; K13p writes the probe ranks, an offset a rank and the build
// positions, and the fill writes the offsets past num, the match counts
// and their total.
//
// Design: the 4096-row tiles of csrc/compact.cuh, 16 sorted positions a
// thread.  A block takes its tile from an atomic ticket, flags the run
// starts (position < the valid rows & (first position | key != the one
// before | a float limb is NaN)), so -0.0 and +0.0 share a rank and a NaN
// starts a run of its own, as the reference's `!=` does.  The counts (run
// starts, and in the plan modes valid build rows) are packed in one 64-bit
// word, scanned by shuffles in the warp and across the warps, and carried
// across tiles by a decoupled look-back: a tile publishes its aggregate,
// then walks its predecessors' status words (one warp, windows of 32 x
// QK_RK_LOOK words) to the nearest inclusive prefix and publishes its own.
// Blocks take tiles in ticket order, so a tile waits only on tiles whose
// blocks already run.  The counts are integers, so every run gives the
// same bits.  The last tile writes num (and the valid build rows, and
// zeroes the total).  The plan's fill launch needs no scan: a block writes
// the offsets at or past num and its probe rows' match counts (the counts
// come from neighbouring offsets), and adds them to the total with one
// atomic a block.
//
// The sort's buffers, its plan, every status word and ticket share one
// scratch; one memset a call zeroes what must start at zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "search.cuh"
#include "sort.cuh"

#define QK_RK_LOOK 2  // status words a lane reads a step of the look-back
#define QK_RK_MASK31 0x7fffffffull
#define QK_RK_VALUE ((1ull << 62) - 1)  // the two counts of a status word

enum { QK_RK_RANK = 0, QK_RK_PLAN = 1, QK_RK_COUNTS = 2 };

// two counts in one word: run starts in bits 0-30, valid build rows in
// bits 31-61 (each below 2^31, so packed words add without a carry)
__host__ __device__ __forceinline__ unsigned long long qk_rk_pack(uint32_t starts,
                                                                 uint32_t builds) {
  return ((unsigned long long)builds << 31) | (unsigned long long)starts;
}

__device__ __forceinline__ uint32_t qk_rk_starts(unsigned long long v) {
  return (uint32_t)(v & QK_RK_MASK31);
}

__device__ __forceinline__ uint32_t qk_rk_builds(unsigned long long v) {
  return (uint32_t)((v >> 31) & QK_RK_MASK31);
}

struct QkRankArgs {
  QkSort s;                 // the sorted keys and ids, the plan, the scratch
  long long p;              // plan modes: the probe rows (ids below p)
  long long* ranks;         // rank mode: n ranks; plan modes: the p probe ranks
  int* num;
  long long* offsets;       // plan modes: n
  long long* bps;           // plan mode: n - p build positions
  long long* nbv;           // plan modes: [valid build rows, total]
  int mode;
};

struct QkRankShared {
  unsigned long long warp[QK_CT_WARPS];
  unsigned long long excl;  // the packed counts of the tiles before
  unsigned long long agg;   // the tile's packed counts
  unsigned int ticket;
};

// bit q: the float limb is NaN at the row of sorted position q (valid only)
template <typename T>
__device__ __forceinline__ uint32_t qk_rk_nan(const void* col, const long long (&pr)[QK_CT_ITEMS],
                                              uint32_t live) {
  const T* a = (const T*)col;
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if ((live >> q) & 1u) {
      const T x = a[pr[q]];
      if (x != x) m |= 1u << q;
    }
  }
  return m;
}

// Tile k's look-back, by one whole warp: publishes agg, the tile's packed
// counts, and returns the packed counts of tiles 0 .. k - 1, then
// publishes its inclusive prefix.  Lane l reads tiles j0 - l L, j0 - l L
// - 1, ... (L = QK_RK_LOOK) up to the first inclusive prefix; before tile
// 0 stands an empty inclusive prefix.  State in bits 62-63: 1 aggregate,
// 2 inclusive prefix, 0 not published yet.
__device__ __forceinline__ unsigned long long qk_rk_look_back(unsigned long long* status,
                                                              long long k,
                                                              unsigned long long agg) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) qk_sr_store(status + k, agg | ((k == 0 ? 2ull : 1ull) << 62));
  unsigned long long acc = 0;
  for (long long j0 = k - 1; j0 >= 0; j0 -= 32 * QK_RK_LOOK) {
    const long long j1 = j0 - (long long)lane * QK_RK_LOOK;
    unsigned long long word[QK_RK_LOOK];
#pragma unroll
    for (int i = 0; i < QK_RK_LOOK; ++i)
      word[i] = j1 - i >= 0 ? qk_sr_load(status + j1 - i) : (2ull << 62);
    unsigned long long add = 0;
    bool stop = false;
#pragma unroll
    for (int i = 0; i < QK_RK_LOOK; ++i) {
      if (stop) break;
      while ((word[i] >> 62) == 0) word[i] = qk_sr_load(status + j1 - i);
      add += word[i] & QK_RK_VALUE;
      stop = (word[i] >> 62) == 2;
    }
    // the lanes in window order, up to the first that met an inclusive prefix
    const unsigned hit = __ballot_sync(0xffffffffu, stop);
    if (hit != 0u && lane > __ffs(hit) - 1) add = 0;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) add += __shfl_xor_sync(0xffffffffu, add, d);
    acc += add;
    if (hit != 0u) break;
  }
  if (lane == 0 && k > 0) qk_sr_store(status + k, (acc + agg) | (2ull << 62));
  return acc;
}

// The sorted positions of this thread in tile k: their rows (pr) and as
// bits the run starts (valid & (first position | key != the one before |
// a float limb NaN)) and, in the plan modes, the valid build rows among
// them.  Returns how many it has.
__device__ __forceinline__ int qk_rk_flags(const QkRankArgs& a, long long nv, int fbuf,
                                           int words, long long k, long long (&pr)[QK_CT_ITEMS],
                                           uint32_t* starts, uint32_t* builds) {
  const QkSort& s = a.s;
  const long long n = s.n;
  const long long i0 = k * QK_CT_TILE + (long long)threadIdx.x * QK_CT_ITEMS;
  const long long left = n - i0;
  const int cnt = left <= 0 ? 0 : (left < QK_CT_ITEMS ? (int)left : QK_CT_ITEMS);
  // sorted valid rows in the final buffer, the invalid rows in buffer 0
  const unsigned int* fin = s.ids + (size_t)fbuf * n;
  // all 16 from one buffer, aligned: four 16-byte loads
  const unsigned int* from = i0 + QK_CT_ITEMS <= nv ? fin + i0 : (i0 >= nv ? s.ids + i0 : nullptr);
  if (cnt == QK_CT_ITEMS && from != nullptr && (((uintptr_t)from) & 15u) == 0) {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; q += 4) {
      const uint4 v = __ldcs((const uint4*)(from + q));
      pr[q] = v.x;
      pr[q + 1] = v.y;
      pr[q + 2] = v.z;
      pr[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) {
      const long long i = i0 + q;
      pr[q] = q < cnt ? (long long)(i < nv ? fin[i] : s.ids[i]) : 0;
    }
  }
  uint32_t live = 0, b = 0;
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if (q < cnt && i0 + q < nv) {
      live |= 1u << q;
      if (a.mode != QK_RK_RANK && pr[q] >= a.p) b |= 1u << q;
    }
  }
  uint32_t changed = i0 == 0 ? 1u : 0u;
  if (live != 0u) {
    const unsigned long long* keys = s.keys + (size_t)fbuf * s.max_words * n;
    for (int w = 0; w < words; ++w) {
      const unsigned long long* kw = keys + (size_t)w * n;
      unsigned long long x[QK_CT_ITEMS];
      if (live == 0xffffu && (((uintptr_t)(kw + i0)) & 15u) == 0) {
#pragma unroll
        for (int q = 0; q < QK_CT_ITEMS; q += 2) {
          const longlong2 v = __ldcs((const longlong2*)(kw + i0 + q));
          x[q] = (unsigned long long)v.x;
          x[q + 1] = (unsigned long long)v.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < QK_CT_ITEMS; ++q) x[q] = (live >> q) & 1u ? kw[i0 + q] : 0ull;
      }
      unsigned long long prev = kw[i0 > 0 ? i0 - 1 : 0];
#pragma unroll
      for (int q = 0; q < QK_CT_ITEMS; ++q) {
        if ((live >> q) & 1u) {
          if (x[q] != prev) changed |= 1u << q;
          prev = x[q];
        }
      }
    }
    for (int j = 0; j < s.limbs.n; ++j) {
      if (s.limbs.dt[j] == QK_F64) changed |= qk_rk_nan<double>(s.limbs.p[j], pr, live);
      else if (s.limbs.dt[j] == QK_F32) changed |= qk_rk_nan<float>(s.limbs.p[j], pr, live);
    }
  }
  *starts = live & changed;
  *builds = b;
  return cnt;
}

__global__ void __launch_bounds__(QK_CT_THREADS) qk_rank_kernel(QkRankArgs a) {
  __shared__ QkRankShared sh;
  const long long nv = a.s.plan->n_valid;
  const int fbuf = a.s.plan->final_buf, words = a.s.plan->words;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) sh.ticket = atomicAdd(a.s.tickets + 2, 1u);
  __syncthreads();
  const long long k = sh.ticket, n = a.s.n;
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE;
  const bool plan = a.mode != QK_RK_RANK;
  long long pr[QK_CT_ITEMS];
  uint32_t starts, builds;
  const int cnt = qk_rk_flags(a, nv, fbuf, words, k, pr, &starts, &builds);

  // the thread's packed counts before it in the tile: its warp's, then its lanes'
  const unsigned long long c = qk_rk_pack(__popc(starts), __popc(builds));
  unsigned long long inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh.warp[w] = inc;
  __syncthreads();
  unsigned long long off = inc - c, agg = 0;
#pragma unroll
  for (int u = 0; u < QK_CT_WARPS; ++u) {
    off += u < w ? sh.warp[u] : 0ull;
    agg += sh.warp[u];
  }
  if (w == 0) {
    const unsigned long long excl = qk_rk_look_back(a.s.rstat, k, agg);
    if (lane == 0) {
      sh.excl = excl;
      sh.agg = agg;
    }
  }
  __syncthreads();
  const unsigned long long base = sh.excl + off;
  uint32_t r1 = qk_rk_starts(base), r2 = qk_rk_builds(base);
  const long long i0 = k * QK_CT_TILE + (long long)tid * QK_CT_ITEMS;
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if (q < cnt) {
      const bool st = (starts >> q) & 1u;
      r1 += st ? 1u : 0u;
      const long long rank = r1 > 0 ? (long long)r1 - 1 : 0;
      const long long row = pr[q];
      if (!plan) {
        a.ranks[row] = rank;
      } else {
        if (row < a.p) a.ranks[row] = rank;
        if (st) a.offsets[rank] = r2;
        if ((builds >> q) & 1u) {
          if (a.mode == QK_RK_PLAN) a.bps[r2] = row - a.p;
          ++r2;
        }
        // an invalid build row: the sorted order's tail, in row order
        if (a.mode == QK_RK_PLAN && i0 + q >= nv && row >= a.p)
          a.bps[i0 + q - a.p] = row - a.p;
      }
    }
  }
  if (k == nt - 1 && tid == 0) {
    const unsigned long long all = sh.excl + sh.agg;
    *a.num = (int)qk_rk_starts(all);
    if (plan) {
      a.nbv[0] = qk_rk_builds(all);
      a.nbv[1] = 0;
    }
  }
}

// The plan's fill, block k over rows [k T, (k + 1) T) of each range (T the
// tile): the offsets at or past num (plan mode), the probe rows' match
// counts and the total.
__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_mm_fill_kernel(const uint8_t* __restrict__ valid, long long n, long long p,
                      const long long* __restrict__ rp, const int* __restrict__ num_p,
                      long long* offsets, long long* __restrict__ match_count,
                      long long* nbv, int mode) {
  __shared__ unsigned long long warp_sum[QK_CT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long k = blockIdx.x;
  const long long lo = k * QK_CT_TILE;
  const long long num = *num_p;
  const long long nb = nbv[0];
  const bool plan = mode == QK_RK_PLAN;
  if (plan) {
    const long long hi = lo + QK_CT_TILE < n ? lo + QK_CT_TILE : n;
    for (long long r = (lo > num ? lo : num) + tid; r < hi; r += QK_CT_THREADS) offsets[r] = nb;
  }
  // a rank below num has its offset from the pass; its count is the next
  // rank's offset (or the valid build rows, past the last rank) less it
  unsigned long long sum = 0;
  {
    const long long hi = lo + QK_CT_TILE < p ? lo + QK_CT_TILE : p;
    for (long long q = lo + tid; q < hi; q += QK_CT_THREADS) {
      long long m = 0;
      if (valid[q] != 0) {
        const long long r = rp[q];
        m = (r + 1 < num ? offsets[r + 1] : nb) - offsets[r];
      }
      match_count[q] = m;
      sum += (unsigned long long)m;
    }
  }
  if (!plan) return;
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
  if (lane == 0) warp_sum[w] = sum;
  __syncthreads();
  if (tid == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int u = 0; u < QK_CT_WARPS; ++u) s += warp_sum[u];
    if (s != 0ull) atomicAdd((unsigned long long*)(nbv + 1), s);
  }
}

extern "C" {

// scratch (uint64 words) of a call over n rows with these limb dtypes
long long qk_rank_scratch(long long n, const int* dts, int n_limbs) {
  return qk_sr_scratch(n, qk_sr_max_words(dts, n_limbs));
}

// The sort alone: perm (n int64), the sorted order of valid (n bytes) and
// n_limbs limb arrays of n rows (dtypes dts); scratch of
// qk_rank_scratch(n, dts, n_limbs) words.
int qk_sort_perm(const void* valid, const void* const* limbs, const int* dts, int n_limbs,
                 long long n, void* perm, void* scratch, void* stream) {
  QkSort s = {};
  int err = qk_sr_layout(s, valid, limbs, dts, n_limbs, n, scratch);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  err = qk_sort_issue(s, st);
  if (err != 0) return err;
  qk_sort_perm_kernel<<<(unsigned int)((n + 255) / 256), 256, 0, st>>>(s, (long long*)perm);
  return (int)cudaGetLastError();
}

static int qk_rank_run(QkRankArgs& a, const void* valid, const void* const* limbs,
                       const int* dts, int n_limbs, long long n, void* scratch,
                       cudaStream_t st) {
  if (a.p < 0 || a.p > n) return (int)cudaErrorInvalidValue;
  int err = qk_sr_layout(a.s, valid, limbs, dts, n_limbs, n, scratch);
  if (err != 0) return err;
  err = qk_sort_issue(a.s, st);
  if (err != 0) return err;
  qk_rank_kernel<<<(unsigned int)qk_sr_tiles(n), QK_CT_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K10: ranks (n int64, row order) and num (one int32) of valid (n bytes)
// and n_limbs limb arrays of n rows (dtypes dts); scratch of
// qk_rank_scratch(n, dts, n_limbs) words.  The sort, then the pass.
int qk_rank(const void* valid, const void* const* limbs, const int* dts, int n_limbs,
            long long n, void* ranks, void* num, void* scratch, void* stream) {
  QkRankArgs a = {};
  a.ranks = (long long*)ranks;
  a.num = (int*)num;
  a.mode = QK_RK_RANK;
  return qk_rank_run(a, valid, limbs, dts, n_limbs, n, scratch, (cudaStream_t)stream);
}

// K13p over probe rows 0 .. p - 1 and build rows p .. n - 1: rp (p int64),
// num (one int32), offsets (n int64), match_count (p int64), nbv (two
// int64: the valid build rows, the total) and, with with_bps, bps (n - p
// int64, build_pos_sorted); without it (semi and anti joins) only rp, num,
// match_count and offsets below num are written.  The sort, the pass in
// plan mode, and the fill.
int qk_mm_plan(const void* valid, const void* const* limbs, const int* dts, int n_limbs,
               long long n, long long p, int with_bps, void* rp, void* num, void* offsets,
               void* bps, void* match_count, void* nbv, void* scratch, void* stream) {
  QkRankArgs a = {};
  a.p = p;
  a.ranks = (long long*)rp;
  a.num = (int*)num;
  a.offsets = (long long*)offsets;
  a.bps = (long long*)bps;
  a.nbv = (long long*)nbv;
  a.mode = with_bps ? QK_RK_PLAN : QK_RK_COUNTS;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = qk_rank_run(a, valid, limbs, dts, n_limbs, n, scratch, st);
  if (err != (int)cudaSuccess) return err;
  qk_mm_fill_kernel<<<(unsigned int)qk_sr_tiles(n), QK_CT_THREADS, 0, st>>>(
      (const uint8_t*)valid, n, p, (const long long*)rp, (const int*)num, (long long*)offsets,
      (long long*)match_count, (long long*)nbv, a.mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
