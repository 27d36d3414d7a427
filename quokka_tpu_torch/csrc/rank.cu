// K10, the dense rank's pass over the sorted order, and K13p, the
// many-to-many join's plan, for Hopper (sm_90a).
//
// K10 replaces what quokka_tpu/ops/kernels.py:138 `_dense_rank_impl` does
// after its sort: the run test of every limb against the row before in
// the sorted order, the run starts of the valid rows, their cumsum, the
// clamp and the scatter of the ranks back to row order, and `num`.  The
// sort stays a stable torch radix sort on integer order keys
// (ops/kernels.py `lexsort_perm`).  The port's plain version,
// `kernels.dense_rank_plain`, is a gather a limb, a roll, a `!=`, a cumsum,
// a clamp, a sum and a scatter.
//
// K13p replaces quokka_tpu/ops/join.py:220 `_mm_plan` (and, for semi and
// anti joins, its match counts): the dense rank of the probe rows (ids
// below p) and the build rows together, the valid build rows per rank,
// the build rows sorted by (invalid, rank, row), the exclusive cumsum of
// the counts and each probe row's match count.  It is K10's pass in a plan
// mode, then one short fill launch; it runs no sort of its own.  The
// combined sort is stable on the row id, so the valid build rows, read in
// the sorted order, already come in (rank, build row) order: their places
// in that order are the head of build_pos_sorted, and the valid build rows
// before each run's first row are that rank's offset.  The invalid build
// rows all hold rank max(num - 1, 0), so they follow in row order: a
// stable compaction of the build side's invalid rows.  The port's plain
// version is `join._mm_plan_plain`.
//
// What bounds them: bytes, and the latency of the gathers.  Each sorted
// position reads its perm entry once, and gathers the row's validity and
// every limb (rows are scattered, so each gather touches a 32-byte sector
// for one value); the row before a thread's first position is gathered
// once more.  K10 writes one int64 rank a row; K13p writes the probe ranks,
// an offset a rank, the build positions, and the fill writes the offsets
// past num, the match counts and the invalid build rows.
//
// Design: the 4096-row tiles of csrc/compact.cuh, 16 sorted positions a
// thread.  A block takes its tile from an atomic ticket, loads its
// positions' perm entries with 16-byte loads, gathers the validity and
// each limb at them in one unrolled loop a limb (the limb's dtype is
// switched once, outside the loop), and flags the run starts
// (valid & (first position | any limb !=)), so -0.0 and +0.0 share a rank
// and a NaN starts a run of its own, as the reference's `!=` does.  The
// counts (run starts, and in the plan modes valid build rows) are packed in
// one 64-bit word, scanned by shuffles in the warp and across the warps,
// and carried across tiles by a decoupled look-back: a tile publishes its
// aggregate, then walks its predecessors' status words (one warp, windows
// of 32 x QK_RK_LOOK words) to the nearest inclusive prefix and publishes
// its own.  Blocks take tiles in ticket order, so a tile waits only on
// tiles whose blocks already run.  The counts are integers, so every run
// gives the same bits.  The last tile writes num (and the valid build rows,
// and zeroes the total).  The plan's fill launch needs no scan: a block
// writes the offsets at or past num, its probe rows' match counts (the
// counts come from neighbouring offsets), adds them to the total with one
// atomic a block, and places its build tile's invalid rows after the valid
// rows and the invalid rows of the tiles before (whose counts the pass
// left, one word a tile: a block sums the earlier words, as K17's second
// pass does).
//
// Status words, the ticket and the per-tile counts share one scratch; one
// memset a launch zeroes the status words and the ticket.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "search.cuh"

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

__device__ __forceinline__ unsigned long long qk_rk_load(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void qk_rk_store(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

struct QkRankArgs {
  const long long* perm;    // the stable sort's permutation, n entries
  const uint8_t* valid;     // n, row order
  TypedLimbs limbs;         // n rows each, row order
  long long n;
  long long p;              // plan modes: the probe rows (ids below p)
  long long* ranks;         // rank mode: n ranks; plan modes: the p probe ranks
  int* num;
  long long* offsets;       // plan modes: n
  long long* bps;           // plan mode: n - p build positions
  long long* nbv;           // plan modes: [valid build rows, total]
  uint32_t* tail;           // plan mode: the invalid build rows of each build tile
  unsigned long long* status;
  unsigned int* ticket;
  int mode;
};

struct QkRankShared {
  unsigned long long warp[QK_CT_WARPS];
  unsigned long long excl;  // the packed counts of the tiles before
  unsigned long long agg;   // the tile's packed counts
  uint32_t inv[QK_CT_WARPS];
  unsigned int ticket;
};

// bit q: the limb at sorted position q differs (`!=`) from the one before;
// `before` is the row of the position before the thread's first (< 0: none)
template <typename T>
__device__ __forceinline__ uint32_t qk_rk_diff(const void* col,
                                               const long long (&pr)[QK_CT_ITEMS],
                                               long long before, int cnt) {
  const T* a = (const T*)col;
  T prev = before >= 0 ? a[before] : a[pr[0]];
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if (q < cnt) {
      const T x = a[pr[q]];
      if (x != prev) m |= 1u << q;
      prev = x;
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
  if (lane == 0) qk_rk_store(status + k, agg | ((k == 0 ? 2ull : 1ull) << 62));
  unsigned long long acc = 0;
  for (long long j0 = k - 1; j0 >= 0; j0 -= 32 * QK_RK_LOOK) {
    const long long j1 = j0 - (long long)lane * QK_RK_LOOK;
    unsigned long long word[QK_RK_LOOK];
#pragma unroll
    for (int i = 0; i < QK_RK_LOOK; ++i)
      word[i] = j1 - i >= 0 ? qk_rk_load(status + j1 - i) : (2ull << 62);
    unsigned long long add = 0;
    bool stop = false;
#pragma unroll
    for (int i = 0; i < QK_RK_LOOK; ++i) {
      if (stop) break;
      while ((word[i] >> 62) == 0) word[i] = qk_rk_load(status + j1 - i);
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
  if (lane == 0 && k > 0) qk_rk_store(status + k, (acc + agg) | (2ull << 62));
  return acc;
}

// The sorted positions of this thread in tile k: their rows (pr, eight
// 16-byte loads where the thread has all 16), and as bits the run starts
// (valid & (first position | any limb != the one before)) and, in the plan
// modes, the valid build rows among them.  Returns how many it has.
__device__ __forceinline__ int qk_rk_flags(const QkRankArgs& a, long long k,
                                           long long (&pr)[QK_CT_ITEMS], uint32_t* starts,
                                           uint32_t* builds) {
  const long long i0 = k * QK_CT_TILE + (long long)threadIdx.x * QK_CT_ITEMS;
  const long long left = a.n - i0;
  const int cnt = left <= 0 ? 0 : (left < QK_CT_ITEMS ? (int)left : QK_CT_ITEMS);
  if (cnt == QK_CT_ITEMS && (((uintptr_t)(a.perm + i0)) & 15u) == 0) {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; q += 2) {
      const longlong2 v = __ldcs((const longlong2*)(a.perm + i0 + q));
      pr[q] = v.x;
      pr[q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) pr[q] = q < cnt ? a.perm[i0 + q] : 0;
  }
  const long long before = cnt > 0 && i0 > 0 ? a.perm[i0 - 1] : -1;
  uint32_t live = 0, b = 0;
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if (q < cnt && a.valid[pr[q]] != 0) {
      live |= 1u << q;
      if (a.mode != QK_RK_RANK && pr[q] >= a.p) b |= 1u << q;
    }
  }
  uint32_t changed = i0 == 0 ? 1u : 0u;
  if (cnt > 0) {
    for (int j = 0; j < a.limbs.n; ++j) {
      const void* col = a.limbs.p[j];
      switch (a.limbs.dt[j]) {
        case QK_F64: changed |= qk_rk_diff<double>(col, pr, before, cnt); break;
        case QK_F32: changed |= qk_rk_diff<float>(col, pr, before, cnt); break;
        case QK_I64: changed |= qk_rk_diff<long long>(col, pr, before, cnt); break;
        case QK_I32: changed |= qk_rk_diff<int32_t>(col, pr, before, cnt); break;
        default: changed |= qk_rk_diff<uint8_t>(col, pr, before, cnt); break;
      }
    }
  }
  *starts = live & changed;
  *builds = b;
  return cnt;
}

__global__ void __launch_bounds__(QK_CT_THREADS) qk_rank_kernel(QkRankArgs a) {
  __shared__ QkRankShared sh;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) sh.ticket = atomicAdd(a.ticket, 1u);
  __syncthreads();
  const long long k = sh.ticket;
  const long long nt = (a.n + QK_CT_TILE - 1) / QK_CT_TILE;
  const bool plan = a.mode != QK_RK_RANK;
  long long pr[QK_CT_ITEMS];
  uint32_t starts, builds;
  const int cnt = qk_rk_flags(a, k, pr, &starts, &builds);

  // the plan: the invalid build rows of build tile k (rows of the build
  // side, in row order), one word a tile for the fill's compaction
  const long long b = a.n - a.p;
  uint32_t inv = 0;
  if (a.mode == QK_RK_PLAN && k * QK_CT_TILE < b) {
    const long long j0 = k * QK_CT_TILE + (long long)tid * QK_CT_ITEMS;
    for (int q = 0; q < QK_CT_ITEMS && j0 + q < b; ++q) inv += a.valid[a.p + j0 + q] == 0;
  }

  // the thread's packed counts before it in the tile: its warp's, then its lanes'
  const unsigned long long c = qk_rk_pack(__popc(starts), __popc(builds));
  unsigned long long inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) inv += __shfl_xor_sync(0xffffffffu, inv, d);
  if (lane == 31) sh.warp[w] = inc;
  if (lane == 0) sh.inv[w] = inv;
  __syncthreads();
  unsigned long long off = inc - c, agg = 0;
#pragma unroll
  for (int u = 0; u < QK_CT_WARPS; ++u) {
    off += u < w ? sh.warp[u] : 0ull;
    agg += sh.warp[u];
  }
  if (w == 0) {
    const unsigned long long excl = qk_rk_look_back(a.status, k, agg);
    if (lane == 0) {
      sh.excl = excl;
      sh.agg = agg;
      if (a.mode == QK_RK_PLAN && k * QK_CT_TILE < b) {
        uint32_t t = 0;
#pragma unroll
        for (int u = 0; u < QK_CT_WARPS; ++u) t += sh.inv[u];
        a.tail[k] = t;
      }
    }
  }
  __syncthreads();
  const unsigned long long base = sh.excl + off;
  uint32_t r1 = qk_rk_starts(base), r2 = qk_rk_builds(base);
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
// tile): the offsets at or past num, the probe rows' match counts and the
// total (plan mode), and build tile k's invalid rows placed after every
// valid build row and the earlier tiles' invalid rows (plan mode).
__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_mm_fill_kernel(const uint8_t* __restrict__ valid, long long n, long long p,
                      const long long* __restrict__ rp, const int* __restrict__ num_p,
                      long long* offsets, long long* __restrict__ match_count,
                      long long* nbv, long long* __restrict__ bps,
                      const uint32_t* __restrict__ tail, int mode) {
  __shared__ unsigned long long warp_sum[QK_CT_WARPS];
  __shared__ uint32_t warp_cnt[QK_CT_WARPS];
  __shared__ uint32_t before_sh;
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
  if (plan) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
    if (lane == 0) warp_sum[w] = sum;
  }
  const long long b = n - p;
  const bool tile_of_build = plan && lo < b;
  if (tile_of_build && w == 0) {
    // the invalid build rows of the tiles before: one word a tile
    uint32_t t = 0;
    for (long long j = lane; j < k; j += 32) t += tail[j];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) t += __shfl_xor_sync(0xffffffffu, t, d);
    if (lane == 0) before_sh = t;
  }
  // the thread's invalid build rows, in row order
  uint32_t inv = 0;
  const long long j0 = lo + (long long)tid * QK_CT_ITEMS;
  if (tile_of_build) {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q)
      if (j0 + q < b && valid[p + j0 + q] == 0) inv |= 1u << q;
  }
  const uint32_t c = __popc(inv);
  uint32_t inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_cnt[w] = inc;
  __syncthreads();
  if (plan && tid == 0) {
    unsigned long long s = 0;
#pragma unroll
    for (int u = 0; u < QK_CT_WARPS; ++u) s += warp_sum[u];
    if (s != 0ull) atomicAdd((unsigned long long*)(nbv + 1), s);
  }
  if (tile_of_build) {
    uint32_t off = inc - c;
#pragma unroll
    for (int u = 0; u < QK_CT_WARPS; ++u) off += u < w ? warp_cnt[u] : 0u;
    long long pos = nb + (long long)before_sh + off;
    for (uint32_t m = inv; m != 0u; m &= m - 1u) bps[pos++] = j0 + __ffs(m) - 1;
  }
}

extern "C" {

// scratch (uint64 words) of a pass over n sorted positions: a status word
// a tile, the ticket, and a 32-bit count a tile
long long qk_rank_scratch(long long n) {
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE;
  return nt + 1 + (nt + 1) / 2;
}

static int qk_rank_run(QkRankArgs& a, const void* const* limbs, const int* dts, int n_limbs,
                       void* scratch, cudaStream_t st) {
  if (n_limbs < 0 || n_limbs > QK_MAX_LIMBS || a.n < 1 || a.n > 0x7fffffffLL || a.p < 0
      || a.p > a.n)
    return (int)cudaErrorInvalidValue;
  a.limbs.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    if (dts[j] < QK_F64 || dts[j] > QK_BOOL) return (int)cudaErrorInvalidValue;
    a.limbs.p[j] = limbs[j];
    a.limbs.dt[j] = dts[j];
  }
  const long long nt = (a.n + QK_CT_TILE - 1) / QK_CT_TILE;
  a.status = (unsigned long long*)scratch;
  a.ticket = (unsigned int*)(a.status + nt);
  a.tail = (uint32_t*)(a.status + nt + 1);
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (size_t)(nt + 1), st);
  if (err != cudaSuccess) return (int)err;
  qk_rank_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K10: ranks (n int64, row order) and num (one int32) from the stable
// sort's perm (n int64), valid (n bytes) and n_limbs limb arrays of n rows
// (dtypes dts); scratch of qk_rank_scratch(n) words.
int qk_rank(const void* perm, const void* valid, const void* const* limbs, const int* dts,
            int n_limbs, long long n, void* ranks, void* num, void* scratch, void* stream) {
  QkRankArgs a = {};
  a.perm = (const long long*)perm;
  a.valid = (const uint8_t*)valid;
  a.n = n;
  a.ranks = (long long*)ranks;
  a.num = (int*)num;
  a.mode = QK_RK_RANK;
  return qk_rank_run(a, limbs, dts, n_limbs, scratch, (cudaStream_t)stream);
}

// K13p over probe rows 0 .. p - 1 and build rows p .. n - 1: rp (p int64),
// num (one int32), offsets (n int64), match_count (p int64), nbv (two
// int64: the valid build rows, the total) and, with with_bps, bps (n - p
// int64, build_pos_sorted); without it (semi and anti joins) only rp, num,
// match_count and offsets below num are written.  One memset, the pass in
// plan mode, and the fill.
int qk_mm_plan(const void* perm, const void* valid, const void* const* limbs, const int* dts,
               int n_limbs, long long n, long long p, int with_bps, void* rp, void* num,
               void* offsets, void* bps, void* match_count, void* nbv, void* scratch,
               void* stream) {
  QkRankArgs a = {};
  a.perm = (const long long*)perm;
  a.valid = (const uint8_t*)valid;
  a.n = n;
  a.p = p;
  a.ranks = (long long*)rp;
  a.num = (int*)num;
  a.offsets = (long long*)offsets;
  a.bps = (long long*)bps;
  a.nbv = (long long*)nbv;
  a.mode = with_bps ? QK_RK_PLAN : QK_RK_COUNTS;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = qk_rank_run(a, limbs, dts, n_limbs, scratch, st);
  if (err != (int)cudaSuccess) return err;
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE;
  qk_mm_fill_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(
      (const uint8_t*)valid, n, p, (const long long*)rp, (const int*)num, (long long*)offsets,
      (long long*)match_count, (long long*)nbv, (long long*)bps, a.tail, a.mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
