// The sort under K10 and K13p (csrc/rank.cu), for Hopper (sm_90a): a
// range-packed, stable LSD radix sort of the valid rows only.
//
// It replaces the stable torch sorts of ops/kernels.py `lexsort_perm` (one
// a key: the invalid flag, then every limb, each a 64-bit radix sort of
// every row with a gather between keys) for the order of
// quokka_tpu/ops/kernels.py:137 `_dense_rank_impl`'s
// `lax.sort([inv, *limbs, iota])`: valid rows first, then the limbs
// lexicographically (-0.0 equal to +0.0, NaN last), ties in row order,
// then the invalid rows in row order (which `lax.sort` orders by their
// limbs too; no caller reads that order).  The port's plain version is
// `kernels.sort_perm_plain`, `_sort_perm` of the limbs with the invalid
// rows' values masked; the packing itself is modelled in torch by
// `kernels.packed_sort_perm_plain`.
//
// What bounds it: bytes.  Each pass reads and writes every valid row's
// live key words and its 32-bit row id once.  On an H100 each phase runs
// near 1.5 TB/s, about the rate of the card's own CUB radix sort; the gain
// is in the bytes not moved: the padding and invalid rows, the bits above
// the keys' ranges, the 64-bit indices and the gathers between keys.
//
// Design, one C entry and no host read (qk_sort_issue):
// 1. Range pass (a tile of 4096 rows a block): each limb's order key is
//    biased to an unsigned u, and the block's max of u and of ~u over its
//    valid rows go to one atomicMax each; each tile's valid rows are
//    counted.  The last block to finish (a ticket) scans the tiles' counts
//    and writes the plan: the valid rows, and each limb's least u, its
//    width (the bits of its max - min) and its offset, least significant
//    limb at bit 0.  So the key takes the bits its values span, not the
//    dtype's: TPC-H's order key and supplier key (23 and 14 bits at SF1)
//    pack into 37 bits of one word.
// 2. Pack pass, on compact.cuh's tiles: the stable compaction of K8 and
//    K17.  Valid rows go to the front in row order, each with its packed
//    key (as many 64-bit words as the bits need) and its row id; invalid
//    rows go behind them in row order, which is their final place.  The
//    same pass counts every live 8-bit digit of the valid keys into one
//    histogram a digit (shared memory, then one atomic a bucket a block).
//    Its last block marks each digit's pass live unless one bucket holds
//    every valid row, turns the live histograms into bucket starts, and
//    gives each pass the buffer it reads.
// 3. Digit passes, least significant first, over the valid prefix only:
//    a pass whose digit is above the key's bits or constant returns at
//    once.  As many blocks as fit on the card take 4096-row tiles by
//    ticket; a block ranks its tile stably by digit (warp-striped items,
//    peers by nine ballots, one counter a warp and bucket), publishes its
//    256 bucket counts and finds the earlier tiles' by a decoupled
//    look-back (one thread a bucket, QK_SR_LOOK words read at once; the
//    status words carry the pass in their top bits, so one memset serves
//    every pass), then stages the key word it read, the row ids and any
//    other live key word in shared memory in digit order and writes them
//    out in runs.  The host issues the worst case (8 passes a 64-bit word
//    the dtypes could need).
//
// The sorted keys stay in the buffer `final_buf`, the valid prefix sorted
// and the invalid rows' ids in buffer 0 behind it, for K10's pass to read
// in order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"
#include "search.cuh"

#define QK_SR_BUCKETS 256
#define QK_SR_MAX_WORDS 16
#define QK_SR_MAX_DIGITS (QK_SR_MAX_WORDS * 8)
#define QK_SR_TICKETS (3 + QK_SR_MAX_DIGITS)  // range, pack, rank pass, then the digit passes
#define QK_SR_PLAN_WORDS 256
#define QK_SR_LOOK 8  // status words a thread reads at once in a digit pass's look-back

struct QkSortPlan {
  long long n_valid;
  int bits;       // significant bits of the packed key
  int words;      // its live 64-bit words, ceil(bits / 64)
  int final_buf;  // the buffer holding the sorted valid prefix
  int n_digits;
  unsigned long long umin[QK_MAX_LIMBS];  // each limb's least biased key over the valid rows
  int off[QK_MAX_LIMBS];                  // its bit offset in the packed key
  int width[QK_MAX_LIMBS];                // its bits
  int live[QK_SR_MAX_DIGITS];             // the digit's pass moves the keys
  int src[QK_SR_MAX_DIGITS];              // the buffer it reads
};

struct QkSort {
  const uint8_t* valid;
  TypedLimbs limbs;
  long long n;
  int max_words;              // from the dtypes: ceil(sum of their widths / 64)
  unsigned long long* acc;    // [2][16]: max of ~u, max of u
  unsigned int* tickets;      // QK_SR_TICKETS
  unsigned int* hist;         // [8 max_words][256]: counts, then bucket starts
  unsigned long long* sstat;  // [tiles][256] the digit passes' status words
  unsigned long long* rstat;  // [tiles] the rank pass's status words
  QkSortPlan* plan;
  unsigned int* tcount;       // valid rows of each tile, then the valid rows before it
  unsigned int* ids;          // [2][n] row ids
  unsigned long long* keys;   // [2][max_words][n] packed keys
};

__host__ __device__ __forceinline__ int qk_sr_width(int dt) {
  return dt == QK_F64 || dt == QK_I64 ? 64 : (dt == QK_BOOL ? 1 : 32);
}

// the order key of row r biased to unsigned order: -0.0 as +0.0, every NaN
// as one value above +inf, float32 on its own 32-bit key (its order and
// equality are those of the float64 one)
template <int DT>
__device__ __forceinline__ unsigned long long qk_sr_ukey(const void* col, long long r) {
  long long o;
  if (DT == QK_F64) {
    const double x = ((const double*)col)[r];
    const long long b = x == 0.0 ? 0ll : (x != x ? 0x7ff8000000000000ll : __double_as_longlong(x));
    o = b ^ ((b >> 63) & 0x7fffffffffffffffll);
  } else if (DT == QK_F32) {
    const float x = ((const float*)col)[r];
    const int b = x == 0.0f ? 0 : (x != x ? 0x7fc00000 : __float_as_int(x));
    o = (long long)(b ^ ((b >> 31) & 0x7fffffff));
  } else if (DT == QK_I64) {
    o = ((const long long*)col)[r];
  } else if (DT == QK_I32) {
    o = ((const int32_t*)col)[r];
  } else {
    o = ((const uint8_t*)col)[r] != 0;
  }
  return (unsigned long long)o ^ (1ull << 63);
}

__device__ __forceinline__ unsigned long long qk_sr_ukey_dt(const void* col, int dt, long long r) {
  switch (dt) {
    case QK_F64: return qk_sr_ukey<QK_F64>(col, r);
    case QK_F32: return qk_sr_ukey<QK_F32>(col, r);
    case QK_I64: return qk_sr_ukey<QK_I64>(col, r);
    case QK_I32: return qk_sr_ukey<QK_I32>(col, r);
    default: return qk_sr_ukey<QK_BOOL>(col, r);
  }
}

__device__ __forceinline__ unsigned long long qk_sr_load(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void qk_sr_store(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// the thread's 16 rows from i0 (cnt of them) as bits: valid and nonzero
__device__ __forceinline__ uint32_t qk_sr_valid_bits(const uint8_t* v, long long i0, int cnt) {
  uint32_t m = 0;
  if (cnt == QK_CT_ITEMS && (((uintptr_t)(v + i0)) & 15u) == 0) {
    const uint4 x = *(const uint4*)(v + i0);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q)
      if ((w[q >> 2] >> (8 * (q & 3))) & 0xffu) m |= 1u << q;
  } else {
    for (int q = 0; q < cnt; ++q)
      if (v[i0 + q] != 0) m |= 1u << q;
  }
  return m;
}

// exclusive block scan of one value a thread (QK_CT_THREADS threads); wsh
// holds QK_CT_WARPS words; every thread gets the total
__device__ __forceinline__ uint32_t qk_sr_scan(uint32_t v, uint32_t* wsh, uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  __syncthreads();  // wsh may still be read by an earlier scan
  if (lane == 31) wsh[w] = inc;
  __syncthreads();
  uint32_t off = 0, tot = 0;
#pragma unroll
  for (int u = 0; u < QK_CT_WARPS; ++u) {
    off += u < w ? wsh[u] : 0u;
    tot += wsh[u];
  }
  *total = tot;
  return off + inc - v;
}

// the lanes whose 9-bit label equals this lane's, by one ballot a bit
// (faster than __match_any_sync)
__device__ __forceinline__ uint32_t qk_sr_match(uint32_t label) {
  uint32_t m = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const bool bit = (label >> b) & 1u;
    const uint32_t v = __ballot_sync(0xffffffffu, bit);
    m &= bit ? v : ~v;
  }
  return m;
}

__device__ __forceinline__ unsigned long long qk_sr_max64(unsigned long long v) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, v, d);
    v = y > v ? y : v;
  }
  return v;
}

template <int DT>
__device__ __forceinline__ void qk_sr_range_rows(const void* col, long long i0, uint32_t live,
                                                 unsigned long long* hi,
                                                 unsigned long long* lo) {
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    if ((live >> q) & 1u) {
      const unsigned long long u = qk_sr_ukey<DT>(col, i0 + q);
      *hi = u > *hi ? u : *hi;
      *lo = ~u > *lo ? ~u : *lo;
    }
  }
}

// 1. Range pass: each limb's max of u and of ~u over the valid rows, each
// tile's valid rows; the last block writes the plan.
__global__ void __launch_bounds__(QK_CT_THREADS) qk_sort_range_kernel(QkSort s) {
  __shared__ unsigned long long red[2][QK_CT_WARPS];
  __shared__ uint32_t wsh[QK_CT_WARPS];
  __shared__ uint32_t carry;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long k = blockIdx.x, nt = gridDim.x;
  const long long i0 = k * QK_CT_TILE + (long long)tid * QK_CT_ITEMS;
  const long long left = s.n - i0;
  const int cnt = left <= 0 ? 0 : (left < QK_CT_ITEMS ? (int)left : QK_CT_ITEMS);
  const uint32_t live = cnt > 0 ? qk_sr_valid_bits(s.valid, i0, cnt) : 0u;
  uint32_t tile_valid;
  qk_sr_scan(__popc(live), wsh, &tile_valid);
  for (int j = 0; j < s.limbs.n; ++j) {
    unsigned long long hi = 0, lo = 0;
    const void* col = s.limbs.p[j];
    switch (s.limbs.dt[j]) {
      case QK_F64: qk_sr_range_rows<QK_F64>(col, i0, live, &hi, &lo); break;
      case QK_F32: qk_sr_range_rows<QK_F32>(col, i0, live, &hi, &lo); break;
      case QK_I64: qk_sr_range_rows<QK_I64>(col, i0, live, &hi, &lo); break;
      case QK_I32: qk_sr_range_rows<QK_I32>(col, i0, live, &hi, &lo); break;
      default: qk_sr_range_rows<QK_BOOL>(col, i0, live, &hi, &lo); break;
    }
    hi = qk_sr_max64(hi);
    lo = qk_sr_max64(lo);
    if (lane == 0) {
      red[0][w] = hi;
      red[1][w] = lo;
    }
    __syncthreads();
    if (tid == 0 && tile_valid > 0) {
#pragma unroll
      for (int u = 1; u < QK_CT_WARPS; ++u) {
        hi = red[0][u] > hi ? red[0][u] : hi;
        lo = red[1][u] > lo ? red[1][u] : lo;
      }
      atomicMax(s.acc + QK_MAX_LIMBS + j, hi);
      atomicMax(s.acc + j, lo);
    }
    __syncthreads();
  }
  if (tid == 0) s.tcount[k] = tile_valid;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(s.tickets + 0, 1u) == (unsigned int)(nt - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the valid rows before each tile, then the plan
  if (tid == 0) carry = 0;
  for (long long b0 = 0; b0 < nt; b0 += QK_CT_THREADS) {
    const long long t = b0 + tid;
    const uint32_t v = t < nt ? __ldcg(s.tcount + t) : 0u;
    uint32_t tot;
    const uint32_t ex = qk_sr_scan(v, wsh, &tot);
    const uint32_t c0 = carry;
    if (t < nt) s.tcount[t] = c0 + ex;
    __syncthreads();
    if (tid == 0) carry = c0 + tot;
  }
  __syncthreads();
  if (tid == 0) {
    QkSortPlan* P = s.plan;
    const long long nv = carry;
    int off = 0;
    for (int j = s.limbs.n - 1; j >= 0; --j) {
      const unsigned long long umin = ~__ldcg(s.acc + j);
      const unsigned long long span = __ldcg(s.acc + QK_MAX_LIMBS + j) - umin;
      const int width = nv == 0 || span == 0 ? 0 : 64 - __clzll((long long)span);
      P->umin[j] = umin;
      P->off[j] = off;
      P->width[j] = width;
      off += width;
    }
    P->n_valid = nv;
    P->bits = off;
    P->words = (off + 63) / 64;
    P->n_digits = (off + 7) / 8;
  }
}

// word w of the packed key of row r (plan in shared memory)
__device__ __forceinline__ unsigned long long qk_sr_word(const TypedLimbs& L,
                                                         const unsigned long long* umin,
                                                         const int* off, const int* width,
                                                         int w, long long r) {
  unsigned long long word = 0;
  const int lo = 64 * w, hi = lo + 64;
  for (int j = 0; j < L.n; ++j) {
    const int o = off[j], b = width[j];
    if (b == 0 || o >= hi || o + b <= lo) continue;
    const unsigned long long v = qk_sr_ukey_dt(L.p[j], L.dt[j], r) - umin[j];
    word |= o >= lo ? v << (o - lo) : v >> (lo - o);
  }
  return word;
}

// 2. Pack pass: the stable compaction (valid rows to the front with their
// keys, invalid rows behind in row order) and the digits' histograms; the
// last block turns them into bucket starts and marks the live passes.
__global__ void __launch_bounds__(QK_CT_THREADS) qk_sort_pack_kernel(QkSort s) {
  __shared__ uint32_t h[8][QK_SR_BUCKETS];
  __shared__ uint32_t stage[QK_CT_TILE];
  __shared__ uint32_t wsh[QK_CT_WARPS];
  __shared__ unsigned long long umin[QK_MAX_LIMBS];
  __shared__ int off[QK_MAX_LIMBS], width[QK_MAX_LIMBS];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long k = blockIdx.x, nt = gridDim.x, n = s.n;
  QkSortPlan* P = s.plan;
  const long long nv = P->n_valid;
  const int bits = P->bits, words = P->words;
  if (tid < s.limbs.n) {
    umin[tid] = P->umin[tid];
    off[tid] = P->off[tid];
    width[tid] = P->width[tid];
  }
  const long long i0 = k * QK_CT_TILE + (long long)tid * QK_CT_ITEMS;
  const long long left = n - i0;
  const int cnt = left <= 0 ? 0 : (left < QK_CT_ITEMS ? (int)left : QK_CT_ITEMS);
  const uint32_t live = cnt > 0 ? qk_sr_valid_bits(s.valid, i0, cnt) : 0u;
  uint32_t tile_valid;
  const uint32_t ex = qk_sr_scan(__popc(live), wsh, &tile_valid);
  const long long before = s.tcount[k];  // valid rows of the tiles before
  // the tile's rows in their stable order, staged: the valid rows, then
  // the invalid ones
  {
    uint32_t vp = ex, ip = tile_valid + (uint32_t)tid * QK_CT_ITEMS - ex;
    for (int q = 0; q < cnt; ++q) {
      if ((live >> q) & 1u) stage[vp++] = (uint32_t)(i0 + q);
      else stage[ip++] = (uint32_t)(i0 + q);
    }
  }
  __syncthreads();  // the stage, and the plan's copy in shared memory
  // written out in runs: the valid rows after the earlier tiles' valid
  // rows, the invalid ones after every valid row and the earlier tiles'
  // invalid rows
  const int tile_rows = n - k * QK_CT_TILE < QK_CT_TILE ? (int)(n - k * QK_CT_TILE) : QK_CT_TILE;
  const long long ibase = nv + (k * QK_CT_TILE - before) - (long long)tile_valid;
  for (int i = tid; i < tile_rows; i += QK_CT_THREADS)
    s.ids[((uint32_t)i < tile_valid ? before : ibase) + i] = stage[i];
  for (int w = 0; w < words; ++w) {
    for (int u = tid; u < 8 * QK_SR_BUCKETS; u += QK_CT_THREADS) (&h[0][0])[u] = 0;
    __syncthreads();
    // the thread's valid rows i = tid, tid + 256, ...: neighbouring rows
    // across the warp, so the limbs' loads and the keys' stores coalesce.
    // Each digit's counts go in as runs of equal digits: a key's high
    // digits rarely change from row to row (TPC-H lineitem comes in
    // order-key order), and one counter hit by every row would serialize
    uint32_t cur[8], run[8];
#pragma unroll
    for (int dd = 0; dd < 8; ++dd) {
      cur[dd] = 0;
      run[dd] = 0;
    }
    for (int i = tid; (uint32_t)i < tile_valid; i += QK_CT_THREADS) {
      const unsigned long long word = qk_sr_word(s.limbs, umin, off, width, w, stage[i]);
      s.keys[(size_t)w * n + before + i] = word;
#pragma unroll
      for (int dd = 0; dd < 8; ++dd) {
        const uint32_t dig = (uint32_t)(word >> (8 * dd)) & 0xffu;
        if (dig != cur[dd] && run[dd] != 0u) {
          atomicAdd(&h[dd][cur[dd]], run[dd]);
          run[dd] = 0;
        }
        cur[dd] = dig;
        ++run[dd];
      }
    }
#pragma unroll
    for (int dd = 0; dd < 8; ++dd)
      if (run[dd] != 0u && 64 * w + 8 * dd < bits) atomicAdd(&h[dd][cur[dd]], run[dd]);
    __syncthreads();
    for (int u = tid; u < 8 * QK_SR_BUCKETS; u += QK_CT_THREADS) {
      const int dd = u / QK_SR_BUCKETS;
      const uint32_t c = (&h[0][0])[u];
      if (c != 0u && 64 * w + 8 * dd < bits)
        atomicAdd(s.hist + (size_t)(8 * w + dd) * QK_SR_BUCKETS + (u % QK_SR_BUCKETS), c);
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(s.tickets + 1, 1u) == (unsigned int)(nt - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: a digit's pass is live unless one bucket holds every
  // valid row; its counts become bucket starts; each pass reads the
  // buffer the last live pass before it wrote
  const int nd = P->n_digits;
  int buf = 0;
  for (int d = 0; d < nd; ++d) {
    unsigned int* hd = s.hist + (size_t)d * QK_SR_BUCKETS;
    const uint32_t c = __ldcg(hd + tid);
    const bool dead = __syncthreads_or(c == (uint32_t)nv);
    if (!dead) {
      uint32_t tot;
      hd[tid] = qk_sr_scan(c, wsh, &tot);
    }
    if (tid == 0) {
      P->live[d] = !dead;
      P->src[d] = buf;
    }
    buf ^= dead ? 0 : 1;
  }
  for (int d = nd + tid; d < 8 * s.max_words; d += QK_CT_THREADS) P->live[d] = 0;
  if (tid == 0) P->final_buf = buf;
}

struct QkDigitShared {
  uint32_t cnt[QK_CT_WARPS][QK_SR_BUCKETS];  // each warp's rows a bucket, then their offset
  uint32_t lstart[QK_SR_BUCKETS];             // the bucket's first place in the tile
  uint32_t gbase[QK_SR_BUCKETS];              // its first place in the output
  uint8_t dig[QK_CT_TILE];                    // the bucket of each staged place
  unsigned long long stage[QK_CT_TILE];
  uint32_t wsh[QK_CT_WARPS];
  unsigned int ticket;
};

// The valid rows of tile k under digit d: its key word holding the digit,
// the shift of the digit in it, and the tile's rows.
struct QkDigitTile {
  const unsigned long long* kd;
  int word;
  int shift;
  int tcnt;
  long long base;
};

__device__ __forceinline__ QkDigitTile qk_sr_tile(const QkSort& s, int d, int src, long long nv,
                                                  long long k) {
  QkDigitTile t;
  t.base = k * QK_CT_TILE;
  t.tcnt = nv - t.base < QK_CT_TILE ? (int)(nv - t.base) : QK_CT_TILE;
  t.word = d >> 3;
  t.kd = s.keys + (size_t)src * s.max_words * s.n + (size_t)t.word * s.n + t.base;
  t.shift = (d & 7) * 8;
  return t;
}

// Ranks the tile stably by the digit: item q of lane l is the tile's row
// w 512 + 32 q + l, so the rounds run in row order and each warp's counter
// of a bucket stays stable.  Leaves in sh.cnt each warp's offset in each
// bucket and in sh.lstart each bucket's first place in the tile; returns
// bucket tid's rows in the tile.  pos: each item's rank among its warp's
// items of its bucket; dg: its digit.
__device__ __forceinline__ uint32_t qk_sr_rank_tile(QkDigitShared& sh, const QkDigitTile& t,
                                                    uint32_t (&pos)[QK_CT_ITEMS],
                                                    uint32_t (&dg)[QK_CT_ITEMS]) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t lt = (1u << lane) - 1u;
  for (int u = tid; u < QK_CT_WARPS * QK_SR_BUCKETS; u += QK_CT_THREADS) (&sh.cnt[0][0])[u] = 0;
  __syncthreads();
  // the digits first, so the loads overlap; the key words that hold them
  // stay in the stage, in row order, for the scatter
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    const int idx = w * (32 * QK_CT_ITEMS) + q * 32 + lane;
    const unsigned long long x = idx < t.tcnt ? t.kd[idx] : 0ull;
    sh.stage[idx] = x;
    dg[q] = idx < t.tcnt ? (uint32_t)((x >> t.shift) & 0xffu) : QK_SR_BUCKETS;
  }
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    const uint32_t dig = dg[q];
    const bool ok = dig < QK_SR_BUCKETS;
    const uint32_t peers = qk_sr_match(dig);
    const uint32_t below = __popc(peers & lt);
    const uint32_t seen = ok ? sh.cnt[w][dig] : 0u;
    __syncwarp();
    if (ok && below == 0u) sh.cnt[w][dig] = seen + __popc(peers);
    __syncwarp();
    pos[q] = seen + below;
  }
  __syncthreads();
  // bucket tid: the warps' offsets in it, its rows in the tile, its start
  uint32_t run = 0;
#pragma unroll
  for (int u = 0; u < QK_CT_WARPS; ++u) {
    const uint32_t v = sh.cnt[u][tid];
    sh.cnt[u][tid] = run;
    run += v;
  }
  uint32_t tot;
  sh.lstart[tid] = qk_sr_scan(run, sh.wsh, &tot);
  return run;
}

// Writes the tile out once sh.gbase holds each bucket's first place in the
// output: the key word the rank read (from the stage, where the rank left
// it), the ids, then any other live key word, each through the stage in
// digit order, so each bucket's rows go out in one run.
__device__ __forceinline__ void qk_sr_scatter_tile(QkDigitShared& sh, const QkSort& s, int src,
                                                   int words, const QkDigitTile& t,
                                                   uint32_t (&pos)[QK_CT_ITEMS],
                                                   const uint32_t (&dg)[QK_CT_ITEMS]) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long n = s.n;
  const size_t plane = (size_t)s.max_words * n;
  const unsigned long long* kin = s.keys + src * plane;
  unsigned long long* kout = s.keys + (src ^ 1) * plane;
  const unsigned int* iin = s.ids + src * n;
  unsigned int* iout = s.ids + (src ^ 1) * n;
  __syncthreads();
  // each row's place in the tile, in digit order, and the rank's key word
  unsigned long long x[QK_CT_ITEMS];
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q) {
    const int idx = w * (32 * QK_CT_ITEMS) + q * 32 + lane;
    x[q] = sh.stage[idx];
    if (idx < t.tcnt) {
      pos[q] += sh.lstart[dg[q]] + sh.cnt[w][dg[q]];
      sh.dig[pos[q]] = (uint8_t)dg[q];
    }
  }
  __syncthreads();
  // a = -2: that word; -1: the ids; then the other words
  for (int a = -2; a < words; ++a) {
    if (a == t.word) continue;
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) {
      const int idx = w * (32 * QK_CT_ITEMS) + q * 32 + lane;
      if (idx < t.tcnt)
        sh.stage[pos[q]] = a == -2 ? x[q]
                           : a == -1 ? (unsigned long long)iin[t.base + idx]
                                     : kin[(size_t)a * n + t.base + idx];
    }
    __syncthreads();
    const size_t out = (size_t)(a == -2 ? t.word : a) * n;
#pragma unroll
    for (int j = 0; j < QK_CT_ITEMS; ++j) {
      const int i = tid + j * QK_CT_THREADS;
      if (i < t.tcnt) {
        const uint32_t b = sh.dig[i];
        const uint32_t dst = sh.gbase[b] + (uint32_t)i - sh.lstart[b];
        if (a == -1) iout[dst] = (unsigned int)sh.stage[i];
        else kout[out + dst] = sh.stage[i];
      }
    }
    __syncthreads();
  }
}

// 3. One digit pass over the valid prefix: tile k (by ticket) ranked stably
// by the digit, its bucket counts carried across tiles by a look-back, the
// ids and live key words written out through the stage.
__global__ void __launch_bounds__(QK_CT_THREADS) qk_sort_digit_kernel(QkSort s, int d) {
  __shared__ QkDigitShared sh;
  const QkSortPlan* P = s.plan;
  if (!P->live[d]) return;
  const int tid = threadIdx.x;
  const long long nv = P->n_valid;
  const long long ntl = (nv + QK_CT_TILE - 1) / QK_CT_TILE;
  const int src = P->src[d], words = P->words;
  const unsigned long long ep = (unsigned long long)(d + 1) << 34;
  // as many blocks as fit on the card, each taking tiles by ticket
  for (;;) {
    if (tid == 0) sh.ticket = atomicAdd(s.tickets + 3 + d, 1u);
    sh.gbase[tid] = s.hist[(size_t)d * QK_SR_BUCKETS + tid];
    __syncthreads();
    const long long k = sh.ticket;
    if (k >= ntl) return;
    const QkDigitTile t = qk_sr_tile(s, d, src, nv, k);
    uint32_t pos[QK_CT_ITEMS], dg[QK_CT_ITEMS];
    const uint32_t run = qk_sr_rank_tile(sh, t, pos, dg);
    // the look-back: status word = count | state << 32 | (d + 1) << 34,
    // state 1 the tile's count, 2 the inclusive count of tiles 0 .. k;
    // QK_SR_LOOK earlier tiles' words are read at once, then taken in
    // order up to the first inclusive count (tile 0 publishes one at once)
    unsigned long long* st = s.sstat + (size_t)k * QK_SR_BUCKETS + tid;
    qk_sr_store(st, run | ((k == 0 ? 2ull : 1ull) << 32) | ep);
    uint32_t acc = 0;
    if (k > 0) {
      const unsigned long long ready = ep | (2ull << 32);  // stands for "before tile 0"
      bool stop = false;
      for (long long j0 = k - 1; !stop; j0 -= QK_SR_LOOK) {
        unsigned long long v[QK_SR_LOOK];
#pragma unroll
        for (int i = 0; i < QK_SR_LOOK; ++i)
          v[i] = j0 - i >= 0 ? qk_sr_load(s.sstat + (size_t)(j0 - i) * QK_SR_BUCKETS + tid)
                             : ready;
#pragma unroll
        for (int i = 0; i < QK_SR_LOOK; ++i) {
          if (stop) break;
          while ((v[i] >> 34) != (unsigned long long)(d + 1) || ((v[i] >> 32) & 3ull) == 0ull)
            v[i] = qk_sr_load(s.sstat + (size_t)(j0 - i) * QK_SR_BUCKETS + tid);
          acc += (uint32_t)v[i];
          stop = ((v[i] >> 32) & 3ull) == 2ull;
        }
      }
      qk_sr_store(st, (acc + run) | (2ull << 32) | ep);
    }
    sh.gbase[tid] += acc;
    qk_sr_scatter_tile(sh, s, src, words, t, pos, dg);  // ends with __syncthreads
  }
}

// the sort's permutation (int64): the sorted valid prefix, then buffer 0's
// invalid rows
__global__ void qk_sort_perm_kernel(QkSort s, long long* __restrict__ perm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.n) return;
  const QkSortPlan* P = s.plan;
  perm[i] = i < P->n_valid ? s.ids[P->final_buf * s.n + i] : s.ids[i];
}

// 64-bit words the packed key may need, from the dtypes
static inline int qk_sr_max_words(const int* dts, int n_limbs) {
  int bits = 0;
  for (int j = 0; j < n_limbs; ++j) bits += qk_sr_width(dts[j]);
  return (bits + 63) / 64;
}

static inline long long qk_sr_tiles(long long n) { return (n + QK_CT_TILE - 1) / QK_CT_TILE; }

// scratch (uint64 words): zeroed first (acc, tickets, histograms, status
// words), then the plan, the tile counts, the ids and the keys
static inline long long qk_sr_zeroed(long long n, int max_words) {
  const long long nt = qk_sr_tiles(n);
  return 2 * QK_MAX_LIMBS + (QK_SR_TICKETS + 1) / 2 + (long long)max_words * 8 * QK_SR_BUCKETS / 2
         + nt * QK_SR_BUCKETS + nt;
}

static inline long long qk_sr_scratch(long long n, int max_words) {
  const long long nt = qk_sr_tiles(n);
  return qk_sr_zeroed(n, max_words) + QK_SR_PLAN_WORDS + (nt + 1) / 2 + n
         + 2 * (long long)max_words * n;
}

// points s's arrays into scratch; checks the limbs
static inline int qk_sr_layout(QkSort& s, const void* valid, const void* const* limbs,
                               const int* dts, int n_limbs, long long n, void* scratch) {
  if (n_limbs < 0 || n_limbs > QK_MAX_LIMBS || n < 1 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  s.valid = (const uint8_t*)valid;
  s.limbs.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    if (dts[j] < QK_F64 || dts[j] > QK_BOOL) return (int)cudaErrorInvalidValue;
    s.limbs.p[j] = limbs[j];
    s.limbs.dt[j] = dts[j];
  }
  s.n = n;
  s.max_words = qk_sr_max_words(dts, n_limbs);
  const long long nt = qk_sr_tiles(n);
  unsigned long long* w = (unsigned long long*)scratch;
  s.acc = w;
  w += 2 * QK_MAX_LIMBS;
  s.tickets = (unsigned int*)w;
  w += (QK_SR_TICKETS + 1) / 2;
  s.hist = (unsigned int*)w;
  w += (long long)s.max_words * 8 * QK_SR_BUCKETS / 2;
  s.sstat = w;
  w += nt * QK_SR_BUCKETS;
  s.rstat = w;
  w += nt;
  s.plan = (QkSortPlan*)w;
  w += QK_SR_PLAN_WORDS;
  s.tcount = (unsigned int*)w;
  w += (nt + 1) / 2;
  s.ids = (unsigned int*)w;
  w += n;
  s.keys = w;
  return 0;
}

// the memset and the range and pack passes
static inline int qk_sort_prepare(QkSort& s, cudaStream_t st) {
  static_assert(sizeof(QkSortPlan) <= 8 * QK_SR_PLAN_WORDS, "plan");
  const long long nt = qk_sr_tiles(s.n);
  cudaError_t err =
      cudaMemsetAsync(s.acc, 0, 8 * (size_t)qk_sr_zeroed(s.n, s.max_words), st);
  if (err != cudaSuccess) return (int)err;
  qk_sort_range_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(s);
  qk_sort_pack_kernel<<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(s);
  return (int)cudaGetLastError();
}

// the whole sort: then every digit pass the dtypes may need, on one stream
// with no host read
static inline int qk_sort_issue(QkSort& s, cudaStream_t st) {
  const int err = qk_sort_prepare(s, st);
  if (err != 0) return err;
  // a digit pass's blocks: as many as fit on the card at once, at most a
  // tile each (a pass that is not live then returns in a few us)
  static int fit[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_sort_digit_kernel,
                                                                  QK_CT_THREADS, 0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    fit[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const long long nt = qk_sr_tiles(s.n);
  const unsigned int grid = (unsigned int)(nt < fit[dev] ? nt : fit[dev]);
  for (int d = 0; d < 8 * s.max_words; ++d)
    qk_sort_digit_kernel<<<grid, QK_CT_THREADS, 0, st>>>(s, d);
  return (int)cudaGetLastError();
}
