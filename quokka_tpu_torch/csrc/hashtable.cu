// Hash group-by (K3) and the PK-join build and probe (K11) for Hopper
// (sm_90a).
//
// K3 replaces quokka_tpu/ops/hashtable.py:310 `_hash_groupby_body` (its
// _insert_body lockstep while_loop, the cumulative sum over occupied slots
// and kernels._segment_aggs_body).  K11 replaces build_table's insert
// (hashtable.py:348) and `_probe_body` (hashtable.py:236).
//
// What bounds K3 on this card: bytes, and at the query shapes the launches.
// The function must read every row's validity byte, the keys and
// aggregate inputs of the live rows, and write its n-long outputs (counts,
// smallest row, one array per aggregate); 2^21-row Q3 calls hold a few
// thousand live rows, so the outputs and the table dominate, and a 256-row
// recombine (Q1) is a handful of microseconds of launches.  The earlier
// design spent most of a call on the host: a blocking read of the
// convergence flag, a dozen torch ops building int32 key limbs, a cumulative
// sum over the table in int64 and one fill per output.
//
// Design: the host only launches.  One C call issues four device
// operations on two allocations (outputs; scratch with the table):
//  1. a memset of the scratch's counters and the table (EMPTY is 0: a slot
//     holds its claiming row + 1);
//  2. `qk_gb_insert_kernel`: a thread per live row reads its key columns in
//     their own types (int64, int32, float64, float32), canonicalises -0.0
//     to +0.0 in registers and hashes the words; a row with a NaN key mixes
//     its row id into the hash and joins no other row (its own group, as
//     the reference's NaN companion limb makes it).  It walks its probe
//     sequence (double hash, odd stride) and claims an EMPTY slot with
//     atomicCAS or joins the slot whose claimer's keys equal its own.
//     Claims are never undone, equal keys share one probe sequence and the
//     table has cap >= 2n slots (capbits_for), so a live row finds an empty
//     slot or its own key within cap probes: the insert cannot fail while
//     cap > n, and no host read is needed.  A row that exhausts the walk
//     (only a table patched to cap <= n) sets `failed`, which the wrapper
//     reads only then;
//  3. `qk_gb_rank_kernel`: each block counts the occupied slots of 4096
//     table slots, overwrites each with its rank inside the block, and the
//     last block to finish (an integer ticket after a __threadfence) scans
//     the block counts in order into block offsets and writes the group
//     count: ranks follow slot order, so a run is reproducible;
//  4. `qk_gb_segment_kernel`, a cooperative launch of at most as many blocks
//     as the card keeps resident: it writes every output's identity, meets
//     the grid at a barrier, adds each live row into its group (counts and
//     integer sums with atomicAdd, the smallest row with atomicMin, min /
//     max of floats with compare-and-swap loops, NaN propagating as XLA's
//     segment_min / max), meets the grid again, and finishes `mean` (sum /
//     count), `first` (the input at the smallest row) and the float sums
//     over the groups.  Float sums and means are the same bits every run:
//     a pass before the adds (and a barrier) takes each group's largest
//     exponent and its NaN / infinity flags, and each value is added as a
//     128-bit fixed-point integer at that exponent (two 64-bit atomicAdds,
//     the carry from the low word counted into the high one), which no
//     order of the adds can change; the finish rounds the integer to the
//     output type.  A float atomicAdd's sum depends on the order the
//     blocks reach it, and a query that compares a sum with the max of
//     the same sums collected by another run (TPC-H Q15) needs the bits.
//     Each aggregate's type and op select a template instance once per
//     column and tile of 1024 rows; rows are a block's contiguous range.
// `qk_segment_ranked` runs step 4 alone over given ranks (the sort
// group-by's and the keyless aggregates').  The scratch's layout is this
// file's alone: the wrapper asks `qk_gb_scratch` for its size.
//
// K11 keeps the int32-limb insert and probe of the earlier design: a build
// inserts canonical limbs once (`qk_insert_kernel`) and each probe row walks
// to its key or an EMPTY slot (`qk_probe_kernel`).

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_LIMBS 16
#define QK_EMPTY 0x7fffffff

// ---------------------------------------------------------------------------
// K11: PK-join build and probe over canonical int32 limbs
// ---------------------------------------------------------------------------

struct Limbs {
  const int32_t* p[QK_MAX_LIMBS];
  int n;
};

__device__ __forceinline__ uint32_t qk_hash(const Limbs& L, int64_t i) {
  uint32_t h = 0x9747B28Cu;
  for (int j = 0; j < L.n; ++j) {
    h = (h ^ (uint32_t)L.p[j][i]) * 0x9E3779B1u;
    h ^= h >> 16;
  }
  h = (h ^ (h >> 13)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 16)) * 0xC2B2AE35u;
  return h;
}

__global__ void qk_insert_kernel(Limbs L, const uint8_t* __restrict__ valid, int64_t n,
                                 int32_t* table, uint32_t mask, int32_t* failed) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  uint32_t h = qk_hash(L, i);
  uint32_t slot = (h ^ (h >> 15)) & mask;
  uint32_t stride = ((h >> 7) | 1u) & mask;  // odd: visits every slot
  uint64_t cap = (uint64_t)mask + 1;
  for (uint64_t probe = 0; probe < 2 * cap; ++probe) {
    int32_t prev = atomicCAS(&table[slot], QK_EMPTY, (int32_t)i);
    if (prev == QK_EMPTY) return;
    bool eq = true;
    for (int j = 0; j < L.n; ++j) {
      if (L.p[j][prev] != L.p[j][i]) {
        eq = false;
        break;
      }
    }
    if (eq) return;
    slot = (slot + stride) & mask;
  }
  atomicExch(failed, 1);
}

__global__ void qk_probe_kernel(Limbs B, Limbs P, const uint8_t* __restrict__ ok,
                                int64_t p, const int32_t* __restrict__ table,
                                uint32_t mask, int64_t nb,
                                int32_t* __restrict__ build_idx,
                                uint8_t* __restrict__ matched) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  int32_t res = 0;
  bool hit = false;
  if (ok[i]) {
    uint32_t h = qk_hash(P, i);
    uint32_t slot = (h ^ (h >> 15)) & mask;
    uint32_t stride = ((h >> 7) | 1u) & mask;
    uint64_t cap = (uint64_t)mask + 1;
    for (uint64_t probe = 0; probe < cap; ++probe) {
      int32_t e = table[slot];
      if (e == QK_EMPTY) break;
      bool eq = true;
      for (int j = 0; j < P.n; ++j) {
        if (B.p[j][e] != P.p[j][i]) {
          eq = false;
          break;
        }
      }
      if (eq) {
        res = e;
        hit = true;
        break;
      }
      slot = (slot + stride) & mask;
    }
  }
  build_idx[i] = (int32_t)(res < 0 ? 0 : (res > nb - 1 ? nb - 1 : res));
  matched[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// K3: the group-by
// ---------------------------------------------------------------------------

#define QK_GB_MAX_KEYS 16
#define QK_GB_MAX_COLS 32
#define QK_GB_THREADS 256
#define QK_GB_RANK_ITEMS 16  // table slots per thread of the rank scan
#define QK_GB_RANK_SHIFT 12  // log2(QK_GB_THREADS * QK_GB_RANK_ITEMS)
#define QK_GB_ITEMS 4        // rows per thread and tile of the segment pass
#define QK_GB_TILE (QK_GB_THREADS * QK_GB_ITEMS)

enum { QK_F64 = 0, QK_F32 = 1, QK_I64 = 2, QK_I32 = 3 };
enum { QK_SUM = 0, QK_COUNT = 1, QK_MIN = 2, QK_MAX = 3, QK_MEAN = 4, QK_FIRST = 5 };

struct GbKeys {
  const void* p[QK_GB_MAX_KEYS];
  int dt[QK_GB_MAX_KEYS];
  int n;
};

// an aggregate column: kind = op * 4 + input type.  `acc` is where a mean
// sums (the output itself for float inputs; int64 / int32 scratch for
// integer inputs, whose mean is float32, as torch's true division gives).
// `fx` is a float sum's or mean's fixed-point scratch (null for the other
// columns) over n groups: the high and low words (n uint64 each), the
// largest biased exponent (n int32) and the NaN / +inf / -inf flags (n
// int32), in that order
struct GbCols {
  const void* in[QK_GB_MAX_COLS];
  void* out[QK_GB_MAX_COLS];
  void* acc[QK_GB_MAX_COLS];
  void* fx[QK_GB_MAX_COLS];
  int kind[QK_GB_MAX_COLS];
  int k;
  int any_fx;  // some column has fixed-point scratch
};

struct GbSeg {
  GbCols C;
  const uint8_t* valid;
  long long n;
  // ranks: slots (myslot, in-block ranks, block offsets) or a given array;
  // a float sum's exponent pass overwrites each live row's slot with its
  // rank, which the add pass then reads
  int32_t* myslot;
  const int32_t* local;
  const int32_t* boff;
  const void* ranks;
  int32_t* counts;
  int32_t* rep;
  const int32_t* num;  // the group count on the device, or null: n
  unsigned int* bar;   // zeroed before the launch
  int finish;          // some column is a mean, a first or a float sum
};

// one key word, canonical: -0.0 as +0.0; sets nan for a NaN
__device__ __forceinline__ uint64_t qk_key_word(const GbKeys& K, int j, long long i, bool& nan) {
  switch (K.dt[j]) {
    case QK_F64: {
      double v = ((const double*)K.p[j])[i];
      nan |= v != v;
      return v == 0.0 ? 0ull : (uint64_t)__double_as_longlong(v);
    }
    case QK_F32: {
      float v = ((const float*)K.p[j])[i];
      nan |= v != v;
      return v == 0.0f ? 0ull : (uint64_t)__float_as_uint(v);
    }
    case QK_I64: return (uint64_t)((const long long*)K.p[j])[i];
    default: return (uint64_t)(uint32_t)((const int32_t*)K.p[j])[i];
  }
}

__device__ __forceinline__ uint32_t qk_mix(uint32_t h, uint32_t w) {
  h = (h ^ w) * 0x9E3779B1u;
  return h ^ (h >> 16);
}

__global__ void __launch_bounds__(QK_GB_THREADS)
    qk_gb_insert_kernel(GbKeys K, const uint8_t* __restrict__ valid, long long n,
                        int32_t* table, uint32_t mask, int32_t* __restrict__ myslot,
                        int32_t* failed) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  uint64_t w[QK_GB_MAX_KEYS];
  bool nan = false;
  uint32_t h = 0x9747B28Cu;
#pragma unroll
  for (int j = 0; j < QK_GB_MAX_KEYS; ++j) {
    if (j < K.n) {
      w[j] = qk_key_word(K, j, i, nan);
      h = qk_mix(qk_mix(h, (uint32_t)w[j]), (uint32_t)(w[j] >> 32));
    }
  }
  if (nan) h = qk_mix(h, (uint32_t)i);  // its own group: spread NaN rows
  h = (h ^ (h >> 13)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 16)) * 0xC2B2AE35u;
  uint32_t slot = (h ^ (h >> 15)) & mask;
  const uint32_t stride = ((h >> 7) | 1u) & mask;  // odd: visits every slot
  for (uint64_t probe = 0; probe <= mask; ++probe) {
    const int32_t prev = atomicCAS(&table[slot], 0, (int32_t)(i + 1));
    if (prev == 0) {
      myslot[i] = (int32_t)slot;
      return;
    }
    if (!nan) {
      const long long o = prev - 1;
      bool eq = true, other_nan = false;
#pragma unroll
      for (int j = 0; j < QK_GB_MAX_KEYS; ++j)
        if (j < K.n && eq) eq = qk_key_word(K, j, o, other_nan) == w[j];
      if (eq) {
        myslot[i] = (int32_t)slot;
        return;
      }
    }
    slot = (slot + stride) & mask;
  }
  myslot[i] = -1;
  atomicExch(failed, 1);
}

// inclusive scan of v over the block; total gets the block's sum
__device__ __forceinline__ int qk_block_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < QK_GB_THREADS / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < QK_GB_THREADS / 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < QK_GB_THREADS / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  const int res = x + (wid ? warp_tot[wid - 1] : 0);
  total = warp_tot[QK_GB_THREADS / 32 - 1];
  __syncthreads();
  return res;
}

// hdr[0] = the group count, hdr[1] = the insert's failed flag
__global__ void __launch_bounds__(QK_GB_THREADS)
    qk_gb_rank_kernel(int32_t* table, long long cap, int32_t* bcount, unsigned int* ticket,
                      const int32_t* failed, int32_t* hdr) {
  __shared__ int warp_tot[QK_GB_THREADS / 32];
  __shared__ bool last;
  const long long s0 =
      ((long long)blockIdx.x << QK_GB_RANK_SHIFT) + (long long)threadIdx.x * QK_GB_RANK_ITEMS;
  int32_t e[QK_GB_RANK_ITEMS];
  if (s0 + QK_GB_RANK_ITEMS <= cap) {
#pragma unroll
    for (int q = 0; q < QK_GB_RANK_ITEMS / 4; ++q) {
      const int4 v = ((const int4*)(table + s0))[q];
      e[4 * q] = v.x;
      e[4 * q + 1] = v.y;
      e[4 * q + 2] = v.z;
      e[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < QK_GB_RANK_ITEMS; ++q) e[q] = s0 + q < cap ? table[s0 + q] : 0;
  }
  int c = 0;
#pragma unroll
  for (int q = 0; q < QK_GB_RANK_ITEMS; ++q) c += e[q] != 0;
  int total;
  int r = qk_block_scan(c, warp_tot, total) - c;
#pragma unroll
  for (int q = 0; q < QK_GB_RANK_ITEMS; ++q)
    if (e[q] != 0) table[s0 + q] = r++;
  if (threadIdx.x == 0) bcount[blockIdx.x] = total;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: block counts to offsets, in block order
  int run = 0;
  for (long long b0 = 0; b0 < gridDim.x; b0 += QK_GB_THREADS) {
    const long long b = b0 + threadIdx.x;
    const int v = b < gridDim.x ? __ldcg(bcount + b) : 0;
    int tot;
    const int inc = qk_block_scan(v, warp_tot, tot);
    if (b < gridDim.x) bcount[b] = run + inc - v;
    run += tot;
  }
  if (threadIdx.x == 0) {
    hdr[0] = run;
    hdr[1] = *(volatile const int32_t*)failed;
  }
}

// a grid-wide barrier of a cooperative launch (every block resident); the
// k-th barrier of a launch waits for k * gridDim.x arrivals
__device__ __forceinline__ void qk_grid_barrier(unsigned int* bar, unsigned int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned int want = k * gridDim.x;
    while (*(volatile unsigned int*)bar < want) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T qk_ident_min();
template <> __device__ __forceinline__ double qk_ident_min<double>() { return __longlong_as_double(0x7ff0000000000000LL); }
template <> __device__ __forceinline__ float qk_ident_min<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ long long qk_ident_min<long long>() { return 0x7fffffffffffffffLL; }
template <> __device__ __forceinline__ int32_t qk_ident_min<int32_t>() { return 0x7fffffff; }
template <typename T>
__device__ __forceinline__ T qk_ident_max();
template <> __device__ __forceinline__ double qk_ident_max<double>() { return __longlong_as_double(0xfff0000000000000LL); }
template <> __device__ __forceinline__ float qk_ident_max<float>() { return __int_as_float(0xff800000); }
template <> __device__ __forceinline__ long long qk_ident_max<long long>() { return (long long)0x8000000000000000ULL; }
template <> __device__ __forceinline__ int32_t qk_ident_max<int32_t>() { return (int32_t)0x80000000u; }

__device__ __forceinline__ void qk_atomic_add(double* a, double v) { atomicAdd(a, v); }
__device__ __forceinline__ void qk_atomic_add(float* a, float v) { atomicAdd(a, v); }
__device__ __forceinline__ void qk_atomic_add(long long* a, long long v) {
  atomicAdd((unsigned long long*)a, (unsigned long long)v);
}
__device__ __forceinline__ void qk_atomic_add(int32_t* a, int32_t v) { atomicAdd(a, v); }

// min / max with NaN propagating: a compare-and-swap loop on the bits
__device__ __forceinline__ void qk_atomic_minmax(double* addr, double v, bool is_min) {
  unsigned long long* a = (unsigned long long*)addr;
  unsigned long long old = *(volatile unsigned long long*)a;
  while (true) {
    const double cur = __longlong_as_double((long long)old);
    double nv;
    if (cur != cur || v != v) nv = __longlong_as_double(0x7ff8000000000000LL);
    else nv = is_min ? (v < cur ? v : cur) : (v > cur ? v : cur);
    const unsigned long long nb = (unsigned long long)__double_as_longlong(nv);
    if (nb == old) return;
    const unsigned long long prev = atomicCAS(a, old, nb);
    if (prev == old) return;
    old = prev;
  }
}
__device__ __forceinline__ void qk_atomic_minmax(float* addr, float v, bool is_min) {
  unsigned int* a = (unsigned int*)addr;
  unsigned int old = *(volatile unsigned int*)a;
  while (true) {
    const float cur = __uint_as_float(old);
    float nv;
    if (cur != cur || v != v) nv = __uint_as_float(0x7fc00000u);
    else nv = is_min ? (v < cur ? v : cur) : (v > cur ? v : cur);
    const unsigned int nb = __float_as_uint(nv);
    if (nb == old) return;
    const unsigned int prev = atomicCAS(a, old, nb);
    if (prev == old) return;
    old = prev;
  }
}
__device__ __forceinline__ void qk_atomic_minmax(long long* a, long long v, bool is_min) {
  if (is_min) atomicMin(a, v);
  else atomicMax(a, v);
}
__device__ __forceinline__ void qk_atomic_minmax(int32_t* a, int32_t v, bool is_min) {
  if (is_min) atomicMin(a, v);
  else atomicMax(a, v);
}

template <typename T> struct QkMeanOut { typedef T type; };
template <> struct QkMeanOut<long long> { typedef float type; };
template <> struct QkMeanOut<int32_t> { typedef float type; };

// float sums and means in fixed point: a finite nonzero x is
// +-M * 2^(E - 1075) with M < 2^53 and E its biased exponent (1 for a
// subnormal, whose M has no implicit bit).  Added at its group's largest E
// as M * 2^(E - Emax + QK_FX_SHIFT), below 2^90, so that up to 2^31 rows
// cannot overflow the 128 bits; a value more than QK_FX_SHIFT binades
// below the group's largest loses the bits under 2^-90 of it
#define QK_FX_SHIFT 37
#define QK_FX_NONE (-1)
template <typename T> struct QkFx { enum { on = 0 }; };
template <> struct QkFx<double> { enum { on = 1 }; };
template <> struct QkFx<float> { enum { on = 1 }; };

struct QkFxCol {
  unsigned long long* hi;
  unsigned long long* lo;
  int32_t* emax;
  int32_t* flags;  // 1 NaN, 2 +inf, 4 -inf
};

__device__ __forceinline__ QkFxCol qk_fx_col(const GbCols& C, int a, long long n) {
  QkFxCol F;
  F.hi = (unsigned long long*)C.fx[a];
  F.lo = F.hi + n;
  F.emax = (int32_t*)(F.lo + n);
  F.flags = F.emax + n;
  return F;
}

// x's biased exponent (0 for zero), or a flag for NaN / infinity
__device__ __forceinline__ int qk_fx_exp(double x, int& flag) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  const int e = (int)((b >> 52) & 0x7ff);
  flag = 0;
  if (e == 0x7ff) {
    flag = (b & 0xfffffffffffffull) ? 1 : ((b >> 63) ? 4 : 2);
    return 0;
  }
  if (e == 0) return (b & 0xfffffffffffffull) ? 1 : 0;
  return e;
}

// add finite x at its group's largest exponent emax
__device__ __forceinline__ void qk_fx_add(const QkFxCol& F, long long g, double x, int emax) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  const int e = (int)((b >> 52) & 0x7ff);
  const unsigned long long frac = b & 0xfffffffffffffull;
  const unsigned long long m = e ? (frac | (1ull << 52)) : frac;
  if (m == 0) return;
  const int s = (e ? e : 1) - emax + QK_FX_SHIFT;  // at most QK_FX_SHIFT
  unsigned long long hi, lo;
  if (s >= 0) {
    lo = m << s;
    hi = s ? m >> (64 - s) : 0ull;
  } else {
    lo = -s < 64 ? m >> -s : 0ull;
    hi = 0ull;
  }
  if (b >> 63) {  // two's complement of the 128 bits
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
  const unsigned long long old = atomicAdd(F.lo + g, lo);
  hi += (old + lo < old) ? 1ull : 0ull;  // the low word's carry
  if (hi) atomicAdd(F.hi + g, hi);
}

// the group's sum rounded to a double
__device__ __forceinline__ double qk_fx_value(const QkFxCol& F, long long g) {
  const int fl = F.flags[g];
  if ((fl & 1) || (fl & 6) == 6) return __longlong_as_double(0x7ff8000000000000LL);
  if (fl & 2) return __longlong_as_double(0x7ff0000000000000LL);
  if (fl & 4) return __longlong_as_double(0xfff0000000000000LL);
  const int emax = F.emax[g];
  if (emax == QK_FX_NONE) return 0.0;
  unsigned long long hi = F.hi[g], lo = F.lo[g];
  const bool neg = hi >> 63;
  if (neg) {
    lo = ~lo + 1ull;
    hi = ~hi + (lo == 0ull ? 1ull : 0ull);
  }
  const double mag = (double)hi * 18446744073709551616.0 + (double)lo;
  const double v = ldexp(mag, emax - 1075 - QK_FX_SHIFT);
  return neg ? -v : v;
}

// every output's identity over [g0, n) in steps of `step`
// (a float sum's or mean's fixed-point scratch over the m groups, and its
// output's identity past them: the finish writes the m groups' outputs)
template <typename T, int OP>
__device__ __forceinline__ void qk_fill_col(const GbCols& C, int a, long long n, long long m,
                                            long long g0, long long step) {
  if (QkFx<T>::on && (OP == QK_SUM || OP == QK_MEAN)) {
    const QkFxCol F = qk_fx_col(C, a, n);
    for (long long g = g0; g < n; g += step) {
      if (g < m) {
        F.hi[g] = F.lo[g] = 0ull;
        F.emax[g] = QK_FX_NONE;
        F.flags[g] = 0;
      } else {
        ((T*)C.out[a])[g] = (T)0;
      }
    }
    return;
  }
  if (OP == QK_COUNT) {
    for (long long g = g0; g < n; g += step) ((int32_t*)C.out[a])[g] = 0;
  } else if (OP == QK_MIN || OP == QK_MAX || OP == QK_SUM) {
    const T v = OP == QK_MIN ? qk_ident_min<T>() : (OP == QK_MAX ? qk_ident_max<T>() : (T)0);
    for (long long g = g0; g < n; g += step) ((T*)C.out[a])[g] = v;
  } else if (OP == QK_MEAN) {
    typedef typename QkMeanOut<T>::type O;
    for (long long g = g0; g < n; g += step) ((O*)C.out[a])[g] = (O)0;
    if ((void*)C.acc[a] != C.out[a])
      for (long long g = g0; g < n; g += step) ((T*)C.acc[a])[g] = (T)0;
  } else {  // first: the input at row n - 1, the smallest row of an empty group
    const T v = ((const T*)C.in[a])[n - 1];
    for (long long g = g0; g < n; g += step) ((T*)C.out[a])[g] = v;
  }
}

// add one tile's live rows of column a into their groups
template <typename T, int OP>
__device__ __forceinline__ void qk_add_col(const GbCols& C, int a, const long long* row,
                                           const long long* r, long long n) {
  if (OP == QK_FIRST) return;
  const T* in = (const T*)C.in[a];
  T x[QK_GB_ITEMS];
#pragma unroll
  for (int j = 0; j < QK_GB_ITEMS; ++j)
    if (r[j] >= 0) x[j] = in[row[j]];
  if (QkFx<T>::on && (OP == QK_SUM || OP == QK_MEAN)) {
    const QkFxCol F = qk_fx_col(C, a, n);
#pragma unroll
    for (int j = 0; j < QK_GB_ITEMS; ++j) {
      if (r[j] < 0) continue;
      int flag;
      if (qk_fx_exp((double)x[j], flag) && !flag)
        qk_fx_add(F, r[j], (double)x[j], F.emax[r[j]]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < QK_GB_ITEMS; ++j) {
    if (r[j] < 0) continue;
    if (OP == QK_SUM) qk_atomic_add((T*)C.out[a] + r[j], x[j]);
    else if (OP == QK_MEAN) qk_atomic_add((T*)C.acc[a] + r[j], x[j]);
    else if (OP == QK_COUNT) {
      if (x[j] == x[j]) atomicAdd((int32_t*)C.out[a] + r[j], 1);  // float inputs only
    } else qk_atomic_minmax((T*)C.out[a] + r[j], x[j], OP == QK_MIN);
  }
}

// a float sum's or mean's exponent pass: each group's largest biased
// exponent and its NaN / infinity flags
template <typename T, int OP>
__device__ __forceinline__ void qk_exp_col(const GbCols& C, int a, const long long* row,
                                           const long long* r, long long n) {
  if (!(QkFx<T>::on && (OP == QK_SUM || OP == QK_MEAN))) return;
  const T* in = (const T*)C.in[a];
  const QkFxCol F = qk_fx_col(C, a, n);
#pragma unroll
  for (int j = 0; j < QK_GB_ITEMS; ++j) {
    if (r[j] < 0) continue;
    int flag;
    const int e = qk_fx_exp((double)in[row[j]], flag);
    if (flag) atomicOr(F.flags + r[j], flag);
    else if (e) atomicMax(F.emax + r[j], e);
  }
}

// finish a mean, a first or a float sum over groups [g0, m)
template <typename T, int OP>
__device__ __forceinline__ void qk_finish_col(const GbCols& C, int a, const int32_t* counts,
                                              const int32_t* rep, long long m, long long g0,
                                              long long step, long long n) {
  if (QkFx<T>::on && (OP == QK_SUM || OP == QK_MEAN)) {
    const QkFxCol F = qk_fx_col(C, a, n);
    for (long long g = g0; g < m; g += step) {
      const T sum = (T)qk_fx_value(F, g);
      if (OP == QK_SUM) {
        ((T*)C.out[a])[g] = sum;
      } else {
        const int32_t c = counts[g];
        ((T*)C.out[a])[g] = sum / (T)(c > 1 ? c : 1);
      }
    }
    return;
  }
  if (OP == QK_MEAN) {
    typedef typename QkMeanOut<T>::type O;
    for (long long g = g0; g < m; g += step) {
      const int32_t c = counts[g];
      ((O*)C.out[a])[g] = (O)((const T*)C.acc[a])[g] / (O)(c > 1 ? c : 1);
    }
  } else if (OP == QK_FIRST) {
    for (long long g = g0; g < m; g += step) ((T*)C.out[a])[g] = ((const T*)C.in[a])[rep[g]];
  }
}

#define QK_GB_DISPATCH(KIND, FN, ...)                                          \
  switch (KIND) {                                                              \
    case QK_SUM * 4 + QK_F64: FN<double, QK_SUM>(__VA_ARGS__); break;          \
    case QK_SUM * 4 + QK_F32: FN<float, QK_SUM>(__VA_ARGS__); break;           \
    case QK_SUM * 4 + QK_I64: FN<long long, QK_SUM>(__VA_ARGS__); break;       \
    case QK_SUM * 4 + QK_I32: FN<int32_t, QK_SUM>(__VA_ARGS__); break;         \
    case QK_COUNT * 4 + QK_F64: FN<double, QK_COUNT>(__VA_ARGS__); break;      \
    case QK_COUNT * 4 + QK_F32: FN<float, QK_COUNT>(__VA_ARGS__); break;       \
    case QK_MIN * 4 + QK_F64: FN<double, QK_MIN>(__VA_ARGS__); break;          \
    case QK_MIN * 4 + QK_F32: FN<float, QK_MIN>(__VA_ARGS__); break;           \
    case QK_MIN * 4 + QK_I64: FN<long long, QK_MIN>(__VA_ARGS__); break;       \
    case QK_MIN * 4 + QK_I32: FN<int32_t, QK_MIN>(__VA_ARGS__); break;         \
    case QK_MAX * 4 + QK_F64: FN<double, QK_MAX>(__VA_ARGS__); break;          \
    case QK_MAX * 4 + QK_F32: FN<float, QK_MAX>(__VA_ARGS__); break;           \
    case QK_MAX * 4 + QK_I64: FN<long long, QK_MAX>(__VA_ARGS__); break;       \
    case QK_MAX * 4 + QK_I32: FN<int32_t, QK_MAX>(__VA_ARGS__); break;         \
    case QK_MEAN * 4 + QK_F64: FN<double, QK_MEAN>(__VA_ARGS__); break;        \
    case QK_MEAN * 4 + QK_F32: FN<float, QK_MEAN>(__VA_ARGS__); break;         \
    case QK_MEAN * 4 + QK_I64: FN<long long, QK_MEAN>(__VA_ARGS__); break;     \
    case QK_MEAN * 4 + QK_I32: FN<int32_t, QK_MEAN>(__VA_ARGS__); break;       \
    case QK_FIRST * 4 + QK_F64: FN<double, QK_FIRST>(__VA_ARGS__); break;      \
    case QK_FIRST * 4 + QK_F32: FN<float, QK_FIRST>(__VA_ARGS__); break;       \
    case QK_FIRST * 4 + QK_I64: FN<long long, QK_FIRST>(__VA_ARGS__); break;   \
    case QK_FIRST * 4 + QK_I32: FN<int32_t, QK_FIRST>(__VA_ARGS__); break;     \
    default: break;                                                            \
  }

// the group of row i: -1 for a row the insert could not place
template <int MODE>  // 0 slots, 1 int32 ranks, 2 int64 ranks
__device__ __forceinline__ long long qk_rank_of(const GbSeg& S, long long i) {
  if (MODE == 0) {
    const int32_t s = S.myslot[i];
    return s < 0 ? -1 : (long long)S.boff[s >> QK_GB_RANK_SHIFT] + S.local[s];
  }
  if (MODE == 1) return ((const int32_t*)S.ranks)[i];
  return ((const long long*)S.ranks)[i];
}

// no early return: every block meets every barrier
template <int MODE>
__global__ void __launch_bounds__(QK_GB_THREADS) qk_gb_segment_kernel(GbSeg S) {
  const long long n = S.n;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long g0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long g = g0; g < n; g += step) {
    S.counts[g] = 0;
    S.rep[g] = (int32_t)(n - 1);
  }
  // the group count: the rank kernel wrote it before this launch
  const long long m = S.num ? (long long)*(volatile const int32_t*)S.num : n;
  for (int a = 0; a < S.C.k; ++a)
    QK_GB_DISPATCH(S.C.kind[a], qk_fill_col, S.C, a, n, m, g0, step)
  unsigned int barrier = 1u;
  qk_grid_barrier(S.bar, barrier++);

  // this block's tiles: a contiguous range of rows
  const long long tiles = (n + QK_GB_TILE - 1) / QK_GB_TILE;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  if (S.C.any_fx) {  // uniform: every block or none meets this barrier
    for (long long t = tiles * blockIdx.x / gridDim.x; t < t_end; ++t) {
      long long row[QK_GB_ITEMS], r[QK_GB_ITEMS];
#pragma unroll
      for (int j = 0; j < QK_GB_ITEMS; ++j) {
        row[j] = t * QK_GB_TILE + j * QK_GB_THREADS + threadIdx.x;
        r[j] = row[j] < n && S.valid[row[j]] ? qk_rank_of<MODE>(S, row[j]) : -1;
        if (MODE == 0 && r[j] >= 0) S.myslot[row[j]] = (int32_t)r[j];
      }
      for (int a = 0; a < S.C.k; ++a)
        QK_GB_DISPATCH(S.C.kind[a], qk_exp_col, S.C, a, row, r, n)
    }
    qk_grid_barrier(S.bar, barrier++);
  }
  for (long long t = tiles * blockIdx.x / gridDim.x; t < t_end; ++t) {
    long long row[QK_GB_ITEMS], r[QK_GB_ITEMS];
#pragma unroll
    for (int j = 0; j < QK_GB_ITEMS; ++j) {
      row[j] = t * QK_GB_TILE + j * QK_GB_THREADS + threadIdx.x;
      r[j] = row[j] < n && S.valid[row[j]] ? 0 : -1;
    }
#pragma unroll
    for (int j = 0; j < QK_GB_ITEMS; ++j) {
      if (r[j] < 0) continue;
      r[j] = MODE == 0 && S.C.any_fx ? (long long)S.myslot[row[j]] : qk_rank_of<MODE>(S, row[j]);
      if (r[j] < 0) continue;
      atomicAdd(S.counts + r[j], 1);
      atomicMin(S.rep + r[j], (int32_t)row[j]);
    }
    for (int a = 0; a < S.C.k; ++a) QK_GB_DISPATCH(S.C.kind[a], qk_add_col, S.C, a, row, r, n)
  }
  if (!S.finish) return;  // uniform: no block meets the last barrier
  qk_grid_barrier(S.bar, barrier);
  for (int a = 0; a < S.C.k; ++a)
    QK_GB_DISPATCH(S.C.kind[a], qk_finish_col, S.C, a, S.counts, S.rep, m, g0, step, n)
}

// the k columns' words: k inputs, k outputs, k accs, k fixed-point
// scratches (0 but for float sums and means), k kinds
static void qk_fill_cols(GbCols& C, int k, const long long* w) {
  C.k = k;
  C.any_fx = 0;
  for (int a = 0; a < k; ++a) {
    C.in[a] = (const void*)w[a];
    C.out[a] = (void*)w[k + a];
    C.acc[a] = (void*)w[2 * k + a];
    C.fx[a] = (void*)w[3 * k + a];
    C.kind[a] = (int)w[4 * k + a];
    C.any_fx |= C.fx[a] != nullptr;
  }
}

// the resident blocks of the segment kernel on the current device
template <int MODE>
static int qk_segment_launch(GbSeg& S, cudaStream_t st) {
  S.finish = S.C.any_fx;
  for (int a = 0; a < S.C.k; ++a) S.finish |= S.C.kind[a] / 4 >= QK_MEAN;
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_gb_segment_kernel<MODE>,
                                                  QK_GB_THREADS, 0);
    if (sms * per_sm <= 0) return (int)cudaErrorLaunchOutOfResources;
    resident[dev] = sms * per_sm;
  }
  long long want = (S.n + QK_GB_TILE - 1) / QK_GB_TILE;
  if (want < 1) want = 1;
  const int grid = (int)(want < resident[dev] ? want : resident[dev]);
  void* args[] = {&S};
  return (int)cudaLaunchCooperativeKernel((const void*)qk_gb_segment_kernel<MODE>, dim3(grid),
                                          dim3(QK_GB_THREADS), args, 0, st);
}

extern "C" {

// K11 build: the insert alone.  table (cap int32, filled with QK_EMPTY) and
// failed (one int32, zeroed) are outputs.
int qk_hash_build(const void* const* limbs, int n_limbs, const void* valid, long long n,
                  void* table, unsigned int mask, void* failed, void* stream) {
  if (n_limbs < 1 || n_limbs > QK_MAX_LIMBS) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Limbs L;
  L.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) L.p[j] = (const int32_t*)limbs[j];
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  qk_insert_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      L, (const uint8_t*)valid, n, (int32_t*)table, mask, (int32_t*)failed);
  return (int)cudaGetLastError();
}

// K11 probe: build_idx (p int32) and matched (p uint8) are outputs.
int qk_pk_probe(const void* const* build_limbs, const void* const* probe_limbs,
                int n_limbs, const void* ok, long long p, const void* table,
                unsigned int mask, long long nb, void* build_idx, void* matched,
                void* stream) {
  if (n_limbs < 1 || n_limbs > QK_MAX_LIMBS) return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  Limbs B, P;
  B.n = P.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    B.p[j] = (const int32_t*)build_limbs[j];
    P.p[j] = (const int32_t*)probe_limbs[j];
  }
  int threads = 256;
  unsigned int blocks = (unsigned int)((p + threads - 1) / threads);
  qk_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      B, P, (const uint8_t*)ok, p, (const int32_t*)table, mask, nb,
      (int32_t*)build_idx, (uint8_t*)matched);
  return (int)cudaGetLastError();
}

// qk_groupby's scratch ahead of the columns' accumulators, in bytes from
// its start: 16 bytes of counters (the rank ticket, the grid barrier, the
// insert's failed flag), the rank scan's block counts (cap / 4096 int32, at
// least 1), the table (cap int32) and the row slots (n int32), each 16-byte
// aligned; qk_segment_ranked's is the counters alone
static long long qk_align16(long long b) { return (b + 15) & ~15LL; }

struct GbScratch {
  long long table, myslot, end;
};

static GbScratch qk_gb_scratch_layout(long long n, long long cap) {
  const long long blocks = cap >> QK_GB_RANK_SHIFT;
  GbScratch L;
  L.table = 16 + qk_align16(4 * (blocks > 1 ? blocks : 1));
  L.myslot = qk_align16(L.table + 4 * cap);
  L.end = qk_align16(L.myslot + 4 * n);
  return L;
}

// the bytes of scratch that qk_groupby (cap > 0) or qk_segment_ranked (cap
// 0) uses ahead of the columns' accumulators
long long qk_gb_scratch(long long n, long long cap) {
  return cap > 0 ? qk_gb_scratch_layout(n, cap).end : 16;
}

// K3 over n >= 1 rows with a table of cap slots (a power of two).  valid is
// n bytes; scratch holds qk_gb_scratch(n, cap) bytes; hdr (num, failed),
// counts and rep (n int32 each) are written.  keys holds n_keys pointers,
// then their types (0 f64, 1 f32, 2 i64, 3 i32); cols holds k input, k
// output, k acc and k fixed-point scratch pointers (24 n bytes each, 16-byte
// aligned, for every float sum and mean, else 0), then k kinds (op * 4 +
// input type; op 0 sum, 1 count of a float input, 2 min, 3 max, 4 mean, 5
// first), and every output is written.
int qk_groupby(long long n, long long cap, const void* valid, void* scratch, void* hdr,
               void* counts, void* rep, int n_keys, const long long* keys, int k,
               const long long* cols, void* stream) {
  if (n_keys < 1 || n_keys > QK_GB_MAX_KEYS || n < 1 || n >= 0x7fffffffLL || k < 0 ||
      k > QK_GB_MAX_COLS || cap < 1 || cap > (1LL << 32) || (cap & (cap - 1)))
    return (int)cudaErrorInvalidValue;
  GbKeys K;
  K.n = n_keys;
  for (int j = 0; j < n_keys; ++j) {
    K.p[j] = (const void*)keys[j];
    K.dt[j] = (int)keys[n_keys + j];
  }
  GbSeg S;
  qk_fill_cols(S.C, k, cols);
  const GbScratch L = qk_gb_scratch_layout(n, cap);
  unsigned char* base = (unsigned char*)scratch;
  unsigned int* ctr = (unsigned int*)base;
  int32_t* bcount = (int32_t*)(base + 16);
  int32_t* table = (int32_t*)(base + L.table);
  int32_t* myslot = (int32_t*)(base + L.myslot);
  cudaStream_t st = (cudaStream_t)stream;
  // the counters, block counts and table (EMPTY is 0)
  cudaError_t err = cudaMemsetAsync(base, 0, (size_t)(L.table + 4 * cap), st);
  if (err != cudaSuccess) return (int)err;
  qk_gb_insert_kernel<<<(unsigned int)((n + QK_GB_THREADS - 1) / QK_GB_THREADS), QK_GB_THREADS,
                        0, st>>>(K, (const uint8_t*)valid, n, table, (uint32_t)(cap - 1), myslot,
                                 (int32_t*)(ctr + 2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_gb_rank_kernel<<<(unsigned int)((cap + (1 << QK_GB_RANK_SHIFT) - 1) >> QK_GB_RANK_SHIFT),
                      QK_GB_THREADS, 0, st>>>(table, cap, bcount, ctr,
                                              (const int32_t*)(ctr + 2), (int32_t*)hdr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  S.valid = (const uint8_t*)valid;
  S.n = n;
  S.myslot = myslot;
  S.local = table;
  S.boff = bcount;
  S.ranks = nullptr;
  S.counts = (int32_t*)counts;
  S.rep = (int32_t*)rep;
  S.num = (const int32_t*)hdr;
  S.bar = ctr + 1;
  return qk_segment_launch<0>(S, st);
}

// The segment pass alone over given ranks (n int32, rank_dt 3, or int64,
// rank_dt 2) of n >= 1 rows; scratch holds qk_gb_scratch(n, 0) bytes;
// counts, rep and the columns as qk_groupby's.
int qk_segment_ranked(long long n, const void* ranks, int rank_dt, const void* valid,
                      void* scratch, void* counts, void* rep, int k, const long long* cols,
                      void* stream) {
  if (n < 1 || n >= 0x7fffffffLL || (rank_dt != QK_I32 && rank_dt != QK_I64) || k < 0 ||
      k > QK_GB_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  GbSeg S;
  qk_fill_cols(S.C, k, cols);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  S.valid = (const uint8_t*)valid;
  S.n = n;
  S.myslot = nullptr;
  S.local = S.boff = nullptr;
  S.ranks = ranks;
  S.counts = (int32_t*)counts;
  S.rep = (int32_t*)rep;
  S.num = nullptr;
  S.bar = (unsigned int*)scratch;
  return rank_dt == QK_I32 ? qk_segment_launch<1>(S, st) : qk_segment_launch<2>(S, st);
}

}  // extern "C"
