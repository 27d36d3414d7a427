// As-of join kernels for Hopper (sm_90a): the sorted-quote probe (K18) and
// the segmented fill-forward scan (K19).
//
// K18 replaces quokka_tpu/ops/asof.py:_ss_probe (a vectorised
// lexicographic binary search of every trade row over the quotes sorted by
// (key limbs, time), `steps` unrolled halvings with one gather per limb per
// step; the sort itself, :_ss_sort_quotes, stays stable torch sorts).
// Backward asof takes the upper bound minus one: the last quote with key
// == k and time <= t, which among (key, time) ties is the last original
// row, since the sort is stable.  Forward takes the lower bound: the first
// quote with key == k and time >= t.  Then the key-equality check and the
// gather of the quote's original row through `perm`.
//
// What bounds K18: the throughput of the search's scattered reads.  Each
// trade row reads its limbs and validity once and writes a quote index
// (4 B) and a flag (1 B); its search reads about log2(valid quotes) sorted
// positions.  At the tick shape (2^22 sorted quotes, about 100 symbols) a
// full-range search walks 22 levels over three limb arrays (49 MB, the
// edge of the 50 MB L2), and all but about 7 of those levels compare key
// limbs that are already decided.
//
// Design: two levels on search.cuh's typed bound.  The quotes sorted by
// (validity, keys, time) form one run per distinct key tuple inside the
// valid prefix; ops/asof.py:_ss_key_runs builds the run table once per
// quote buffer (each run's key limbs, and bounds[r] = its first row,
// bounds[R] = the valid quotes).  One thread per trade row: (1) a
// lexicographic lower bound of its key over the R run keys, staged in
// shared memory when the table takes at most QK_RUN_STAGE_BYTES (16 KiB:
// 1,364 runs of two int32 limbs), read from device memory otherwise; (2) if
// that run's key equals the row's, a one-limb bound of the time inside the
// run [bounds[r], bounds[r + 1]) (about 15 levels over one contiguous time
// array, 24.5 MB at the tick shape), else the position is the run's first
// row; (3) the tail: the position, its match (already known from (1) and
// the run's ends, so no row is read again), the `perm` gather, the clamps.
// Every row searches, padding included, so quote_idx is the full search's
// on every row (search.cuh's note says why the two levels give it).  On
// the card the time search takes about four fifths of the kernel; an
// interpolated start and a 4-ary search were no faster (PERF.md §6).  Key
// signatures none, int32, int64, float64 and two int32 limbs, with int64,
// float64, int32 or float32 times, are compiled typed; any other takes
// the runtime-dispatch kernel (QkDyn over the run keys), which the wrapper
// counts apart.
//
// K19 replaces quokka_tpu/ops/asof.py:_seg_fill_forward (a
// lax.associative_scan of the segmented running max): out[i] is the max of
// values[j] over j from the last segment start at or before i (or from 0)
// to i.  The same scan run from the end with min replaces
// quokka_tpu/executors/ts_execs.py:_rows_from_segment_end (the reference's
// backward associative_scan over the start rows, a flip and a cummin in the
// port before): `qk_segment_bounds` gives every row its segment's first row
// (the forward max of start rows) and last row (the backward min of the
// next start row less one) in one launch.  What bounds both: bytes (the
// general form 5 B read and 4 B written a row; the bounds 1 B read and 8 B
// written a row).  Design: one single-pass chained scan.  A block takes a
// tile of QK_CHAIN_TILE consecutive rows, QK_CHAIN_ITEMS a thread read with
// 16-byte loads, scans them in registers, then across the warp with
// shuffles and across the block's warps; the tile's carry comes from a
// decoupled look-back over the tiles before it in scan order: each tile
// publishes its aggregate, then its inclusive prefix, in one 64-bit status
// word (value, started flag, state), and a tile whose aggregate holds a
// segment start publishes its prefix at once, since nothing before it
// reaches past that start.  A block takes its tile from an atomic ticket,
// so it waits only on tiles whose blocks already run; the backward scan
// takes tiles from the last one down and scans each from its end.  The
// bounds kernel interleaves both directions' tickets in one launch.  The
// status words and tickets are zeroed by one memset on the same stream.
// The combine, (a, b) -> b.started ? b.value : op(a.value, b.value), with
// op max forwards and min backwards, is associative, so every order of
// combination gives the reference's result exactly (integers, no
// rounding).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "search.cuh"

#define QK_PROBE_THREADS 256
#define QK_RUN_STAGE_BYTES 16384

// -- K18: the sorted-quote probe ----------------------------------------------

template <class Row>
__host__ __device__ __forceinline__ size_t qk_rows_bytes(uint32_t n) {
  return ((size_t)n * sizeof(Row) + 15) & ~(size_t)15;
}

// steps (2) and (3) for trade row i, whose key search ended at run bounds
// [lo, hi) with key equality keq
template <bool kUpper, typename T>
__device__ __forceinline__ void qk_asof_finish(const QkCols<T>& times, const QkRow<T>& t,
                                               uint32_t lo, uint32_t hi, bool keq,
                                               uint32_t i, const int32_t* __restrict__ perm,
                                               uint32_t nq, const uint8_t* __restrict__ valid,
                                               int32_t* __restrict__ quote_idx,
                                               uint8_t* __restrict__ matched) {
  uint32_t pos = lo;
  bool hit = false;
  if (keq) {
    bool e;
    pos = qk_bound<kUpper>(times, lo, hi - lo, t, &e);
    hit = kUpper ? pos > lo : pos < hi;
  }
  // backward: the last row <= t; forward: the first row >= t
  const int64_t at = kUpper ? (int64_t)pos - 1 : (int64_t)pos;
  const int64_t cpos = at < 0 ? 0 : (at > (int64_t)nq - 1 ? (int64_t)nq - 1 : at);
  const int32_t q = perm[cpos];
  quote_idx[i] = q < 0 ? 0 : (q > (int32_t)(nq - 1) ? (int32_t)(nq - 1) : q);
  matched[i] = (valid[i] && hit) ? 1 : 0;
}

template <class Keys, typename T>
__global__ void __launch_bounds__(QK_PROBE_THREADS)
    qk_asof_probe_kernel(Keys runs, Keys probe, QkCols<T> times, QkCols<T> probe_time,
                         const int32_t* __restrict__ bounds, uint32_t n_runs, int staged,
                         int upper, const int32_t* __restrict__ perm, uint32_t nq,
                         const uint8_t* __restrict__ valid, uint32_t p,
                         int32_t* __restrict__ quote_idx, uint8_t* __restrict__ matched) {
  typedef typename Keys::Row Row;
  extern __shared__ __align__(16) unsigned char qk_smem[];
  Row* s_rows = (Row*)qk_smem;
  int32_t* s_bounds = (int32_t*)(qk_smem + qk_rows_bytes<Row>(n_runs));
  if (staged) {
    for (uint32_t j = threadIdx.x; j < n_runs; j += blockDim.x) s_rows[j] = runs.load(j);
    for (uint32_t j = threadIdx.x; j <= n_runs; j += blockDim.x) s_bounds[j] = bounds[j];
    __syncthreads();
  }
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const Row key = probe.load(i);
  const QkRow<T> t = probe_time.load(i);
  bool keq;
  const uint32_t r = staged ? qk_bound<false>(QkStaged<Row>{s_rows}, 0, n_runs, key, &keq)
                            : qk_bound<false>(runs, 0, n_runs, key, &keq);
  const int32_t* b = staged ? s_bounds : bounds;
  const uint32_t lo = (uint32_t)b[r];
  const uint32_t hi = keq ? (uint32_t)b[r + 1] : lo;
  if (upper) qk_asof_finish<true>(times, t, lo, hi, keq, i, perm, nq, valid, quote_idx, matched);
  else qk_asof_finish<false>(times, t, lo, hi, keq, i, perm, nq, valid, quote_idx, matched);
}

// the runtime-dispatch twin: run keys and probe keys of any dtypes
template <typename T>
__global__ void __launch_bounds__(QK_PROBE_THREADS)
    qk_asof_probe_dyn_kernel(QkDyn keys, QkCols<T> times, QkCols<T> probe_time,
                             const int32_t* __restrict__ bounds, uint32_t n_runs, int upper,
                             const int32_t* __restrict__ perm, uint32_t nq,
                             const uint8_t* __restrict__ valid, uint32_t p,
                             int32_t* __restrict__ quote_idx, uint8_t* __restrict__ matched) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const QkRow<T> t = probe_time.load(i);
  bool keq;
  const uint32_t r = qk_bound<false>(keys, 0, n_runs, keys.load(i), &keq);
  const uint32_t lo = (uint32_t)bounds[r];
  const uint32_t hi = keq ? (uint32_t)bounds[r + 1] : lo;
  if (upper) qk_asof_finish<true>(times, t, lo, hi, keq, i, perm, nq, valid, quote_idx, matched);
  else qk_asof_finish<false>(times, t, lo, hi, keq, i, perm, nq, valid, quote_idx, matched);
}

struct QkAsofArgs {
  const void* const* run_keys;  // nkey arrays of n_runs rows
  const void* const* probe;     // nkey key arrays, then the time, of p rows
  const int* dts;               // nkey + 1 dtypes
  int nkey;
  const void* times;            // the sorted time limb, nq rows
  const int32_t* bounds;        // n_runs + 1
  uint32_t n_runs;
  int upper;
  const int32_t* perm;
  uint32_t nq;
  const uint8_t* valid;
  uint32_t p;
  int32_t* quote_idx;
  uint8_t* matched;
  cudaStream_t stream;
};

static unsigned int qk_blocks(uint32_t n) {
  return (unsigned int)((n + QK_PROBE_THREADS - 1) / QK_PROBE_THREADS);
}

template <class Keys, typename T>
static int qk_asof_typed(const QkAsofArgs& a) {
  typedef typename Keys::Row Row;
  const size_t stage = qk_rows_bytes<Row>(a.n_runs) + sizeof(int32_t) * ((size_t)a.n_runs + 1);
  const int staged = stage <= QK_RUN_STAGE_BYTES;
  qk_asof_probe_kernel<Keys, T><<<qk_blocks(a.p), QK_PROBE_THREADS, staged ? stage : 0,
                                   a.stream>>>(
      Keys::at(a.run_keys), Keys::at(a.probe), QkCols<T>::at(&a.times),
      QkCols<T>::at(a.probe + a.nkey), a.bounds, a.n_runs, staged, a.upper, a.perm, a.nq,
      a.valid, a.p, a.quote_idx, a.matched);
  return (int)cudaGetLastError();
}

template <class Keys>
static int qk_asof_time(const QkAsofArgs& a) {
  switch (a.dts[a.nkey]) {
    case QK_F64: return qk_asof_typed<Keys, double>(a);
    case QK_F32: return qk_asof_typed<Keys, float>(a);
    case QK_I64: return qk_asof_typed<Keys, long long>(a);
    case QK_I32: return qk_asof_typed<Keys, int32_t>(a);
    default: return -1;
  }
}

// the typed instantiations; -1 when the signature has none
static int qk_asof_keys(const QkAsofArgs& a) {
  const int* d = a.dts;
  if (a.nkey == 0) return qk_asof_time<QkCols<> >(a);
  if (a.nkey == 1 && d[0] == QK_I32) return qk_asof_time<QkCols<int32_t> >(a);
  if (a.nkey == 1 && d[0] == QK_I64) return qk_asof_time<QkCols<long long> >(a);
  if (a.nkey == 1 && d[0] == QK_F64) return qk_asof_time<QkCols<double> >(a);
  if (a.nkey == 2 && d[0] == QK_I32 && d[1] == QK_I32)
    return qk_asof_time<QkCols<int32_t, int32_t> >(a);
  return -1;
}

template <typename T>
static int qk_asof_dyn(const QkAsofArgs& a) {
  QkDyn k;
  k.S.n = k.P.n = a.nkey;
  for (int j = 0; j < a.nkey; ++j) {
    k.S.p[j] = a.run_keys[j];
    k.P.p[j] = a.probe[j];
    k.S.dt[j] = k.P.dt[j] = a.dts[j];
  }
  qk_asof_probe_dyn_kernel<T><<<qk_blocks(a.p), QK_PROBE_THREADS, 0, a.stream>>>(
      k, QkCols<T>::at(&a.times), QkCols<T>::at(a.probe + a.nkey), a.bounds, a.n_runs,
      a.upper, a.perm, a.nq, a.valid, a.p, a.quote_idx, a.matched);
  return (int)cudaGetLastError();
}

// -- K19: the segmented scan, forwards (max) or backwards (min) --------------

#define QK_CHAIN_THREADS 256
#define QK_CHAIN_ITEMS 16  // rows a thread: four 16-byte loads of int32, one of flags
#define QK_CHAIN_TILE (QK_CHAIN_THREADS * QK_CHAIN_ITEMS)
#define QK_CHAIN_WARPS (QK_CHAIN_THREADS / 32)

struct QkSeg {
  int32_t v;
  bool s;  // a segment starts in the combined rows
};

template <bool kMin>
__device__ __forceinline__ QkSeg qk_seg_ident() {
  return QkSeg{kMin ? INT_MAX : INT_MIN, false};
}

// a before b in scan order
template <bool kMin>
__device__ __forceinline__ QkSeg qk_seg_combine(QkSeg a, QkSeg b) {
  if (!b.s) b.v = kMin ? (a.v < b.v ? a.v : b.v) : (a.v > b.v ? a.v : b.v);
  b.s = a.s || b.s;
  return b;
}

__device__ __forceinline__ QkSeg qk_seg_shfl_up(QkSeg x, int d) {
  return QkSeg{__shfl_up_sync(0xffffffffu, x.v, d), __shfl_up_sync(0xffffffffu, (int)x.s, d) != 0};
}

__device__ __forceinline__ QkSeg qk_seg_shfl_down(QkSeg x, int d) {
  return QkSeg{__shfl_down_sync(0xffffffffu, x.v, d),
               __shfl_down_sync(0xffffffffu, (int)x.s, d) != 0};
}

// a tile's status word: state (1 aggregate, 2 inclusive prefix) in bits
// 62-63, the started flag in bit 32, the value in bits 0-31; 0 = not yet
__device__ __forceinline__ unsigned long long qk_seg_pack(QkSeg x, unsigned long long state) {
  return (state << 62) | ((unsigned long long)x.s << 32) | (unsigned long long)(uint32_t)x.v;
}

__device__ __forceinline__ unsigned long long qk_ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void qk_st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void qk_unpack_flags(uint4 f, bool* s) {
  const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int q = 0; q < 16; ++q) s[q] = ((w[q >> 2] >> (8 * (q & 3))) & 0xffu) != 0;
}

// a thread's QK_CHAIN_ITEMS outputs from row r0, the first cnt written
__device__ __forceinline__ void qk_store_rows(int32_t* dst, bool vec, long long r0, int cnt,
                                              const int32_t* o) {
  if (vec && cnt == QK_CHAIN_ITEMS) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      __stcs((int4*)(dst + r0) + q, make_int4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]));
    return;
  }
#pragma unroll
  for (int q = 0; q < QK_CHAIN_ITEMS; ++q)
    if (q < cnt) dst[r0 + q] = o[q];
}

// the rows a thread reads and writes, in row order; rows past cnt are the
// scan's identity and are not written
struct QkFillIo {  // the general form: values and starts, forwards, inclusive
  static constexpr bool kBack = false, kExcl = false;
  const int32_t* values;
  const uint8_t* starts;
  int32_t* out;
  bool vec;  // every pointer 16-byte aligned
  __device__ __forceinline__ void load(long long r0, int cnt, QkSeg* x) const {
    if (vec && cnt == QK_CHAIN_ITEMS) {
      bool s[16];
      qk_unpack_flags(__ldcs((const uint4*)(starts + r0)), s);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = __ldcs((const int4*)(values + r0) + q);
        x[4 * q] = QkSeg{v.x, s[4 * q]};
        x[4 * q + 1] = QkSeg{v.y, s[4 * q + 1]};
        x[4 * q + 2] = QkSeg{v.z, s[4 * q + 2]};
        x[4 * q + 3] = QkSeg{v.w, s[4 * q + 3]};
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < QK_CHAIN_ITEMS; ++q)
      x[q] = q < cnt ? QkSeg{values[r0 + q], starts[r0 + q] != 0} : qk_seg_ident<false>();
  }
  __device__ __forceinline__ void store(long long r0, int cnt, const int32_t* o) const {
    qk_store_rows(out, vec, r0, cnt, o);
  }
};

// the segment bounds from start flags: forwards, each row's last start at
// or before it (the max over start rows and -1 elsewhere, inclusive: -1
// before the first start); backwards, each row's next start after it less
// one (the min, exclusive), n - 1 where none
template <bool B>
struct QkBoundsIo {
  static constexpr bool kBack = B, kExcl = B;
  const uint8_t* flags;
  int32_t* out;
  int32_t n;
  bool vec;
  __device__ __forceinline__ void load(long long r0, int cnt, QkSeg* x) const {
    bool s[16];
    if (vec && cnt == QK_CHAIN_ITEMS) {
      qk_unpack_flags(__ldcs((const uint4*)(flags + r0)), s);
    } else {
#pragma unroll
      for (int q = 0; q < QK_CHAIN_ITEMS; ++q) s[q] = q < cnt && flags[r0 + q] != 0;
    }
#pragma unroll
    for (int q = 0; q < QK_CHAIN_ITEMS; ++q) {
      const int32_t r = (int32_t)(r0 + q);
      x[q] = s[q] ? QkSeg{B ? r - 1 : r, true} : QkSeg{B ? INT_MAX : -1, false};
    }
  }
  __device__ __forceinline__ void store(long long r0, int cnt, const int32_t* o) const {
    if (B) {
      int32_t c[QK_CHAIN_ITEMS];
#pragma unroll
      for (int q = 0; q < QK_CHAIN_ITEMS; ++q) c[q] = o[q] < n - 1 ? o[q] : n - 1;
      qk_store_rows(out, vec, r0, cnt, c);
    } else {
      qk_store_rows(out, vec, r0, cnt, o);
    }
  }
};

struct QkChainShared {
  QkSeg warp[QK_CHAIN_WARPS];  // each warp's aggregate, then its exclusive prefix
  QkSeg carry;                 // the tile's exclusive prefix
  unsigned int ticket;
};

// tile k in scan order (the k-th from the start, or backwards from the
// end) over n rows in nt tiles; status holds the nt tiles' words of this
// direction
template <class Io>
__device__ __forceinline__ void qk_chain_tile(const Io& io, long long n, long long nt, long long k,
                                              unsigned long long* status, QkChainShared& sh) {
  constexpr bool kBack = Io::kBack;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long tile = kBack ? nt - 1 - k : k;
  const int chunk = kBack ? QK_CHAIN_THREADS - 1 - (int)threadIdx.x : (int)threadIdx.x;
  const long long r0 = tile * QK_CHAIN_TILE + (long long)chunk * QK_CHAIN_ITEMS;
  const long long left = n - r0;
  const int cnt = left <= 0 ? 0 : (left < QK_CHAIN_ITEMS ? (int)left : QK_CHAIN_ITEMS);
  QkSeg x[QK_CHAIN_ITEMS];
  io.load(r0, cnt, x);
  // the thread's aggregate, then its exclusive prefix in the warp
  QkSeg acc = qk_seg_ident<kBack>();
#pragma unroll
  for (int q = 0; q < QK_CHAIN_ITEMS; ++q)
    acc = qk_seg_combine<kBack>(acc, x[kBack ? QK_CHAIN_ITEMS - 1 - q : q]);
  QkSeg inc = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const QkSeg o = qk_seg_shfl_up(inc, d);
    if (lane >= d) inc = qk_seg_combine<kBack>(o, inc);
  }
  QkSeg wex = qk_seg_shfl_up(inc, 1);
  if (lane == 0) wex = qk_seg_ident<kBack>();
  if (lane == 31) sh.warp[w] = inc;
  __syncthreads();
  if (w == 0) {
    // the warps' exclusive prefixes and the tile's aggregate
    QkSeg y = lane < QK_CHAIN_WARPS ? sh.warp[lane] : qk_seg_ident<kBack>();
#pragma unroll
    for (int d = 1; d < QK_CHAIN_WARPS; d <<= 1) {
      const QkSeg o = qk_seg_shfl_up(y, d);
      if (lane >= d) y = qk_seg_combine<kBack>(o, y);
    }
    QkSeg yex = qk_seg_shfl_up(y, 1);
    if (lane == 0) yex = qk_seg_ident<kBack>();
    const QkSeg agg = {__shfl_sync(0xffffffffu, y.v, QK_CHAIN_WARPS - 1),
                       __shfl_sync(0xffffffffu, (int)y.s, QK_CHAIN_WARPS - 1) != 0};
    if (lane < QK_CHAIN_WARPS) sh.warp[lane] = yex;
    // publish, then look back over the tiles before this one
    if (lane == 0) qk_st_status(status + k, qk_seg_pack(agg, (k == 0 || agg.s) ? 2ull : 1ull));
    QkSeg excl = qk_seg_ident<kBack>();
    for (long long j0 = k - 1; j0 >= 0; j0 -= 32) {
      const long long j = j0 - lane;
      unsigned long long word = qk_seg_pack(qk_seg_ident<kBack>(), 2ull);
      if (j >= 0) {
        do {
          word = qk_ld_status(status + j);
        } while ((word >> 62) == 0);
      }
      QkSeg z = {(int32_t)(uint32_t)word, ((word >> 32) & 1ull) != 0};
      const unsigned stop = __ballot_sync(0xffffffffu, (word >> 62) == 2 || z.s);
      // lanes up to the nearest tile whose prefix is known; higher lanes
      // are earlier tiles
      if (stop && lane > __ffs(stop) - 1) z = qk_seg_ident<kBack>();
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const QkSeg o = qk_seg_shfl_down(z, d);
        if (lane + d < 32) z = qk_seg_combine<kBack>(o, z);
      }
      const QkSeg win = {__shfl_sync(0xffffffffu, z.v, 0),
                         __shfl_sync(0xffffffffu, (int)z.s, 0) != 0};
      excl = qk_seg_combine<kBack>(win, excl);
      if (stop) break;
    }
    if (lane == 0) {
      if (k > 0 && !agg.s)
        qk_st_status(status + k, qk_seg_pack(qk_seg_combine<kBack>(excl, agg), 2ull));
      sh.carry = excl;
    }
  }
  __syncthreads();
  QkSeg c = qk_seg_combine<kBack>(sh.carry, qk_seg_combine<kBack>(sh.warp[w], wex));
  int32_t o[QK_CHAIN_ITEMS];
#pragma unroll
  for (int q = 0; q < QK_CHAIN_ITEMS; ++q) {
    const int i = kBack ? QK_CHAIN_ITEMS - 1 - q : q;
    if (Io::kExcl) {
      o[i] = c.v;
      c = qk_seg_combine<kBack>(c, x[i]);
    } else {
      c = qk_seg_combine<kBack>(c, x[i]);
      o[i] = c.v;
    }
  }
  io.store(r0, cnt, o);
}

__global__ void __launch_bounds__(QK_CHAIN_THREADS)
    qk_fill_chain_kernel(QkFillIo io, long long n, long long nt, unsigned long long* status,
                         unsigned int* ticket) {
  __shared__ QkChainShared sh;
  if (threadIdx.x == 0) sh.ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  qk_chain_tile(io, n, nt, (long long)sh.ticket, status, sh);
}

// tickets alternate between the directions: even forwards, odd backwards
__global__ void __launch_bounds__(QK_CHAIN_THREADS)
    qk_bounds_chain_kernel(QkBoundsIo<false> fwd, QkBoundsIo<true> bwd, long long n, long long nt,
                           unsigned long long* status, unsigned int* ticket) {
  __shared__ QkChainShared sh;
  if (threadIdx.x == 0) sh.ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long k = (long long)(sh.ticket >> 1);
  if (sh.ticket & 1u) qk_chain_tile(bwd, n, nt, k, status + nt, sh);
  else qk_chain_tile(fwd, n, nt, k, status, sh);
}

static bool qk_aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

extern "C" {

// run_keys (nkey arrays of n_runs rows) and bounds (n_runs + 1 int32):
// the quotes' run table (ops/asof.py:_ss_key_runs); times: the sorted time
// limb (nq rows); probe (nkey key arrays, then the time, of p rows; dts:
// their nkey + 1 dtypes, the run keys and times alike), perm (nq int32),
// valid (p uint8).  upper != 0 is the backward search.  quote_idx (p int32)
// and matched (p uint8) are outputs; *typed is 1 when a typed kernel ran,
// 0 when the runtime-dispatch one did.
int qk_asof_probe(const void* const* run_keys, const void* const* probe, const int* dts,
                  int nkey, int upper, const void* bounds, long long n_runs,
                  const void* times, const void* perm, long long nq, const void* valid,
                  long long p, void* quote_idx, void* matched, int* typed, void* stream) {
  *typed = 0;
  if (nkey < 0 || nkey >= QK_MAX_LIMBS || nq < 1 || nq > INT_MAX || p < 0 || p > INT_MAX ||
      n_runs < 0 || n_runs > nq || (nkey == 0 && n_runs != 1))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  QkAsofArgs a;
  a.run_keys = run_keys;
  a.probe = probe;
  a.dts = dts;
  a.nkey = nkey;
  a.times = times;
  a.bounds = (const int32_t*)bounds;
  a.n_runs = (uint32_t)n_runs;
  a.upper = upper;
  a.perm = (const int32_t*)perm;
  a.nq = (uint32_t)nq;
  a.valid = (const uint8_t*)valid;
  a.p = (uint32_t)p;
  a.quote_idx = (int32_t*)quote_idx;
  a.matched = (uint8_t*)matched;
  a.stream = (cudaStream_t)stream;
  const int rc = qk_asof_keys(a);
  if (rc >= 0) {
    *typed = 1;
    return rc;
  }
  switch (dts[nkey]) {
    case QK_F64: return qk_asof_dyn<double>(a);
    case QK_F32: return qk_asof_dyn<float>(a);
    case QK_I64: return qk_asof_dyn<long long>(a);
    case QK_I32: return qk_asof_dyn<int32_t>(a);
    default: return qk_asof_dyn<uint8_t>(a);
  }
}

// the scratch of K19 over n rows (uint64 words): a status word per tile
// and direction, and the ticket
long long qk_chain_scratch(long long n, int dirs) {
  return (long long)dirs * ((n + QK_CHAIN_TILE - 1) / QK_CHAIN_TILE) + 1;
}

// values (n int32), starts (n uint8), scratch (qk_chain_scratch(n, 1)
// words, zeroed here), out (n int32).
int qk_seg_fill_forward(const void* values, const void* starts, long long n, void* scratch,
                        void* out, void* stream) {
  if (n < 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (n + QK_CHAIN_TILE - 1) / QK_CHAIN_TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (size_t)qk_chain_scratch(n, 1), st);
  if (err != cudaSuccess) return (int)err;
  QkFillIo io;
  io.values = (const int32_t*)values;
  io.starts = (const uint8_t*)starts;
  io.out = (int32_t*)out;
  io.vec = qk_aligned16(values) && qk_aligned16(starts) && qk_aligned16(out);
  unsigned long long* status = (unsigned long long*)scratch;
  qk_fill_chain_kernel<<<(unsigned int)nt, QK_CHAIN_THREADS, 0, st>>>(
      io, n, nt, status, (unsigned int*)(status + nt));
  return (int)cudaGetLastError();
}

// flags (n uint8, a segment starts where nonzero), scratch
// (qk_chain_scratch(n, 2) words, zeroed here); start and end (n int32):
// each row's last flagged row at or before it (-1 where none) and its next
// flagged row after it less one (n - 1 where none).
int qk_segment_bounds(const void* flags, long long n, void* scratch, void* start, void* end,
                      void* stream) {
  if (n < 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (n + QK_CHAIN_TILE - 1) / QK_CHAIN_TILE;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (size_t)qk_chain_scratch(n, 2), st);
  if (err != cudaSuccess) return (int)err;
  const bool vec = qk_aligned16(flags) && qk_aligned16(start) && qk_aligned16(end);
  QkBoundsIo<false> fwd = {(const uint8_t*)flags, (int32_t*)start, (int32_t)n, vec};
  QkBoundsIo<true> bwd = {(const uint8_t*)flags, (int32_t*)end, (int32_t)n, vec};
  unsigned long long* status = (unsigned long long*)scratch;
  qk_bounds_chain_kernel<<<(unsigned int)(2 * nt), QK_CHAIN_THREADS, 0, st>>>(
      fwd, bwd, n, nt, status, (unsigned int*)(status + 2 * nt));
  return (int)cudaGetLastError();
}

}  // extern "C"
