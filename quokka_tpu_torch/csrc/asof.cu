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
// to i.  What bounds it: bytes (5 B read twice, 4 B written per row).
// Design: reduce, then scan.  Pass 1 reduces each block of 1024 rows to
// one (value, started) pair; pass 2, one block, scans those pairs into an
// exclusive carry per block; pass 3 scans each block again with its carry
// combined into its first row.  The combine, (a, b) -> b.started ? b.value
// : max(a.value, b.value), is associative, so every order of combination
// gives the reference's result exactly (integers, no rounding).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "search.cuh"

#define QK_SCAN_THREADS 1024
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

// -- K19: segmented fill-forward (running max) ------------------------------

__device__ __forceinline__ void qk_fill_combine(int32_t av, bool as, int32_t* bv,
                                                bool* bs) {
  // (a, b) -> (b.started ? b.value : max(a.value, b.value), a.started | b.started)
  if (!*bs) *bv = av > *bv ? av : *bv;
  *bs = as || *bs;
}

// inclusive scan of (x, s) across the block; every thread gets its prefix
__device__ __forceinline__ void qk_block_scan(int32_t* x, bool* s, int32_t* sv,
                                             uint8_t* ss) {
  int t = threadIdx.x;
  sv[t] = *x;
  ss[t] = *s;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    int32_t pv = INT_MIN;
    bool ps = false;
    if (t >= off) {
      pv = sv[t - off];
      ps = ss[t - off];
    }
    __syncthreads();
    if (t >= off) {
      qk_fill_combine(pv, ps, x, s);
      sv[t] = *x;
      ss[t] = *s;
    }
    __syncthreads();
  }
}

__global__ void qk_fill_reduce_kernel(const int32_t* __restrict__ values,
                                      const uint8_t* __restrict__ starts, int64_t n,
                                      int32_t* __restrict__ agg_v,
                                      uint8_t* __restrict__ agg_s) {
  __shared__ int32_t sv[QK_SCAN_THREADS];
  __shared__ uint8_t ss[QK_SCAN_THREADS];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t x = i < n ? values[i] : INT_MIN;
  bool s = i < n ? starts[i] != 0 : false;
  qk_block_scan(&x, &s, sv, ss);
  if (threadIdx.x == blockDim.x - 1) {
    agg_v[blockIdx.x] = x;
    agg_s[blockIdx.x] = s ? 1 : 0;
  }
}

// one block: the exclusive carry into every block of pass 1
__global__ void qk_fill_carry_kernel(const int32_t* __restrict__ agg_v,
                                     const uint8_t* __restrict__ agg_s, int64_t nb,
                                     int32_t* __restrict__ carry_v,
                                     uint8_t* __restrict__ carry_s) {
  __shared__ int32_t sv[QK_SCAN_THREADS];
  __shared__ uint8_t ss[QK_SCAN_THREADS];
  int t = threadIdx.x;
  int64_t chunk = (nb + blockDim.x - 1) / blockDim.x;
  int64_t b0 = (int64_t)t * chunk;
  int64_t b1 = b0 + chunk < nb ? b0 + chunk : nb;
  int32_t x = INT_MIN;
  bool s = false;
  for (int64_t b = b0; b < b1; ++b) {
    int32_t v = agg_v[b];
    bool f = agg_s[b] != 0;
    qk_fill_combine(x, s, &v, &f);
    x = v;
    s = f;
  }
  qk_block_scan(&x, &s, sv, ss);
  // exclusive prefix of this thread's chunk
  int32_t cv = INT_MIN;
  bool cs = false;
  if (t > 0) {
    cv = sv[t - 1];
    cs = ss[t - 1] != 0;
  }
  for (int64_t b = b0; b < b1; ++b) {
    carry_v[b] = cv;
    carry_s[b] = cs ? 1 : 0;
    int32_t v = agg_v[b];
    bool f = agg_s[b] != 0;
    qk_fill_combine(cv, cs, &v, &f);
    cv = v;
    cs = f;
  }
}

__global__ void qk_fill_scan_kernel(const int32_t* __restrict__ values,
                                    const uint8_t* __restrict__ starts, int64_t n,
                                    const int32_t* __restrict__ carry_v,
                                    const uint8_t* __restrict__ carry_s,
                                    int32_t* __restrict__ out) {
  __shared__ int32_t sv[QK_SCAN_THREADS];
  __shared__ uint8_t ss[QK_SCAN_THREADS];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t x = i < n ? values[i] : INT_MIN;
  bool s = i < n ? starts[i] != 0 : false;
  if (threadIdx.x == 0) qk_fill_combine(carry_v[blockIdx.x], carry_s[blockIdx.x] != 0,
                                        &x, &s);
  qk_block_scan(&x, &s, sv, ss);
  if (i < n) out[i] = x;
}

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

// values (n int32), starts (n uint8); scratch: agg_v, carry_v (nb int32),
// agg_s, carry_s (nb uint8) with nb = ceil(n / 1024).  out (n int32).
int qk_seg_fill_forward(const void* values, const void* starts, long long n,
                        void* agg_v, void* agg_s, void* carry_v, void* carry_s,
                        void* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  long long nb = (n + QK_SCAN_THREADS - 1) / QK_SCAN_THREADS;
  qk_fill_reduce_kernel<<<(unsigned int)nb, QK_SCAN_THREADS, 0, st>>>(
      (const int32_t*)values, (const uint8_t*)starts, n, (int32_t*)agg_v,
      (uint8_t*)agg_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_fill_carry_kernel<<<1, QK_SCAN_THREADS, 0, st>>>(
      (const int32_t*)agg_v, (const uint8_t*)agg_s, nb, (int32_t*)carry_v,
      (uint8_t*)carry_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_fill_scan_kernel<<<(unsigned int)nb, QK_SCAN_THREADS, 0, st>>>(
      (const int32_t*)values, (const uint8_t*)starts, n, (const int32_t*)carry_v,
      (const uint8_t*)carry_s, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
