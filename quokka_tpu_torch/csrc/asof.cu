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
// What bounds K18: bytes, and the latency of the dependent random reads.
// Each trade row reads its limbs and validity once and writes a quote index
// (4 B) and a flag (1 B); the search reads about log2(n_valid) sorted quote
// positions per row, whose first levels every row shares (L1 and L2).
// Design: one thread per trade row runs the whole search in registers
// (the XLA program walks all rows in lockstep, one gathered level per
// step).  Limbs keep their dtypes (int32 hash limbs, int64 or float64
// times, ...), and every comparison is IEEE `<` / `==` per limb,
// lexicographic across limbs, as the reference's _lex_lt_eq.
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

#define QK_MAX_LIMBS 16
#define QK_SCAN_THREADS 1024

struct TypedLimbs {
  const void* p[QK_MAX_LIMBS];
  int dt[QK_MAX_LIMBS];  // 0 f64, 1 f32, 2 i64, 3 i32, 4 bool (u8)
  int n;
};

template <typename T>
__device__ __forceinline__ void qk_cmp(const void* a, int64_t ia, const void* b,
                                       int64_t ib, bool* lt, bool* eq) {
  T x = ((const T*)a)[ia];
  T y = ((const T*)b)[ib];
  *lt = x < y;
  *eq = x == y;
}

__device__ __forceinline__ void qk_cmp_limb(int dt, const void* a, int64_t ia,
                                            const void* b, int64_t ib, bool* l,
                                            bool* e) {
  switch (dt) {
    case 0: qk_cmp<double>(a, ia, b, ib, l, e); break;
    case 1: qk_cmp<float>(a, ia, b, ib, l, e); break;
    case 2: qk_cmp<long long>(a, ia, b, ib, l, e); break;
    case 3: qk_cmp<int32_t>(a, ia, b, ib, l, e); break;
    default: qk_cmp<uint8_t>(a, ia, b, ib, l, e); break;
  }
}

// lexicographic (sorted[ia] < probe[ib], sorted[ia] == probe[ib]) over the
// first n limbs
__device__ __forceinline__ void qk_lex(const TypedLimbs& S, int64_t ia,
                                       const TypedLimbs& P, int64_t ib, int n,
                                       bool* out_lt, bool* out_eq) {
  bool lt = false, eq = true;
  for (int j = 0; j < n; ++j) {
    bool l, e;
    qk_cmp_limb(S.dt[j], S.p[j], ia, P.p[j], ib, &l, &e);
    lt = lt || (eq && l);
    eq = eq && e;
  }
  *out_lt = lt;
  *out_eq = eq;
}

__global__ void qk_asof_probe_kernel(TypedLimbs S, TypedLimbs P, int nkey, int upper,
                                     const int32_t* __restrict__ perm,
                                     const long long* __restrict__ n_valid_p,
                                     int64_t nq, const uint8_t* __restrict__ valid,
                                     int64_t p, int32_t* __restrict__ quote_idx,
                                     uint8_t* __restrict__ matched) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  int64_t n_valid = *n_valid_p;
  int64_t lo = 0, hi = n_valid;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    bool lt, eq;
    qk_lex(S, mid, P, i, S.n, &lt, &eq);
    // backward: quote[mid] <= probe goes right; forward: quote[mid] < probe
    bool right = upper ? (lt || eq) : lt;
    if (right) lo = mid + 1;
    else hi = mid;
  }
  int64_t pos = upper ? lo - 1 : lo;
  bool in_range = pos >= 0 && pos < n_valid;
  int64_t cpos = pos < 0 ? 0 : (pos > nq - 1 ? nq - 1 : pos);
  bool keq = true;
  for (int j = 0; j < nkey; ++j) {
    bool l, e;
    qk_cmp_limb(S.dt[j], S.p[j], cpos, P.p[j], i, &l, &e);
    keq = keq && e;
  }
  int32_t q = perm[cpos];
  quote_idx[i] = q < 0 ? 0 : (q > nq - 1 ? (int32_t)(nq - 1) : q);
  matched[i] = (valid[i] && in_range && keq) ? 1 : 0;
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

// sorted (n_limbs arrays of nq rows: nkey key limbs then the time limb),
// probe (n_limbs arrays of p rows, same dtypes dts), perm (nq int32),
// n_valid (one int64 on the device), valid (p uint8).  upper != 0 is the
// backward search.  quote_idx (p int32) and matched (p uint8) are outputs.
int qk_asof_probe(const void* const* sorted, const void* const* probe, const int* dts,
                  int n_limbs, int nkey, int upper, const void* perm,
                  const void* n_valid, long long nq, const void* valid, long long p,
                  void* quote_idx, void* matched, void* stream) {
  if (n_limbs < 1 || n_limbs > QK_MAX_LIMBS || nkey < 0 || nkey >= n_limbs || nq < 1)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  TypedLimbs S, P;
  S.n = P.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    S.p[j] = sorted[j];
    P.p[j] = probe[j];
    S.dt[j] = P.dt[j] = dts[j];
  }
  int threads = 256;
  unsigned int blocks = (unsigned int)((p + threads - 1) / threads);
  qk_asof_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      S, P, nkey, upper, (const int32_t*)perm, (const long long*)n_valid, nq,
      (const uint8_t*)valid, p, (int32_t*)quote_idx, (uint8_t*)matched);
  return (int)cudaGetLastError();
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
