// Sorted-build PK-join probe for Hopper (sm_90a): kernel K12.  Replaces
// quokka_tpu/ops/join.py:_pk_probe_sorted (a vectorised lexicographic
// lower bound over the sorted build limbs, `steps` unrolled halvings with
// one gather per limb per step).
//
// What bounds it: bytes, and the latency of the dependent random reads.
// Each probe row reads its limbs and ok flag once and writes build_idx
// (4 B) and matched (1 B); the search reads about log2(n_valid) build
// positions per row, whose first levels every row shares (they stay in L1
// and L2).  At Q3 SF1 the sorted build (2^19 rows x 8 B) fits in the 50 MB
// L2.
//
// Design: one thread per probe row runs the whole lower bound in registers
// (the XLA program walks all rows in lockstep, one gathered level per
// step).  Limbs keep the build's raw dtypes (int32, int64, float32,
// float64, bool), so the comparisons are the reference's: IEEE `<` and
// `==` per limb, lexicographic across limbs (a NaN limb is neither less
// nor equal, so -0.0 equals +0.0 and NaN matches nothing).  The build was
// sorted by stable torch sorts with invalid rows last and the row id as
// the implicit last key, so perm[pos] is the smallest build row of the key.

//
// Many-to-many expand for Hopper (sm_90a): kernel K13.  Replaces
// quokka_tpu/ops/join.py:_mm_expand (a searchsorted of every output row
// into the inclusive cumsum of per-probe match counts, then gathers) and
// the gather half of :_is_unmatched_gather (a left join's per-output-row
// "no real match" flag).
//
// What bounds it: bytes.  Each output row writes probe_idx and build_idx
// (4 B each), out_valid and, for left joins, unmatched (1 B each), and
// reads one offset, one probe rank and one sorted build position; the
// search reads about log2(p) cumsum entries per output row, whose first
// levels every row shares and whose last levels neighbouring rows share
// (they stay in L1 and L2).
//
// Design: one thread per output row runs an upper-bound search over the
// cumsum in registers.  Output rows are spread evenly over threads however
// skewed the match counts are (one probe key matching 10^4 build rows
// costs 10^4 threads, not one thread 10^4 iterations), and row j lands at
// index j, so the output order is the reference's: probe row first, then
// the key's build rows in ascending row order.  Out-of-range positions are
// clipped exactly as the XLA program clips them, so padding rows agree
// too.

//
// Rank PK match for Hopper (sm_90a): kernel K14.  Replaces
// quokka_tpu/ops/join.py:129 `_pk_match` after its dense rank (row 10,
// torch): over the ranks of p probe rows and b build rows, the least valid
// build row of every rank (a scatter-min), the valid build rows per rank (a
// segment sum), both gathered back by probe rank:
// build_idx = clip(first[rp], 0, b - 1), matched = vp & (count[rp] > 0).
//
// What bounds it: bytes.  The build pass reads each build row's rank (8 B)
// and validity (1 B) once and updates two int32 counters of its rank; the
// probe pass reads each probe row's rank and validity once, gathers the two
// counters of its rank and writes build_idx (4 B) and matched (1 B).
//
// Design: two launches, a build pass and a probe pass.  Min and an integer
// count are order-free, so atomicMin and atomicAdd on int32 give an exact
// result that is the same every run.  The minimum is kept as (row - b),
// which is negative for every build row, so a zeroed array (cudaMemsetAsync)
// is the "no build row" state and first = stored + b reads b there, as the
// reference's jnp.full(n, b) does; both arrays start from one memset each.

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_LIMBS 16

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

// lexicographic (build[ia] < probe[ib], build[ia] == probe[ib])
__device__ __forceinline__ void qk_lex(const TypedLimbs& S, int64_t ia,
                                       const TypedLimbs& P, int64_t ib,
                                       bool* out_lt, bool* out_eq) {
  bool lt = false, eq = true;
  for (int j = 0; j < S.n; ++j) {
    bool l, e;
    switch (S.dt[j]) {
      case 0: qk_cmp<double>(S.p[j], ia, P.p[j], ib, &l, &e); break;
      case 1: qk_cmp<float>(S.p[j], ia, P.p[j], ib, &l, &e); break;
      case 2: qk_cmp<long long>(S.p[j], ia, P.p[j], ib, &l, &e); break;
      case 3: qk_cmp<int32_t>(S.p[j], ia, P.p[j], ib, &l, &e); break;
      default: qk_cmp<uint8_t>(S.p[j], ia, P.p[j], ib, &l, &e); break;
    }
    lt = lt || (eq && l);
    eq = eq && e;
  }
  *out_lt = lt;
  *out_eq = eq;
}

__global__ void qk_sorted_probe_kernel(TypedLimbs S, TypedLimbs P,
                                       const int32_t* __restrict__ perm,
                                       const long long* __restrict__ n_valid_p,
                                       int64_t nb, const uint8_t* __restrict__ ok,
                                       int64_t p, int32_t* __restrict__ build_idx,
                                       uint8_t* __restrict__ matched) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  int64_t n_valid = *n_valid_p;
  int64_t lo = 0, hi = n_valid;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    bool lt, eq;
    qk_lex(S, mid, P, i, &lt, &eq);
    if (lt) lo = mid + 1;
    else hi = mid;
  }
  int64_t pos = lo < 0 ? 0 : (lo > nb - 1 ? nb - 1 : lo);
  bool lt, eq;
  qk_lex(S, pos, P, i, &lt, &eq);
  int32_t b = perm[pos];
  build_idx[i] = b < 0 ? 0 : (b > nb - 1 ? (int32_t)(nb - 1) : b);
  matched[i] = (ok[i] && eq && lo < n_valid) ? 1 : 0;
}

// cum: inclusive cumsum of per-probe match counts (p int64); offsets: run
// start of each rank (int64, indexed by rank); build_pos_sorted: build rows
// sorted by rank (b int64); rp: rank of each probe row (p int64); total:
// one int64 on the device.  Outputs for j < out_n: probe_idx, build_idx
// (int32), out_valid (j < total) and, when unmatched_in is given,
// unmatched_out[j] = unmatched_in[probe_idx[j]].
__global__ void qk_mm_expand_kernel(const long long* __restrict__ cum, int64_t p,
                                    const long long* __restrict__ offsets,
                                    const long long* __restrict__ build_pos_sorted,
                                    int64_t b, const long long* __restrict__ rp,
                                    const long long* __restrict__ total_p,
                                    const uint8_t* __restrict__ unmatched_in,
                                    int64_t out_n, int32_t* __restrict__ probe_idx,
                                    int32_t* __restrict__ build_idx,
                                    uint8_t* __restrict__ out_valid,
                                    uint8_t* __restrict__ unmatched_out) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_n) return;
  // upper bound: the first probe row whose inclusive cumsum exceeds j
  int64_t lo = 0, hi = p;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (cum[mid] <= j) lo = mid + 1;
    else hi = mid;
  }
  int64_t pi = lo > p - 1 ? p - 1 : lo;
  int64_t start = pi > 0 ? cum[pi - 1] : 0;
  int64_t bpos = offsets[rp[pi]] + (j - start);
  bpos = bpos < 0 ? 0 : (bpos > b - 1 ? b - 1 : bpos);
  probe_idx[j] = (int32_t)pi;
  build_idx[j] = (int32_t)build_pos_sorted[bpos];
  out_valid[j] = j < *total_p ? 1 : 0;
  if (unmatched_out != nullptr) unmatched_out[j] = unmatched_in[pi];
}

// K14 build pass: rank r's least valid build row (kept as row - b) and count
__global__ void qk_pk_first_kernel(const long long* __restrict__ rb,
                                   const uint8_t* __restrict__ vb, int64_t b, int64_t n,
                                   int32_t* first_minus_b, int32_t* count) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b || !vb[j]) return;
  long long r = rb[j];
  if (r < 0 || r >= n) return;
  atomicMin(&first_minus_b[r], (int32_t)(j - b));
  atomicAdd(&count[r], 1);
}

// K14 probe pass: gather by probe rank
__global__ void qk_pk_match_kernel(const long long* __restrict__ rp,
                                   const uint8_t* __restrict__ vp, int64_t p, int64_t n,
                                   int64_t b, const int32_t* __restrict__ first_minus_b,
                                   const int32_t* __restrict__ count,
                                   int32_t* __restrict__ build_idx,
                                   uint8_t* __restrict__ matched) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  long long r = rp[i];
  bool in = r >= 0 && r < n;
  int64_t f = in ? (int64_t)first_minus_b[r] + b : b;
  int32_t c = in ? count[r] : 0;
  build_idx[i] = (int32_t)(f < 0 ? 0 : (f > b - 1 ? b - 1 : f));
  matched[i] = (vp[i] && c > 0) ? 1 : 0;
}

extern "C" {

// sorted (n_limbs arrays of nb rows, dtypes dts), probe (n_limbs arrays of
// p rows, same dtypes), perm (nb int32), n_valid (one int64 on the device),
// ok (p uint8).  build_idx (p int32) and matched (p uint8) are outputs.
int qk_sorted_probe(const void* const* sorted, const void* const* probe,
                    const int* dts, int n_limbs, const void* perm,
                    const void* n_valid, long long nb, const void* ok,
                    long long p, void* build_idx, void* matched, void* stream) {
  if (n_limbs < 1 || n_limbs > QK_MAX_LIMBS || nb < 1) return (int)cudaErrorInvalidValue;
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
  qk_sorted_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      S, P, (const int32_t*)perm, (const long long*)n_valid, nb,
      (const uint8_t*)ok, p, (int32_t*)build_idx, (uint8_t*)matched);
  return (int)cudaGetLastError();
}

int qk_mm_expand(const void* cum, long long p, const void* offsets,
                 const void* build_pos_sorted, long long b, const void* rp,
                 const void* total, const void* unmatched_in, long long out_n,
                 void* probe_idx, void* build_idx, void* out_valid,
                 void* unmatched_out, void* stream) {
  if (p < 1 || b < 1 || (unmatched_in == nullptr) != (unmatched_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (out_n == 0) return (int)cudaSuccess;
  int threads = 256;
  unsigned int blocks = (unsigned int)((out_n + threads - 1) / threads);
  qk_mm_expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)cum, p, (const long long*)offsets,
      (const long long*)build_pos_sorted, b, (const long long*)rp,
      (const long long*)total, (const uint8_t*)unmatched_in, out_n,
      (int32_t*)probe_idx, (int32_t*)build_idx, (uint8_t*)out_valid,
      (uint8_t*)unmatched_out);
  return (int)cudaGetLastError();
}

// K14.  rp (p int64) / vp (p uint8): the probe rows' ranks and validity; rb
// (b int64) / vb (b uint8): the build rows'; ranks lie in [0, n), n = p + b.
// first and count are n int32 each of scratch; build_idx (p int32) and
// matched (p uint8) are the outputs.
int qk_pk_match(const void* rp, const void* vp, long long p, const void* rb,
                const void* vb, long long b, long long n, void* first, void* count,
                void* build_idx, void* matched, void* stream) {
  if (p < 0 || b < 1 || n != p + b || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(first, 0, sizeof(int32_t) * n, st);
  cudaMemsetAsync(count, 0, sizeof(int32_t) * n, st);
  int threads = 256;
  qk_pk_first_kernel<<<(unsigned int)((b + threads - 1) / threads), threads, 0, st>>>(
      (const long long*)rb, (const uint8_t*)vb, b, n, (int32_t*)first, (int32_t*)count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p == 0) return (int)err;
  qk_pk_match_kernel<<<(unsigned int)((p + threads - 1) / threads), threads, 0, st>>>(
      (const long long*)rp, (const uint8_t*)vp, p, n, b, (const int32_t*)first,
      (const int32_t*)count, (int32_t*)build_idx, (uint8_t*)matched);
  return (int)cudaGetLastError();
}

}  // extern "C"
