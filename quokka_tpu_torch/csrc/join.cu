// Sorted-build PK-join probe for Hopper (sm_90a): kernel K12.  Replaces
// quokka_tpu/ops/join.py:_pk_probe_sorted (a vectorised lexicographic
// lower bound over the sorted build limbs, `steps` unrolled halvings with
// one gather per limb per step).
//
// What bounds it: the throughput of the search's scattered reads.  Each
// probe row reads its limbs and ok flag once and writes build_idx (4 B) and
// matched (1 B); the search reads about log2(n_valid) build positions per
// row, whose first levels every row shares (they stay in L1 and L2).  At
// Q3 SF1 the sorted build (2^19 rows x 8 B) fits in the 50 MB L2.  On the
// card a 4-ary search (half the dependent reads, 1.5x the reads) and pivots
// staged in shared memory were both slower than this one (PERF.md §6).
//
// Design: one thread per probe row runs search.cuh's typed lower bound in
// registers (the XLA program walks all rows in lockstep, one gathered
// level per step): the limbs' dtypes are template arguments (no `switch`
// per level), positions are 32-bit, every limb of a level is loaded before
// the comparison, and the equality seen at the last failed test is the
// equality at the result, so the build is read once per level and never
// again at `pos`.  Signatures int64, float64, int32 and two int32 limbs
// are compiled typed; any other takes the runtime-dispatch kernel (QkDyn),
// which the wrapper counts apart.  Comparisons are the reference's: IEEE
// `<` and `==` per limb, lexicographic across limbs (a NaN limb is neither
// less nor equal, so -0.0 equals +0.0 and NaN matches nothing).  The build
// was sorted by stable torch sorts with invalid rows last and the row id
// as the implicit last key, so perm[pos] is the smallest build row of the
// key.
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
#include <limits.h>
#include <stdint.h>

#include "search.cuh"

#define QK_PROBE_THREADS 256

// -- K12 ------------------------------------------------------------------------

template <class Src, class Probe>
__global__ void __launch_bounds__(QK_PROBE_THREADS)
    qk_sorted_probe_kernel(Src build, Probe probe, const int32_t* __restrict__ perm,
                           const long long* __restrict__ n_valid_p, uint32_t nb,
                           const uint8_t* __restrict__ ok, uint32_t p,
                           int32_t* __restrict__ build_idx, uint8_t* __restrict__ matched) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const uint32_t n_valid = (uint32_t)*n_valid_p;
  bool eq;
  const uint32_t lo = qk_bound<false>(build, 0, n_valid, probe.load(i), &eq);
  const uint32_t pos = lo > nb - 1 ? nb - 1 : lo;
  const int32_t b = perm[pos];
  build_idx[i] = b < 0 ? 0 : (b > (int32_t)(nb - 1) ? (int32_t)(nb - 1) : b);
  matched[i] = (ok[i] && eq) ? 1 : 0;
}

struct QkProbeArgs {
  const void* const* sorted;
  const void* const* probe;
  const int32_t* perm;
  const long long* n_valid;
  uint32_t nb;
  const uint8_t* ok;
  uint32_t p;
  int32_t* build_idx;
  uint8_t* matched;
  cudaStream_t stream;
};

static unsigned int qk_probe_blocks(uint32_t n) {
  return (unsigned int)((n + QK_PROBE_THREADS - 1) / QK_PROBE_THREADS);
}

template <class Src, class Probe>
static int qk_sorted_probe_launch(const QkProbeArgs& a, const Src& build, const Probe& probe) {
  qk_sorted_probe_kernel<Src, Probe><<<qk_probe_blocks(a.p), QK_PROBE_THREADS, 0, a.stream>>>(
      build, probe, a.perm, a.n_valid, a.nb, a.ok, a.p, a.build_idx, a.matched);
  return (int)cudaGetLastError();
}

template <class Cols>
static int qk_sorted_probe_typed(const QkProbeArgs& a) {
  return qk_sorted_probe_launch(a, Cols::at(a.sorted), Cols::at(a.probe));
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
// ok (p uint8).  build_idx (p int32) and matched (p uint8) are outputs;
// *typed is 1 when a typed kernel ran, 0 when the runtime-dispatch one did.
int qk_sorted_probe(const void* const* sorted, const void* const* probe,
                    const int* dts, int n_limbs, const void* perm,
                    const void* n_valid, long long nb, const void* ok,
                    long long p, void* build_idx, void* matched, int* typed, void* stream) {
  *typed = 0;
  if (n_limbs < 1 || n_limbs > QK_MAX_LIMBS || nb < 1 || nb > INT_MAX || p < 0 || p > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  QkProbeArgs a;
  a.sorted = sorted;
  a.probe = probe;
  a.perm = (const int32_t*)perm;
  a.n_valid = (const long long*)n_valid;
  a.nb = (uint32_t)nb;
  a.ok = (const uint8_t*)ok;
  a.p = (uint32_t)p;
  a.build_idx = (int32_t*)build_idx;
  a.matched = (uint8_t*)matched;
  a.stream = (cudaStream_t)stream;
  *typed = 1;
  if (n_limbs == 1 && dts[0] == QK_I64) return qk_sorted_probe_typed<QkCols<long long> >(a);
  if (n_limbs == 1 && dts[0] == QK_F64) return qk_sorted_probe_typed<QkCols<double> >(a);
  if (n_limbs == 1 && dts[0] == QK_I32) return qk_sorted_probe_typed<QkCols<int32_t> >(a);
  if (n_limbs == 2 && dts[0] == QK_I32 && dts[1] == QK_I32)
    return qk_sorted_probe_typed<QkCols<int32_t, int32_t> >(a);
  *typed = 0;
  QkDyn k;
  k.S.n = k.P.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    k.S.p[j] = sorted[j];
    k.P.p[j] = probe[j];
    k.S.dt[j] = k.P.dt[j] = dts[j];
  }
  return qk_sorted_probe_launch(a, k, k);
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
