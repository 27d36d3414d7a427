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
// reads one sorted build position; each probe row with an output row
// reads its cumsum entry, rank, flag and its rank's offset once.  The
// first design gave each output row a thread that ran an 18-level binary
// search over the 2^18-entry cumsum in device memory and then three more
// dependent gathers (rp, offsets, build_pos_sorted): about 21 dependent
// loads a row against 17 bytes of real traffic, so latency bound it.
//
// Design: a merge-path load-balanced search.  The output rows 0 .. out_n
// - 1 and the probe rows' inclusive cumsum are two sorted sequences
// (probe row k ends before output row j when cum[k] <= j); each block
// owns QK_MM_ITEMS items of their merge.  Its first two warps find the
// block's two diagonals (the first probe row k with cum[k] + k >= d) by
// 33-way splits, one coalesced load a lane a step, so 4-5 dependent loads
// for 2^18 probe rows.  The block then loads its slice of cum, and of
// offsets[rp] and the left join's flags for those probe rows, coalesced
// into shared memory (at most QK_MM_ITEMS + 2 entries however skewed the
// counts are: one probe key x 10^4 build rows is 10^4 output items spread
// over blocks, a long run of probe rows with no match is as many probe
// items).  Each thread finds its own diagonal in the slice and walks its
// QK_MM_VT merged items there, writing each output row's probe row to
// shared memory; then neighbouring threads write neighbouring output
// rows, and the consecutive build positions of one probe row are read
// from build_pos_sorted as a coalesced run.  Row j lands at index j, so
// the output order is the reference's: probe row first, then the key's
// build rows in ascending row order.  Out-of-range positions are clipped
// exactly as the XLA program clips them (past the last probe row's end
// every row takes the last probe row), so padding rows agree too.

//
// Rank PK match for Hopper (sm_90a): kernel K14.  Replaces
// quokka_tpu/ops/join.py:129 `_pk_match` after its dense rank (row 10,
// torch): over the ranks of p probe rows and b build rows, the least valid
// build row of every rank (a scatter-min), gathered back by probe rank:
// build_idx = clip(first[rp], 0, b - 1), matched = vp & (first[rp] < b).
// The reference's count[rp] > 0 is the same test: a rank has a valid build
// row exactly when its least valid build row exists.
//
// What bounds it: bytes.  The build pass reads each build row's rank (8 B)
// and validity (1 B) once; the probe pass reads each probe row's rank and
// validity once and writes build_idx (4 B) and matched (1 B).  Beyond the
// bound: one int32 per rank of scratch, zeroed, updated once per valid
// build row and read once per probe row.
//
// Design: one array, one memset, two launches (four probe rows a thread,
// 16-byte loads; the streamed inputs and outputs evict first from the L2,
// which keeps the array for the gathers).  The minimum is kept as
// (row - b), negative for every build row, so the zeroed array
// (cudaMemsetAsync) is the "no valid build row" state: first = stored + b
// reads b there, as the reference's jnp.full(n, b) does, and matched is
// stored != 0.  Min is order-free, so one atomicMin per valid build row
// gives an exact result that is the same every run; the probe pass reads
// one int32 per row.  At mesh Q3's largest call (n = 2^23 + 2^21) the
// array is 41.9 MB, inside the card's 50 MB L2, so the probe's gathers
// mostly hit the L2; the per-rank count this kernel kept before doubled
// the scratch, the memset, the atomics and the gathers for a test the
// minimum already answers.

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

#define QK_MM_THREADS 256
#define QK_MM_VT 8                                // merged items a thread
#define QK_MM_ITEMS (QK_MM_THREADS * QK_MM_VT)    // merged items a block

// The merge path at diagonal d of the output rows 0 .. out_n - 1 and the
// probe rows' ends: the probe rows among the first d merged items, the
// first k with cum[k] + k >= d (p if none), by one whole warp: 33-way
// splits of [lo, hi), then one lane a candidate.
__device__ __forceinline__ long long qk_mm_diag(const long long* __restrict__ cum, long long p,
                                                long long out_n, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d - out_n > 0 ? d - out_n : 0, hi = d < p ? d : p;
  while (hi - lo > 32) {
    const long long q = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned m = __ballot_sync(0xffffffffu, __ldg(cum + q) + q >= d);
    const int f = m == 0u ? 31 : __ffs(m) - 1;
    const long long qf = __shfl_sync(0xffffffffu, q, f);
    const long long qb = __shfl_sync(0xffffffffu, q, f > 0 ? f - 1 : 0);
    if (m == 0u) {
      lo = qf + 1;
    } else {
      hi = qf;
      lo = f > 0 ? qb + 1 : lo;
    }
  }
  const long long q = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, q < hi && __ldg(cum + q) + q >= d);
  return m == 0u ? hi : lo + __ffs(m) - 1;
}

// cum: inclusive cumsum of per-probe match counts (p int64); offsets: run
// start of each rank (int64, indexed by rank); build_pos_sorted: build rows
// sorted by rank (b int64); rp: rank of each probe row (p int64); total:
// one int64 on the device.  Outputs for j < out_n: probe_idx, build_idx
// (int32), out_valid (j < total) and, when unmatched_in is given,
// unmatched_out[j] = unmatched_in[probe_idx[j]].
__global__ void __launch_bounds__(QK_MM_THREADS)
    qk_mm_expand_kernel(const long long* __restrict__ cum, int64_t p,
                        const long long* __restrict__ offsets,
                        const long long* __restrict__ build_pos_sorted, int64_t b,
                        const long long* __restrict__ rp, const long long* __restrict__ total_p,
                        const uint8_t* __restrict__ unmatched_in, int64_t out_n,
                        int32_t* __restrict__ probe_idx, int32_t* __restrict__ build_idx,
                        uint8_t* __restrict__ out_valid, uint8_t* __restrict__ unmatched_out) {
  // the slice: probe rows lo_k .. hi_k (lo_k may be -1, whose end is 0)
  __shared__ long long s_cum[QK_MM_ITEMS + 2];
  __shared__ long long s_off[QK_MM_ITEMS + 2];  // offsets[rp[k]]
  __shared__ uint8_t s_unm[QK_MM_ITEMS + 2];
  __shared__ int32_t s_pi[QK_MM_ITEMS];         // each output row's probe row (p past the last)
  __shared__ long long s_k[2];
  const int tid = threadIdx.x, w = tid >> 5;
  const long long d0 = (long long)blockIdx.x * QK_MM_ITEMS;
  const long long d1 = d0 + QK_MM_ITEMS < out_n + p ? d0 + QK_MM_ITEMS : out_n + p;
  if (w < 2) {
    const long long k = qk_mm_diag(cum, p, out_n, w == 0 ? d0 : d1);
    if ((tid & 31) == 0) s_k[w] = k;
  }
  __syncthreads();
  const long long k0 = s_k[0], k1 = s_k[1];
  const long long i0 = d0 - k0;
  const int na = (int)(d1 - k1 - i0), nb = (int)(k1 - k0);
  const long long lo_k = (k0 < p - 1 ? k0 : p - 1) - 1;
  const long long hi_k = k1 < p - 1 ? k1 : p - 1;
  const int m = (int)(hi_k - lo_k + 1);
  for (int x = tid; x < m; x += QK_MM_THREADS) {
    const long long k = lo_k + x;
    s_cum[x] = k < 0 ? 0 : cum[k];
    s_off[x] = k < 0 ? 0 : offsets[rp[k]];
    s_unm[x] = (k < 0 || unmatched_in == nullptr) ? 0 : unmatched_in[k];
  }
  __syncthreads();
  // the thread's diagonal in the slice, then its walk: probe item x (the
  // block's (k0 + x)-th probe row ends) comes before output item a when
  // cum[k0 + x] <= i0 + a
  const int boff = (int)(k0 - lo_k);  // the slice index of probe row k0
  const int dt = tid * QK_MM_VT;
  if (dt < na + nb) {
    int lo = dt - na > 0 ? dt - na : 0, hi = dt < nb ? dt : nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cum[mid + boff] + mid >= i0 + dt) hi = mid;
      else lo = mid + 1;
    }
    int x = lo, a = dt - lo;
#pragma unroll
    for (int v = 0; v < QK_MM_VT; ++v) {
      if (a + x >= na + nb) break;
      if (x < nb && (a >= na || s_cum[x + boff] <= i0 + a)) {
        ++x;
      } else {
        s_pi[a] = (int32_t)(k0 + x);
        ++a;
      }
    }
  }
  __syncthreads();
  const long long total = *total_p;
  for (int a = tid; a < na; a += QK_MM_THREADS) {
    const long long j = i0 + a;
    const long long pi = s_pi[a] < p - 1 ? s_pi[a] : p - 1;
    const int x = (int)(pi - lo_k);
    long long bpos = s_off[x] + (j - s_cum[x - 1]);
    bpos = bpos < 0 ? 0 : (bpos > b - 1 ? b - 1 : bpos);
    probe_idx[j] = (int32_t)pi;
    build_idx[j] = (int32_t)build_pos_sorted[bpos];
    out_valid[j] = j < total ? 1 : 0;
    if (unmatched_out != nullptr) unmatched_out[j] = s_unm[x];
  }
}

// K14 build pass: rank r's least valid build row, kept as row - b.  The
// ranks and validity stream past the L2 (evict-first loads), which keeps
// the array.
__global__ void qk_pk_first_kernel(const long long* __restrict__ rb,
                                   const uint8_t* __restrict__ vb, int64_t b, int64_t n,
                                   int32_t* first_minus_b) {
  int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b || !__ldcs(vb + j)) return;
  long long r = __ldcs(rb + j);
  if (r < 0 || r >= n) return;
  atomicMin(&first_minus_b[r], (int32_t)(j - b));
}

__device__ __forceinline__ void qk_pk_match_row(long long r, uint8_t v, int64_t n, int64_t b,
                                                const int32_t* __restrict__ first_minus_b,
                                                int32_t* idx, uint8_t* m) {
  const int32_t f = (r >= 0 && r < n) ? first_minus_b[r] : 0;
  const int64_t row = (int64_t)f + b;
  *idx = (int32_t)(row < 0 ? 0 : (row > b - 1 ? b - 1 : row));
  *m = (v && f != 0) ? 1 : 0;
}

// K14 probe pass: one gather by probe rank, four probe rows a thread with
// 16-byte loads and stores; the ranks, validity and outputs stream past the
// L2 (evict-first), the gathers hit the array there.  `vec` says that rp,
// build_idx (16 B) and vp, matched (4 B) are aligned for it.
__global__ void qk_pk_match_kernel(const long long* __restrict__ rp,
                                   const uint8_t* __restrict__ vp, int64_t p, int64_t n,
                                   int64_t b, const int32_t* __restrict__ first_minus_b,
                                   int32_t* __restrict__ build_idx,
                                   uint8_t* __restrict__ matched, int vec) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= p) return;
  if (vec && i + 4 <= p) {
    const longlong2 r01 = __ldcs((const longlong2*)(rp + i));
    const longlong2 r23 = __ldcs((const longlong2*)(rp + i + 2));
    const uint32_t v4 = __ldcs((const unsigned int*)(vp + i));
    int4 idx;
    uint8_t m[4];
    qk_pk_match_row(r01.x, v4 & 0xff, n, b, first_minus_b, &idx.x, m);
    qk_pk_match_row(r01.y, (v4 >> 8) & 0xff, n, b, first_minus_b, &idx.y, m + 1);
    qk_pk_match_row(r23.x, (v4 >> 16) & 0xff, n, b, first_minus_b, &idx.z, m + 2);
    qk_pk_match_row(r23.y, v4 >> 24, n, b, first_minus_b, &idx.w, m + 3);
    __stcs((int4*)(build_idx + i), idx);
    __stcs((unsigned int*)(matched + i),
           (unsigned int)m[0] | (unsigned int)m[1] << 8 | (unsigned int)m[2] << 16
               | (unsigned int)m[3] << 24);
    return;
  }
  for (int64_t k = i; k < i + 4 && k < p; ++k)
    qk_pk_match_row(__ldcs(rp + k), __ldcs(vp + k), n, b, first_minus_b, build_idx + k,
                    matched + k);
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
  if (p > 0x7fffffffLL || out_n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((out_n + p + QK_MM_ITEMS - 1) / QK_MM_ITEMS);
  qk_mm_expand_kernel<<<blocks, QK_MM_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)cum, p, (const long long*)offsets,
      (const long long*)build_pos_sorted, b, (const long long*)rp,
      (const long long*)total, (const uint8_t*)unmatched_in, out_n,
      (int32_t*)probe_idx, (int32_t*)build_idx, (uint8_t*)out_valid,
      (uint8_t*)unmatched_out);
  return (int)cudaGetLastError();
}

// K14.  rp (p int64) / vp (p uint8): the probe rows' ranks and validity; rb
// (b int64) / vb (b uint8): the build rows'; ranks lie in [0, n), n = p + b.
// first is n int32 of scratch; build_idx (p int32) and matched (p uint8)
// are the outputs.
int qk_pk_match(const void* rp, const void* vp, long long p, const void* rb,
                const void* vb, long long b, long long n, void* first, void* build_idx,
                void* matched, void* stream) {
  if (p < 0 || b < 1 || n != p + b || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(first, 0, sizeof(int32_t) * n, st);
  if (err != cudaSuccess) return (int)err;
  int threads = 256;
  qk_pk_first_kernel<<<(unsigned int)((b + threads - 1) / threads), threads, 0, st>>>(
      (const long long*)rb, (const uint8_t*)vb, b, n, (int32_t*)first);
  err = cudaGetLastError();
  if (err != cudaSuccess || p == 0) return (int)err;
  const int vec = ((uintptr_t)rp % 16 == 0 && (uintptr_t)build_idx % 16 == 0
                   && (uintptr_t)vp % 4 == 0 && (uintptr_t)matched % 4 == 0);
  const long long quads = (p + 3) / 4;
  qk_pk_match_kernel<<<(unsigned int)((quads + threads - 1) / threads), threads, 0, st>>>(
      (const long long*)rp, (const uint8_t*)vp, p, n, b, (const int32_t*)first,
      (int32_t*)build_idx, (uint8_t*)matched, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
