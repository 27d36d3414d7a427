// Hash group-by and PK-join probe for Hopper (sm_90a): open-addressing
// insert + segment aggregates (K3), and the PK probe (K11).  K3 replaces
// quokka_tpu/ops/hashtable.py:_hash_groupby_body (its _insert_body lockstep
// while_loop and kernels._segment_aggs_body); K11 replaces build_table's
// insert (hashtable.py:348) and _probe_body (hashtable.py:236).
//
// What bounds it: bytes.  Each row reads its key limbs (4 B each) and
// validity once, probes a table at load factor <= 0.5 (a few random 4 B
// reads, mostly L2-resident at Q1's sizes), and each aggregate reads its
// input once and issues one atomic into a per-group slot.  Random access
// and atomic contention on few groups, not arithmetic, set the time.
//
// Design: the reference inserts all rows in lockstep rounds with a
// claim-stable scatter-min, because XLA has no per-row atomics.  Here every
// row walks its own probe sequence (double hash, odd stride) and claims an
// EMPTY slot with atomicCAS, or joins the slot whose row holds equal limbs.
// Claims are never undone and equal keys share one probe sequence, so equal
// keys always meet on one slot.  The walk is capped at 2*cap probes; a row
// that exhausts it sets the device flag `failed`, and the wrapper raises.
// Group ranks come from a cumulative sum over occupied slots (torch), then
// the segment kernel adds counts, sums and NaN-aware float counts with
// atomicAdd, min/max with compare-and-swap loops (NaN propagates, as XLA's
// segment_min/max do), and the smallest row id as the representative.

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_LIMBS 16
#define QK_MAX_AGGS 32
#define QK_EMPTY 0x7fffffff

struct Limbs {
  const int32_t* p[QK_MAX_LIMBS];
  int n;
};

struct Aggs {
  const void* in[QK_MAX_AGGS];
  void* out[QK_MAX_AGGS];
  int op[QK_MAX_AGGS];  // 0 sum, 1 count, 2 min, 3 max
  int dt[QK_MAX_AGGS];  // 0 f64, 1 f32, 2 i64, 3 i32
  int k;
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

__global__ void qk_insert_kernel(Limbs L, const uint8_t* __restrict__ valid,
                                 int64_t n, int32_t* table, uint32_t mask,
                                 int32_t* __restrict__ myslot, int32_t* failed) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
    if (myslot) myslot[i] = 0;
    return;
  }
  uint32_t h = qk_hash(L, i);
  uint32_t slot = (h ^ (h >> 15)) & mask;
  uint32_t stride = ((h >> 7) | 1u) & mask;  // odd: visits every slot
  uint64_t cap = (uint64_t)mask + 1;
  for (uint64_t probe = 0; probe < 2 * cap; ++probe) {
    int32_t prev = atomicCAS(&table[slot], QK_EMPTY, (int32_t)i);
    if (prev == QK_EMPTY) {
      if (myslot) myslot[i] = (int32_t)slot;
      return;
    }
    bool eq = true;
    for (int j = 0; j < L.n; ++j) {
      if (L.p[j][prev] != L.p[j][i]) {
        eq = false;
        break;
      }
    }
    if (eq) {
      if (myslot) myslot[i] = (int32_t)slot;
      return;
    }
    slot = (slot + stride) & mask;
  }
  if (myslot) myslot[i] = 0;
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

__device__ __forceinline__ double qk_pick(double cur, double v, bool is_min) {
  if (isnan(cur) || isnan(v)) return __longlong_as_double(0x7ff8000000000000LL);
  return is_min ? (v < cur ? v : cur) : (v > cur ? v : cur);
}

__device__ void qk_minmax_f64(double* addr, double v, bool is_min) {
  unsigned long long* a = (unsigned long long*)addr;
  unsigned long long old = *a;
  while (true) {
    double nv = qk_pick(__longlong_as_double((long long)old), v, is_min);
    unsigned long long nb = (unsigned long long)__double_as_longlong(nv);
    if (nb == old) return;
    unsigned long long prev = atomicCAS(a, old, nb);
    if (prev == old) return;
    old = prev;
  }
}

__device__ void qk_minmax_f32(float* addr, float v, bool is_min) {
  unsigned int* a = (unsigned int*)addr;
  unsigned int old = *a;
  while (true) {
    float cur = __uint_as_float(old);
    float nv;
    if (isnan(cur) || isnan(v)) nv = __uint_as_float(0x7fc00000u);
    else nv = is_min ? (v < cur ? v : cur) : (v > cur ? v : cur);
    unsigned int nb = __float_as_uint(nv);
    if (nb == old) return;
    unsigned int prev = atomicCAS(a, old, nb);
    if (prev == old) return;
    old = prev;
  }
}

__global__ void qk_segment_kernel(const int32_t* __restrict__ myslot,
                                  const int64_t* __restrict__ rank_of_slot,
                                  const uint8_t* __restrict__ valid, int64_t n,
                                  int32_t* counts, int32_t* rep, Aggs A) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  int64_t r = rank_of_slot[myslot[i]];
  atomicAdd(&counts[r], 1);
  atomicMin(&rep[r], (int32_t)i);
  for (int a = 0; a < A.k; ++a) {
    int op = A.op[a];
    switch (A.dt[a]) {
      case 0: {
        double v = ((const double*)A.in[a])[i];
        if (op == 0) atomicAdd(((double*)A.out[a]) + r, v);
        else if (op == 1) { if (!isnan(v)) atomicAdd(((int32_t*)A.out[a]) + r, 1); }
        else qk_minmax_f64(((double*)A.out[a]) + r, v, op == 2);
        break;
      }
      case 1: {
        float v = ((const float*)A.in[a])[i];
        if (op == 0) atomicAdd(((float*)A.out[a]) + r, v);
        else if (op == 1) { if (!isnan(v)) atomicAdd(((int32_t*)A.out[a]) + r, 1); }
        else qk_minmax_f32(((float*)A.out[a]) + r, v, op == 2);
        break;
      }
      case 2: {
        long long v = ((const long long*)A.in[a])[i];
        long long* o = ((long long*)A.out[a]) + r;
        if (op == 0) atomicAdd((unsigned long long*)o, (unsigned long long)v);
        else if (op == 1) atomicAdd(((int32_t*)A.out[a]) + r, 1);
        else if (op == 2) atomicMin(o, v);
        else atomicMax(o, v);
        break;
      }
      default: {
        int32_t v = ((const int32_t*)A.in[a])[i];
        int32_t* o = ((int32_t*)A.out[a]) + r;
        if (op == 0) atomicAdd(o, v);
        else if (op == 1) atomicAdd(o, 1);
        else if (op == 2) atomicMin(o, v);
        else atomicMax(o, v);
        break;
      }
    }
  }
}

extern "C" {

// table (cap int32, filled with QK_EMPTY by the caller), myslot (n int32)
// and failed (one int32, zeroed by the caller) are outputs.
int qk_hash_insert(const void* const* limbs, int n_limbs, const void* valid,
                   long long n, void* table, unsigned int mask, void* myslot,
                   void* failed, void* stream) {
  if (n_limbs < 1 || n_limbs > QK_MAX_LIMBS) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Limbs L;
  L.n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) L.p[j] = (const int32_t*)limbs[j];
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  qk_insert_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      L, (const uint8_t*)valid, n, (int32_t*)table, mask, (int32_t*)myslot,
      (int32_t*)failed);
  return (int)cudaGetLastError();
}

// K11 build: the insert alone.  table (cap int32, filled with QK_EMPTY) and
// failed (one int32, zeroed) are outputs.
int qk_hash_build(const void* const* limbs, int n_limbs, const void* valid,
                  long long n, void* table, unsigned int mask, void* failed,
                  void* stream) {
  return qk_hash_insert(limbs, n_limbs, valid, n, table, mask, nullptr, failed,
                        stream);
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

// counts (n int32, zeroed), rep (n int32, filled with n-1) and every out[a]
// (initialised by the caller to the op's identity) are outputs.
int qk_segment_aggs(const void* myslot, const void* rank_of_slot,
                    const void* valid, long long n, void* counts, void* rep,
                    int k, const void* const* ins, void* const* outs,
                    const int* ops, const int* dtypes, void* stream) {
  if (k < 0 || k > QK_MAX_AGGS) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Aggs A;
  A.k = k;
  for (int a = 0; a < k; ++a) {
    A.in[a] = ins[a];
    A.out[a] = outs[a];
    A.op[a] = ops[a];
    A.dt[a] = dtypes[a];
  }
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  qk_segment_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)myslot, (const int64_t*)rank_of_slot,
      (const uint8_t*)valid, n, (int32_t*)counts, (int32_t*)rep, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
