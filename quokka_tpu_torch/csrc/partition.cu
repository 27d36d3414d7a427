// Partition kernels for Hopper (sm_90a): the hash split (K4), the compacted
// split's plan (K17) and the adaptive exchange's routing (K26).
//
// K4 replaces quokka_tpu/ops/kernels.py:_partition_ids and :_split_masks:
// one launch computes each row's partition id and writes every partition's
// validity mask and live count.  What bounds it: bytes.  A row reads its key
// limbs and validity once and writes its id (4 B) and one mask byte per
// partition; the hash is a few integer operations.  Counts are reduced per
// block in shared memory, so the global atomics are n_parts per block, not
// one per row.  The masks (and counts) may be skipped: the compacted split
// needs the ids alone.
//
// The hash is bit-identical to the reference's, quirks included: a float
// limb is converted to int32 by value (truncation, saturating, NaN -> 0, as
// XLA's convert does; qk_to_i32), an int64 limb keeps only its low 32 bits,
// a bool limb is 0/1, and all arithmetic is uint32 and wraps.
//
// K17 replaces quokka_tpu/ops/kernels.py:417 `_partition_plan`: a stable
// permutation grouping the valid rows by partition id, the invalid rows
// last in row order (the reference's lax.sort([where(valid, pid, P), iota],
// num_keys=2)), and each partition's count and start offset.  What bounds
// it: bytes, 14 per row (the id and validity read twice, the permutation
// written once).  Design, a memset and two launches on the 4096-row tiles
// that K8 shares (csrc/compact.cuh): (1) each block counts its tile's rows
// (16 a thread, read with 16-byte loads) per bucket (P parts + the invalid
// bucket), writes the counts as its tile's words and adds them to its
// group's words (g consecutive tiles, g the square root of the tiles
// rounded up, at least 16) and to P + 1 totals, one atomic a bucket each;
// (2) each block looks back for every bucket's rows in the tiles before
// it, all at once: the words of the groups before its own and of its
// group's earlier tiles, fewer than 2 g a bucket; it ranks its rows stably
// by bucket (up to six buckets counted in registers, a 10-bit field a
// bucket in one 64-bit word, and placed by one shuffle scan; more by 16
// rounds of warp peers by __match_any_sync), stages them in shared memory
// in bucket order and writes perm with consecutive threads on consecutive
// places, from each bucket's base (a scan of the totals) plus that prefix.
// No block waits on another: a decoupled look-back in one pass (K8's) cost
// about 4.5 us at 256 tiles that all start together, the walk over their
// aggregates, where two passes make every tile's counts known before the
// second starts.  No atomics place a row, so the permutation is stable and
// the same every run.  Scratch: a count a tile, a group and in all a
// bucket; no scan kernel.
//
// K26 replaces quokka_tpu/planner/adapt.py:57 `_salt_pids` and :77
// `_replicate_masks`, each with the hash in front: in salt mode a row of
// the fat partition is re-dealt to partition (row position mod P); in
// replicate mode part c's mask is (pid == c | pid == fat) & valid.  Masks
// and counts as K4 writes them.  Bound: bytes, as K4.

//
// K24 replaces quokka_tpu/parallel/mesh.py:61 `_hash_u32`, :72
// `_local_bucketize` and the all_to_all of :102 `collective_hash_shuffle`,
// for all P shards of a mesh on one card at once.  The input is a global
// batch of P shards of N rows (shard s = rows [s N, (s + 1) N)); every row
// of shard s whose key hashes to d (K4's hash, mod P) goes to row
// d P N + s N + pos of the output, pos its rank among the valid rows of
// shard s bound for d, in row order.  That is the reference's exchanged
// layout: destination d holds P frames of N rows, frame s from shard s,
// live rows first, the rest zero.  Invalid rows are dropped.  What bounds
// it: bytes.  The key limbs, validity and every carried column are read
// once (the ids are written and read back once, 8 B a row), and the
// P x P x N output frames are written once, zeroed first: the output is P
// times the input by the reference's static design.  Design: a stable
// counting sort in three launches, per shard: (1) each block hashes one
// tile of one shard, stores the ids and counts them per bucket (P parts
// + the invalid bucket) in shared memory; (2) one block scans the
// [shard][bucket][tile] counts, which gives every (shard, bucket, tile) its
// first position in the frame;
// (3) each block walks its tile again in row order, 256 rows a round, ranks
// a row among its warp's rows of the same bucket with __match_any_sync and
// a popcount, and copies every carried column of the row (1-, 4- or 8-byte
// leaves, from one descriptor table) to its output slot.  No atomics place
// a row, so positions are stable and the same every run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compact.cuh"

#define QK_MAX_LIMBS 16
#define QK_MAX_PARTS 64
#define QK_MESH_THREADS 256
#define QK_MESH_WARPS (QK_MESH_THREADS / 32)
#define QK_SCAN_THREADS 1024
#define QK_MESH_TILE 4096  // rows of one shard a block of K24 owns
#define QK_MESH_MAX_LEAVES 64

struct MeshLeaves {
  const void* src[QK_MESH_MAX_LEAVES];
  void* dst[QK_MESH_MAX_LEAVES];
  int width[QK_MESH_MAX_LEAVES];  // bytes per element: 1, 4 or 8
  int n;
};

struct PLimbs {
  const void* p[QK_MAX_LIMBS];
  int dt[QK_MAX_LIMBS];  // 0 f64, 1 f32, 2 i64, 3 i32, 4 bool
  int n;
};

// XLA's float -> int32 convert: truncate toward zero, saturate, NaN -> 0.
// Spelled out because the hardware conversion sends NaN to INT_MIN.
__device__ __forceinline__ int32_t qk_to_i32(double v) {
  if (isnan(v)) return 0;
  if (v >= 2147483647.0) return 2147483647;
  if (v <= -2147483648.0) return (int32_t)0x80000000u;
  return (int32_t)v;
}

__device__ __forceinline__ uint32_t qk_limb_u32(const PLimbs& L, int j, int64_t i) {
  switch (L.dt[j]) {
    case 0: return (uint32_t)qk_to_i32(((const double*)L.p[j])[i]);
    case 1: return (uint32_t)qk_to_i32((double)((const float*)L.p[j])[i]);
    case 2: return (uint32_t)(unsigned long long)((const long long*)L.p[j])[i];
    case 3: return (uint32_t)((const int32_t*)L.p[j])[i];
    default: return ((const uint8_t*)L.p[j])[i] ? 1u : 0u;
  }
}

// row i's partition: the hash of its limbs mod n_parts, or pids_in[i] when
// there are no limbs
__device__ __forceinline__ uint32_t qk_row_pid(const PLimbs& L, const int32_t* pids_in,
                                               int64_t i, int n_parts) {
  if (L.n == 0) return (uint32_t)pids_in[i];
  uint32_t h = 0u;
  for (int j = 0; j < L.n; ++j) {
    h = h * 0x9E3779B1u + qk_limb_u32(L, j, i);
    h = h ^ (h >> 16);
    h = h * 0x85EBCA6Bu;
    h = h ^ (h >> 13);
  }
  return h % (uint32_t)n_parts;
}

__global__ void qk_partition_kernel(PLimbs L, const int32_t* __restrict__ pids_in,
                                    const uint8_t* __restrict__ valid, int64_t n,
                                    int n_parts, int32_t* __restrict__ pids_out,
                                    uint8_t* __restrict__ masks, int32_t* counts) {
  __shared__ int32_t local[QK_MAX_PARTS];
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) local[p] = 0;
  __syncthreads();
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t pid = qk_row_pid(L, pids_in, i, n_parts);
    if (pids_out != nullptr) pids_out[i] = (int32_t)pid;
    if (masks != nullptr) {
      bool v = valid[i] != 0;
      for (int p = 0; p < n_parts; ++p)
        masks[(int64_t)p * n + i] = (v && (uint32_t)p == pid) ? 1 : 0;
      if (v && pid < (uint32_t)n_parts) atomicAdd(&local[pid], 1);
    }
  }
  __syncthreads();
  if (counts == nullptr) return;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
    if (local[p]) atomicAdd(&counts[p], local[p]);
  }
}

// K26: mode 1 salts the fat partition, mode 2 replicates it
__global__ void qk_adapt_kernel(PLimbs L, const int32_t* __restrict__ pids_in,
                                const uint8_t* __restrict__ valid, int64_t n, int n_parts,
                                int fat, int mode, int32_t* __restrict__ pids_out,
                                uint8_t* __restrict__ masks, int32_t* counts) {
  __shared__ int32_t local[QK_MAX_PARTS];
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) local[p] = 0;
  __syncthreads();
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t pid = qk_row_pid(L, pids_in, i, n_parts);
    const bool is_fat = pid == (uint32_t)fat;
    if (mode == 1 && is_fat) pid = (uint32_t)(i % n_parts);
    if (pids_out != nullptr) pids_out[i] = (int32_t)pid;
    if (masks != nullptr) {
      const bool v = valid[i] != 0;
      for (int p = 0; p < n_parts; ++p) {
        bool hit = v && ((uint32_t)p == pid || (mode == 2 && is_fat));
        masks[(int64_t)p * n + i] = hit ? 1 : 0;
        if (hit) atomicAdd(&local[p], 1);
      }
    }
  }
  __syncthreads();
  if (counts == nullptr) return;
  for (int p = threadIdx.x; p < n_parts; p += blockDim.x) {
    if (local[p]) atomicAdd(&counts[p], local[p]);
  }
}

// K17's bucket of a row: its id when valid, else n_parts (the invalid
// bucket).  An id outside [0, n_parts) is filed with the invalid rows, so no
// launch writes out of bounds.  Rows past n get -1.
__device__ __forceinline__ int qk_bucket(int32_t p, bool valid, int n_parts) {
  return (valid && (unsigned)p < (unsigned)n_parts) ? p : n_parts;
}

// the buckets of rows r0 .. r0 + 15, with 16-byte loads where the tile is
// whole and aligned; kStream reads them as the last pass does (evict first)
template <bool kStream>
__device__ __forceinline__ void qk_plan_buckets(const int32_t* __restrict__ pids,
                                                const uint8_t* __restrict__ valid, long long n,
                                                int n_parts, long long r0, int* bk) {
  if (n - r0 >= QK_CT_ITEMS && ((((uintptr_t)(pids + r0)) | ((uintptr_t)(valid + r0))) & 15u) == 0) {
    const uint4 f = kStream ? __ldcs((const uint4*)(valid + r0)) : __ldg((const uint4*)(valid + r0));
    const uint32_t x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const int4 p = kStream ? __ldcs((const int4*)(pids + r0) + q4) : __ldg((const int4*)(pids + r0) + q4);
      const int32_t id[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) bk[4 * q4 + e] = qk_bucket(id[e], ((x[q4] >> (8 * e)) & 0xffu) != 0, n_parts);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < QK_CT_ITEMS; ++q)
    bk[q] = r0 + q < n ? qk_bucket(pids[r0 + q], valid[r0 + q] != 0, n_parts) : -1;
}

// K17's rankings: up to QK_PLAN_SMALL buckets are counted in registers, a
// bucket a 10-bit field of one 64-bit word (a warp's 512 rows fit); more go
// through rounds of warp peers (__match_any_sync)
#define QK_PLAN_SMALL 6

__device__ __forceinline__ uint32_t qk_field(unsigned long long x, int b) {
  return (uint32_t)(x >> (10 * b)) & 1023u;
}

// K17 pass 1: each block counts its tile's rows per bucket in shared
// memory (a warp's counts by one shuffle reduction of packed fields, or a
// warp's rows of one bucket a round by one shared atomic), writes them as
// its tile's words and adds them to its group's words (a group is g
// consecutive tiles) and to the n_parts + 1 totals.
template <bool kSmall>
__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_plan_count_kernel(const int32_t* __restrict__ pids, const uint8_t* __restrict__ valid,
                         long long n, int n_parts, int g, uint32_t* __restrict__ tiles,
                         uint32_t* __restrict__ groups, uint32_t* __restrict__ totals) {
  __shared__ uint32_t h[QK_MAX_PARTS + 1];
  const int nb = n_parts + 1;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const long long k = blockIdx.x;
  for (int b = threadIdx.x; b < nb; b += QK_CT_THREADS) h[b] = 0;
  __syncthreads();
  int bk[QK_CT_ITEMS];
  qk_plan_buckets<false>(pids, valid, n, n_parts,
                         k * QK_CT_TILE + (long long)threadIdx.x * QK_CT_ITEMS, bk);
  if (kSmall) {
    unsigned long long c = 0;
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q)
      if (bk[q] >= 0) c += 1ull << (10 * bk[q]);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
    if (lane < nb && qk_field(c, lane)) atomicAdd(&h[lane], qk_field(c, lane));
  } else {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) {
      const unsigned peers = __match_any_sync(0xffffffffu, bk[q]);
      if (bk[q] >= 0 && (peers & lower) == 0) atomicAdd(&h[bk[q]], (uint32_t)__popc(peers));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += QK_CT_THREADS) {
    const uint32_t c = h[b];
    tiles[k * nb + b] = c;
    if (c) {
      atomicAdd(&groups[(k / g) * nb + b], c);
      atomicAdd(&totals[b], c);
    }
  }
}

struct QkPlanShared {
  uint32_t stage[QK_CT_TILE];                  // the tile's rows in bucket order: row | bucket << 16
  uint32_t bk[QK_CT_TILE / 4];                 // the tile's buckets, a byte a row (0xff past n)
  uint32_t wc[QK_CT_WARPS][QK_MAX_PARTS + 1];  // a warp's count a bucket, then its first place
  unsigned long long wtot[QK_CT_WARPS];        // a warp's packed counts
  uint32_t agg[QK_MAX_PARTS + 1], excl[QK_MAX_PARTS + 1], base[QK_MAX_PARTS + 1];
  uint32_t tstart[QK_MAX_PARTS + 1];  // bucket b's first place in the tile's bucket order
  int32_t dst[QK_MAX_PARTS + 1];      // perm index of the tile's place 0 of bucket b
  uint32_t rows;                      // the tile's rows before n
};

// K17 pass 2: each block ranks its tile's rows stably by bucket: with few
// buckets each thread counts its 16 rows in packed fields and one shuffle
// scan of the words gives every row its place; with more, warp w ranks
// rows w * 512 .. w * 512 + 511 in 16 rounds of 32 (a round's peers by
// __match_any_sync, a running count a bucket a warp).  The
// warps' counts become first places, the rows are staged in shared memory
// in bucket order, and the block writes perm with consecutive threads on
// consecutive places: bucket b's rows start at the sum of the totals of
// the buckets before b, plus bucket b's rows in the tiles before, which
// the block looks back for in pass 1's words, all at once: those of the
// groups before its own and of its group's tiles before it.  The first
// tile writes counts and offsets.
template <bool kSmall>
__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_plan_place_kernel(const int32_t* __restrict__ pids, const uint8_t* __restrict__ valid,
                         long long n, int n_parts, int g, const uint32_t* __restrict__ tiles,
                         const uint32_t* __restrict__ groups, const uint32_t* __restrict__ totals,
                         int32_t* __restrict__ perm, int32_t* __restrict__ counts,
                         int32_t* __restrict__ offsets) {
  __shared__ QkPlanShared sh;
  const long long k = blockIdx.x;
  const int nb = n_parts + 1;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long t0 = k * QK_CT_TILE;
  int bk[QK_CT_ITEMS];
  qk_plan_buckets<true>(pids, valid, n, n_parts, t0 + (long long)tid * QK_CT_ITEMS, bk);
  if (tid == 0) {
    uint32_t run = 0;
    for (int b = 0; b < nb; ++b) {
      sh.base[b] = run;
      run += totals[b];
    }
  }
  {  // the rows of the tiles before, a warp a bucket: whole groups, then
     // the group's own tiles
    const long long g0 = k / g, terms = g0 + (k - g0 * g);
    for (int b = w; b < nb; b += QK_CT_WARPS) {
      uint32_t c = 0;
      for (long long t = lane; t < terms; t += 32)
        c += t < g0 ? groups[t * nb + b] : tiles[(g0 * g + t - g0) * nb + b];
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
      if (lane == 0) sh.excl[b] = c;
    }
  }
  unsigned long long run = 0, inc = 0;  // kSmall: the thread's packed counts, their warp scan
  uint32_t rank[QK_CT_ITEMS];           // otherwise: each round's row's place in its warp
  if (kSmall) {
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q)
      if (bk[q] >= 0) run += 1ull << (10 * bk[q]);
    inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) sh.wtot[w] = inc;
    __syncthreads();
    if (tid < nb) {  // bucket tid: the warps' first places and the tile's count
      uint32_t c = 0;
#pragma unroll
      for (int u = 0; u < QK_CT_WARPS; ++u) {
        sh.wc[u][tid] = c;
        c += qk_field(sh.wtot[u], tid);
      }
      sh.agg[tid] = c;
    }
  } else {
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      uint32_t x = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) x |= (uint32_t)(bk[4 * q4 + e] & 0xff) << (8 * e);
      sh.bk[tid * 4 + q4] = x;
    }
    for (int b = lane; b < nb; b += 32) sh.wc[w][b] = 0;
    __syncthreads();
    const uint8_t* tb = (const uint8_t*)sh.bk;
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) {
      const int b = tb[w * 512 + q * 32 + lane];
      const bool have = b < nb;
      const unsigned peers = __match_any_sync(0xffffffffu, have ? b : -1);
      const uint32_t before = have ? sh.wc[w][b] : 0u;
      rank[q] = before + __popc(peers & lower);
      __syncwarp();
      if (have && (peers & lower) == 0) sh.wc[w][b] = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int b = tid; b < nb; b += QK_CT_THREADS) {
      uint32_t c = 0;
#pragma unroll
      for (int u = 0; u < QK_CT_WARPS; ++u) {
        const uint32_t x = sh.wc[u][b];
        sh.wc[u][b] = c;
        c += x;
      }
      sh.agg[b] = c;
    }
  }
  __syncthreads();
  if (tid == 0) {  // the buckets' first places in the tile
    uint32_t c = 0;
    for (int b = 0; b < nb; ++b) {
      sh.tstart[b] = c;
      c += sh.agg[b];
    }
    sh.rows = c;
  }
  __syncthreads();
  // stage the rows in bucket order
  if (kSmall) {
    unsigned long long seen = inc - run;  // the earlier lanes' rows, then this thread's too
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) {
      const int b = bk[q];
      if (b >= 0) {
        sh.stage[sh.tstart[b] + sh.wc[w][b] + qk_field(seen, b)] =
            (uint32_t)(tid * QK_CT_ITEMS + q) | ((uint32_t)b << 16);
        seen += 1ull << (10 * b);
      }
    }
  } else {
    const uint8_t* tb = (const uint8_t*)sh.bk;
#pragma unroll
    for (int q = 0; q < QK_CT_ITEMS; ++q) {
      const int r = w * 512 + q * 32 + lane;
      const int b = tb[r];
      if (b < nb) sh.stage[sh.tstart[b] + sh.wc[w][b] + rank[q]] = (uint32_t)r | ((uint32_t)b << 16);
    }
  }
  for (int b = tid; b < nb; b += QK_CT_THREADS)
    sh.dst[b] = (int32_t)(sh.base[b] + sh.excl[b]) - (int32_t)sh.tstart[b];
  if (w == 1 && k == 0) {
    for (int p = lane; p < n_parts; p += 32) {
      counts[p] = (int32_t)totals[p];
      offsets[p] = (int32_t)sh.base[p];
    }
  }
  __syncthreads();
  for (int i = tid; i < (int)sh.rows; i += QK_CT_THREADS) {
    const uint32_t x = sh.stage[i];
    perm[sh.dst[x >> 16] + i] = (int32_t)(t0 + (x & 0xffffu));
  }
}

// K24 pass 1: ids of one tile of one shard (n_parts for an invalid row) and
// their per-bucket counts, hist[(shard * (n_parts + 1) + bucket) * tiles + tile]
__global__ void __launch_bounds__(QK_MESH_THREADS)
qk_mesh_hist_kernel(PLimbs L, const uint8_t* __restrict__ valid, int n_parts,
                    int64_t shard_rows, int tiles, int32_t* __restrict__ bucket,
                    int32_t* __restrict__ hist) {
  __shared__ int32_t h[QK_MAX_PARTS + 1];
  const int nb = n_parts + 1;
  const int shard = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int64_t base = (int64_t)shard * shard_rows;
  const int64_t start = base + (int64_t)tile * QK_MESH_TILE;
  const int64_t stop = (int64_t)(tile + 1) * QK_MESH_TILE < shard_rows
                           ? start + QK_MESH_TILE : base + shard_rows;
  for (int64_t i = start + threadIdx.x; i < stop; i += blockDim.x) {
    int b = valid[i] ? (int)qk_row_pid(L, nullptr, i, n_parts) : n_parts;
    bucket[i] = b;
    atomicAdd(&h[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    hist[((int64_t)shard * nb + b) * tiles + tile] = h[b];
}

// K24 pass 2 (one block): exclusive scan of m int32 in place
__global__ void __launch_bounds__(QK_SCAN_THREADS)
qk_mesh_scan_kernel(int32_t* __restrict__ a, int64_t m) {
  __shared__ int32_t s[QK_SCAN_THREADS];
  const int tid = threadIdx.x;
  const int64_t per = (m + QK_SCAN_THREADS - 1) / QK_SCAN_THREADS;
  const int64_t lo = tid * per < m ? tid * per : m;
  const int64_t hi = lo + per < m ? lo + per : m;
  int32_t sum = 0;
  for (int64_t j = lo; j < hi; ++j) sum += a[j];
  s[tid] = sum;
  __syncthreads();
  for (int d = 1; d < QK_SCAN_THREADS; d <<= 1) {  // inclusive Hillis-Steele
    int32_t add = tid >= d ? s[tid - d] : 0;
    __syncthreads();
    s[tid] += add;
    __syncthreads();
  }
  int32_t run = s[tid] - sum;
  for (int64_t j = lo; j < hi; ++j) {
    int32_t c = a[j];
    a[j] = run;
    run += c;
  }
}

__device__ __forceinline__ void qk_copy_leaf(const void* src, void* dst, int width,
                                             int64_t i, int64_t o) {
  if (width == 8) ((unsigned long long*)dst)[o] = ((const unsigned long long*)src)[i];
  else if (width == 4) ((uint32_t*)dst)[o] = ((const uint32_t*)src)[i];
  else ((uint8_t*)dst)[o] = ((const uint8_t*)src)[i];
}

// K24 pass 3: stable placement and the copy of every leaf
__global__ void __launch_bounds__(QK_MESH_THREADS)
qk_mesh_scatter_kernel(MeshLeaves V, const int32_t* __restrict__ bucket, int n_parts,
                       int64_t shard_rows, int tiles, const int32_t* __restrict__ scanned,
                       uint8_t* __restrict__ out_valid) {
  __shared__ int32_t run[QK_MAX_PARTS + 1];
  __shared__ int32_t wcnt[QK_MESH_WARPS][QK_MAX_PARTS + 1];
  const int nb = n_parts + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int shard = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  for (int b = tid; b < nb; b += blockDim.x) {
    // this tile's first position in frame (bucket, shard): the scan's
    // value here less its value at the frame's first tile
    const int64_t seg = ((int64_t)shard * nb + b) * tiles;
    run[b] = scanned[seg + tile] - scanned[seg];
  }
  const int64_t base = (int64_t)shard * shard_rows;
  const int64_t start = base + (int64_t)tile * QK_MESH_TILE;
  const int64_t stop = (int64_t)(tile + 1) * QK_MESH_TILE < shard_rows
                           ? start + QK_MESH_TILE : base + shard_rows;
  const int64_t frame_stride = (int64_t)n_parts * shard_rows;
  for (int64_t r0 = start; r0 < stop; r0 += QK_MESH_THREADS) {
    for (int j = tid; j < QK_MESH_WARPS * (QK_MAX_PARTS + 1); j += blockDim.x)
      wcnt[j / (QK_MAX_PARTS + 1)][j % (QK_MAX_PARTS + 1)] = 0;
    __syncthreads();
    const int64_t i = r0 + tid;
    const bool have = i < stop;
    const int b = have ? bucket[i] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & lower);
    if (have && rank == 0) wcnt[warp][b] = __popc(peers);
    __syncthreads();
    if (tid < nb) {  // warps' counts -> their first positions, in warp order
      int32_t pos = run[tid];
      for (int w = 0; w < QK_MESH_WARPS; ++w) {
        int32_t c = wcnt[w][tid];
        wcnt[w][tid] = pos;
        pos += c;
      }
      run[tid] = pos;
    }
    __syncthreads();
    if (have && b < n_parts) {
      const int64_t o = (int64_t)b * frame_stride + (int64_t)shard * shard_rows
                        + wcnt[warp][b] + rank;
      out_valid[o] = 1;
      for (int l = 0; l < V.n; ++l) qk_copy_leaf(V.src[l], V.dst[l], V.width[l], i, o);
    }
    __syncthreads();
  }
}

template <bool kSmall>
static int qk_plan_launch(const int32_t* p, const uint8_t* v, long long n, int n_parts, int g,
                          uint32_t* tiles, uint32_t* groups, uint32_t* totals, void* perm,
                          void* counts, void* offsets, long long nt, cudaStream_t st) {
  qk_plan_count_kernel<kSmall><<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(
      p, v, n, n_parts, g, tiles, groups, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_plan_place_kernel<kSmall><<<(unsigned int)nt, QK_CT_THREADS, 0, st>>>(
      p, v, n, n_parts, g, tiles, groups, totals, (int32_t*)perm, (int32_t*)counts,
      (int32_t*)offsets);
  return (int)cudaGetLastError();
}

// K17's tiles a group: the square root of the tiles rounded up, at least
// 16, so a tile sums fewer than 2 sqrt(tiles) + 2 words a bucket
static long long qk_plan_group(long long nt) {
  long long g = (long long)sqrt((double)nt);
  while (g * g < nt) ++g;
  return g < 16 ? 16 : g;
}

static int qk_fill_limbs(PLimbs* L, const void* const* limbs, const int* dtypes, int n_limbs) {
  if (n_limbs < 0 || n_limbs > QK_MAX_LIMBS) return 0;
  L->n = n_limbs;
  for (int j = 0; j < n_limbs; ++j) {
    L->p[j] = limbs[j];
    L->dt[j] = dtypes[j];
  }
  return 1;
}

extern "C" {

// K4.  n_limbs == 0 routes by pids_in instead of hashing.  pids_out, masks
// (n_parts * n bytes) and counts (n_parts int32, zeroed by the caller) may
// each be null; masks and counts are written together.
int qk_partition_split(const void* const* limbs, const int* dtypes, int n_limbs,
                       const void* pids_in, const void* valid, long long n,
                       int n_parts, void* pids_out, void* masks, void* counts,
                       void* stream) {
  PLimbs L;
  if (!qk_fill_limbs(&L, limbs, dtypes, n_limbs) || n_parts < 1 || n_parts > QK_MAX_PARTS
      || (masks == nullptr) != (counts == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  qk_partition_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      L, (const int32_t*)pids_in, (const uint8_t*)valid, n, n_parts,
      (int32_t*)pids_out, (uint8_t*)masks, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// K26.  mode 1: salt the fat partition (pids_out gets the salted ids);
// mode 2: replicate it into every part's mask (pids_out gets the hashed
// ids).  As K4 otherwise; valid may be null when masks is.
int qk_adapt_split(const void* const* limbs, const int* dtypes, int n_limbs,
                   const void* pids_in, const void* valid, long long n, int n_parts, int fat,
                   int mode, void* pids_out, void* masks, void* counts, void* stream) {
  PLimbs L;
  if (!qk_fill_limbs(&L, limbs, dtypes, n_limbs) || n_parts < 1 || n_parts > QK_MAX_PARTS
      || fat < 0 || fat >= n_parts || (mode != 1 && mode != 2)
      || (masks == nullptr) != (counts == nullptr) || (masks != nullptr && valid == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int threads = 256;
  unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  qk_adapt_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      L, (const int32_t*)pids_in, (const uint8_t*)valid, n, n_parts, fat, mode,
      (int32_t*)pids_out, (uint8_t*)masks, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// K17's scratch (uint64 words): the uint32 counts of every tile, then of
// every group, then the totals, a word a bucket each.
long long qk_plan_scratch(long long n, int n_parts) {
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE;
  const long long ng = (nt + qk_plan_group(nt) - 1) / qk_plan_group(nt);
  return ((nt + ng + 1) * (n_parts + 1) + 1) / 2;
}

// K17.  pids [n] int32 and valid [n] uint8 in; perm [n] int32, counts and
// offsets [n_parts] int32 out; scratch: qk_plan_scratch(n, n_parts) words,
// whose group counts and totals are zeroed here.  One memset and two
// launches.
int qk_partition_plan(const void* pids, const void* valid, long long n, int n_parts,
                      void* scratch, void* perm, void* counts, void* offsets, void* stream) {
  if (n_parts < 1 || n_parts > QK_MAX_PARTS || n < 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) {
    cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_parts, st);
    cudaMemsetAsync(offsets, 0, sizeof(int32_t) * n_parts, st);
    return (int)cudaGetLastError();
  }
  const int nb = n_parts + 1;
  const long long nt = (n + QK_CT_TILE - 1) / QK_CT_TILE, g = qk_plan_group(nt);
  const long long ng = (nt + g - 1) / g;
  uint32_t* tiles = (uint32_t*)scratch;
  uint32_t* groups = tiles + nt * nb;
  uint32_t* totals = groups + ng * nb;
  cudaError_t err = cudaMemsetAsync(groups, 0, sizeof(uint32_t) * (size_t)((ng + 1) * nb), st);
  if (err != cudaSuccess) return (int)err;
  const int32_t* p = (const int32_t*)pids;
  const uint8_t* v = (const uint8_t*)valid;
  if (nb <= QK_PLAN_SMALL)
    return qk_plan_launch<true>(p, v, n, n_parts, (int)g, tiles, groups, totals, perm, counts,
                                offsets, nt, st);
  return qk_plan_launch<false>(p, v, n, n_parts, (int)g, tiles, groups, totals, perm, counts,
                               offsets, nt, st);
}

// K24.  limbs (n_limbs arrays of n_shards * shard_rows rows, dtypes as K4)
// and valid (uint8) of the global batch; srcs / dsts / widths: n_leaves
// carried columns and their outputs of n_shards^2 * shard_rows elements
// each; out_valid (n_shards^2 * shard_rows uint8).  bucket is
// n_shards * shard_rows int32 of scratch, hist n_shards * (n_shards + 1) *
// tiles int32, tiles = ceil(shard_rows / 4096).  Zeroes the outputs first.
int qk_mesh_bucketize(const void* const* limbs, const int* dtypes, int n_limbs,
                      const void* valid, int n_shards, long long shard_rows,
                      const void* const* srcs, void* const* dsts, const int* widths,
                      int n_leaves, void* out_valid, void* bucket, void* hist, int tiles,
                      void* stream) {
  PLimbs L;
  if (n_limbs < 1 || !qk_fill_limbs(&L, limbs, dtypes, n_limbs) || n_shards < 1
      || n_shards > QK_MAX_PARTS || shard_rows < 1 || n_leaves < 0
      || n_leaves > QK_MESH_MAX_LEAVES
      || (long long)n_shards * n_shards * shard_rows > 0x7fffffffLL
      || tiles != (int)((shard_rows + QK_MESH_TILE - 1) / QK_MESH_TILE))
    return (int)cudaErrorInvalidValue;
  MeshLeaves V;
  V.n = n_leaves;
  const long long out_rows = (long long)n_shards * n_shards * shard_rows;
  cudaStream_t st = (cudaStream_t)stream;
  for (int l = 0; l < n_leaves; ++l) {
    if (widths[l] != 1 && widths[l] != 4 && widths[l] != 8) return (int)cudaErrorInvalidValue;
    V.src[l] = srcs[l];
    V.dst[l] = dsts[l];
    V.width[l] = widths[l];
    cudaMemsetAsync(dsts[l], 0, (size_t)widths[l] * out_rows, st);
  }
  cudaMemsetAsync(out_valid, 0, (size_t)out_rows, st);
  const int blocks = n_shards * tiles;
  qk_mesh_hist_kernel<<<blocks, QK_MESH_THREADS, 0, st>>>(
      L, (const uint8_t*)valid, n_shards, shard_rows, tiles, (int32_t*)bucket,
      (int32_t*)hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_mesh_scan_kernel<<<1, QK_SCAN_THREADS, 0, st>>>(
      (int32_t*)hist, (int64_t)n_shards * (n_shards + 1) * tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_mesh_scatter_kernel<<<blocks, QK_MESH_THREADS, 0, st>>>(
      V, (const int32_t*)bucket, n_shards, shard_rows, tiles, (const int32_t*)hist,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
