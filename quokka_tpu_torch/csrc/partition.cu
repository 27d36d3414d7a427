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
// it: bytes, 9 per row (the id and validity read twice, the permutation
// written once).  Design, a stable counting sort in three launches: (1)
// each block counts its tile's rows per bucket (P parts + the invalid
// bucket) in shared memory; (2) one block scans the [bucket][block] counts
// in bucket-major order, which gives every (bucket, block) its first output
// position and every part its offset and count; (3) each block walks its
// tile again in row order, 256 rows a round: a row's rank among the earlier
// rows of its bucket in its warp comes from __match_any_sync and a popcount
// of the lower lanes, and the warps' counts are turned into offsets in
// shared memory.  No atomics place a row, so the permutation is stable and
// the same every run.
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
// times the input by the reference's static design.  Design: K17's stable
// counting sort, per shard: (1) each block hashes one tile of one shard,
// stores the ids and counts them per bucket (P parts + the invalid bucket)
// in shared memory; (2) one block scans the [shard][bucket][tile] counts,
// which gives every (shard, bucket, tile) its first position in the frame;
// (3) each block walks its tile again in row order, 256 rows a round, ranks
// a row among its warp's rows of the same bucket with __match_any_sync and
// a popcount, and copies every carried column of the row (1-, 4- or 8-byte
// leaves, from one descriptor table) to its output slot.  No atomics place
// a row, so positions are stable and the same every run.

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_LIMBS 16
#define QK_MAX_PARTS 64
#define QK_PLAN_THREADS 256
#define QK_PLAN_WARPS (QK_PLAN_THREADS / 32)
#define QK_PLAN_TILE 4096  // rows a block of K17 owns: 16 rounds of 256
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
// launch writes out of bounds.
__device__ __forceinline__ int qk_bucket(const int32_t* pids, const uint8_t* valid, int64_t i,
                                         int n_parts) {
  int p = pids[i];
  return (valid[i] && (unsigned)p < (unsigned)n_parts) ? p : n_parts;
}

__global__ void __launch_bounds__(QK_PLAN_THREADS)
qk_plan_hist_kernel(const int32_t* __restrict__ pids, const uint8_t* __restrict__ valid,
                    int64_t n, int n_parts, int nblocks, int32_t* __restrict__ hist) {
  __shared__ int32_t h[QK_MAX_PARTS + 1];
  const int nb = n_parts + 1;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * QK_PLAN_TILE;
  const int64_t end = start + QK_PLAN_TILE < n ? start + QK_PLAN_TILE : n;
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x)
    atomicAdd(&h[qk_bucket(pids, valid, i, n_parts)], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    hist[(int64_t)b * nblocks + blockIdx.x] = h[b];
}

// one block: exclusive scan of hist [n_parts + 1][nblocks] in place, then
// each part's offset and count
__global__ void __launch_bounds__(QK_SCAN_THREADS)
qk_plan_scan_kernel(int32_t* __restrict__ hist, int n_parts, int nblocks,
                    int32_t* __restrict__ counts, int32_t* __restrict__ offsets) {
  __shared__ int32_t s[QK_SCAN_THREADS];
  const int tid = threadIdx.x;
  const int64_t m = (int64_t)(n_parts + 1) * nblocks;
  const int64_t per = (m + QK_SCAN_THREADS - 1) / QK_SCAN_THREADS;
  const int64_t lo = tid * per < m ? tid * per : m;
  const int64_t hi = lo + per < m ? lo + per : m;
  int32_t sum = 0;
  for (int64_t j = lo; j < hi; ++j) sum += hist[j];
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
    int32_t c = hist[j];
    hist[j] = run;
    run += c;
  }
  __syncthreads();
  if (tid < n_parts) {
    int32_t a = hist[(int64_t)tid * nblocks], b = hist[(int64_t)(tid + 1) * nblocks];
    offsets[tid] = a;
    counts[tid] = b - a;
  }
}

__global__ void __launch_bounds__(QK_PLAN_THREADS)
qk_plan_scatter_kernel(const int32_t* __restrict__ pids, const uint8_t* __restrict__ valid,
                       int64_t n, int n_parts, int nblocks, const int32_t* __restrict__ base,
                       int32_t* __restrict__ perm) {
  __shared__ int32_t run[QK_MAX_PARTS + 1];
  __shared__ int32_t wcnt[QK_PLAN_WARPS][QK_MAX_PARTS + 1];
  const int nb = n_parts + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int b = tid; b < nb; b += blockDim.x) run[b] = base[(int64_t)b * nblocks + blockIdx.x];
  const int64_t start = (int64_t)blockIdx.x * QK_PLAN_TILE;
  const int64_t end = start + QK_PLAN_TILE < n ? start + QK_PLAN_TILE : n;
  for (int64_t r0 = start; r0 < end; r0 += QK_PLAN_THREADS) {
    for (int j = tid; j < QK_PLAN_WARPS * (QK_MAX_PARTS + 1); j += blockDim.x)
      wcnt[j / (QK_MAX_PARTS + 1)][j % (QK_MAX_PARTS + 1)] = 0;
    __syncthreads();
    const int64_t i = r0 + tid;
    const bool have = i < end;
    const int b = have ? qk_bucket(pids, valid, i, n_parts) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const int rank = __popc(peers & lower);
    if (have && rank == 0) wcnt[warp][b] = __popc(peers);
    __syncthreads();
    if (tid < nb) {  // warps' counts -> their first positions, in warp order
      int32_t pos = run[tid];
      for (int w = 0; w < QK_PLAN_WARPS; ++w) {
        int32_t c = wcnt[w][tid];
        wcnt[w][tid] = pos;
        pos += c;
      }
      run[tid] = pos;
    }
    __syncthreads();
    if (have) perm[wcnt[warp][b] + rank] = (int32_t)i;
    __syncthreads();
  }
}

// K24 pass 1: ids of one tile of one shard (n_parts for an invalid row) and
// their per-bucket counts, hist[(shard * (n_parts + 1) + bucket) * tiles + tile]
__global__ void __launch_bounds__(QK_PLAN_THREADS)
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
__global__ void __launch_bounds__(QK_PLAN_THREADS)
qk_mesh_scatter_kernel(MeshLeaves V, const int32_t* __restrict__ bucket, int n_parts,
                       int64_t shard_rows, int tiles, const int32_t* __restrict__ scanned,
                       uint8_t* __restrict__ out_valid) {
  __shared__ int32_t run[QK_MAX_PARTS + 1];
  __shared__ int32_t wcnt[QK_PLAN_WARPS][QK_MAX_PARTS + 1];
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
  for (int64_t r0 = start; r0 < stop; r0 += QK_PLAN_THREADS) {
    for (int j = tid; j < QK_PLAN_WARPS * (QK_MAX_PARTS + 1); j += blockDim.x)
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
      for (int w = 0; w < QK_PLAN_WARPS; ++w) {
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

// K17.  pids [n] int32 and valid [n] uint8 in; perm [n] int32, counts and
// offsets [n_parts] int32 out.  hist is [n_parts + 1, nblocks] int32
// scratch with nblocks = ceil(n / 4096).
int qk_partition_plan(const void* pids, const void* valid, long long n, int n_parts,
                      int nblocks, void* hist, void* perm, void* counts, void* offsets,
                      void* stream) {
  if (n_parts < 1 || n_parts > QK_MAX_PARTS || n < 0 || n > 0x7fffffffLL
      || nblocks != (int)((n + QK_PLAN_TILE - 1) / QK_PLAN_TILE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) {
    cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_parts, st);
    cudaMemsetAsync(offsets, 0, sizeof(int32_t) * n_parts, st);
    return (int)cudaGetLastError();
  }
  qk_plan_hist_kernel<<<nblocks, QK_PLAN_THREADS, 0, st>>>(
      (const int32_t*)pids, (const uint8_t*)valid, n, n_parts, nblocks, (int32_t*)hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_plan_scan_kernel<<<1, QK_SCAN_THREADS, 0, st>>>((int32_t*)hist, n_parts, nblocks,
                                                     (int32_t*)counts, (int32_t*)offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_plan_scatter_kernel<<<nblocks, QK_PLAN_THREADS, 0, st>>>(
      (const int32_t*)pids, (const uint8_t*)valid, n, n_parts, nblocks,
      (const int32_t*)hist, (int32_t*)perm);
  return (int)cudaGetLastError();
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
  qk_mesh_hist_kernel<<<blocks, QK_PLAN_THREADS, 0, st>>>(
      L, (const uint8_t*)valid, n_shards, shard_rows, tiles, (int32_t*)bucket,
      (int32_t*)hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_mesh_scan_kernel<<<1, QK_SCAN_THREADS, 0, st>>>(
      (int32_t*)hist, (int64_t)n_shards * (n_shards + 1) * tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qk_mesh_scatter_kernel<<<blocks, QK_PLAN_THREADS, 0, st>>>(
      V, (const int32_t*)bucket, n_shards, shard_rows, tiles, (const int32_t*)hist,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
