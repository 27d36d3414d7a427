// K8, the compact-concat, for Hopper (sm_90a).
//
// Replaces quokka_tpu/ops/bridge.py:382 `_fused_concat_kernel`: the live
// rows of every part, in part order and row order, gathered to the front
// of one bucketed output of every column, the rows from `total` to the
// bucket's end zeroed (the reference's contract, :395-399), and the output
// validity arange(out_padded) < total.  The reference concatenates the
// parts' validity, runs a fixed-size nonzero and gathers every column from
// its concatenation; the port's plain version (ops/bridge.py
// `compact_concat_plain`) is a torch.cat a column, a torch.nonzero that
// blocks the host on its count, and a gather and a where a column.
//
// What bounds it: bytes.  Each part row's validity byte is read once, each
// live row of each column is read once, and every output row of every
// column and of the validity is written once.
//
// Design: one launch, on the 4096-row tiles that K17 shares
// (csrc/compact.cuh).  The parts' tiles are numbered in part order (a tile
// never spans two parts; the kernel finds a tile's part by a warp scan of
// the parts' tile counts), and a block takes one by ticket: it reads the
// tile's validity with one 16-byte load a thread, scans the live counts of
// its threads in the warp and across the warps, writes the tile's
// compaction map (the rows of its live rows, in order) to shared memory,
// and looks back for the live rows of all earlier tiles.  Then it
// copies every column's live rows to their places: consecutive threads
// write consecutive output rows, each unit of 1-16 bytes read through the
// map, four loads a thread in flight.  Rows placed at or past `total` are
// not written.  The blocks with the first tickets write the output
// validity and zero every column from `total` to the bucket's end, with
// 16-byte stores, while the tiles' blocks start.
//
// The look-back: a block takes its tile from an atomic ticket, so it waits
// only on tiles whose blocks already run.  Each tile publishes one 64-bit
// status word: first its own live count (an aggregate), and once its
// look-back ends, its inclusive prefix.  One warp reads windows of 32 x
// QK_CAT_LOOK earlier status words, all of a lane's issued before the
// first is waited on (tiles that start together publish their aggregates
// together, and a late tile's walk, not the waits, is what costs), and
// stops at the nearest inclusive prefix.  The counts are integers, so the
// prefix is the same every run.  The status words and the ticket are
// zeroed by one memset on the launch's stream.
//
// Columns are described in device memory (the wrapper stages the table in
// pinned memory and copies it once); a launch writes at most
// QK_CAT_MAX_COLS columns, and a wrapper with more issues further launches
// of the same kernel, which read the validity again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact.cuh"

#define QK_CAT_MAX_COLS 16
#define QK_CAT_ZERO_ROWS 4096  // output rows a zeroing block covers
#define QK_CAT_LOOK 2          // status words a lane reads a step of the look-back

struct QkCatPart {
  const uint8_t* valid;  // the part's validity, bool
  long long rows;        // its padded length
};

// a part's tiles
__host__ __device__ __forceinline__ long long qk_cat_tiles(long long rows) {
  return (rows + QK_CT_TILE - 1) / QK_CT_TILE;
}

struct QkCatCol {
  char* dst;  // out_padded rows of width bytes
  int width;  // bytes a row: 1, 2, 4, 8, or a vector's
  int unit;   // bytes a copy: the largest power of two up to 16 dividing
              // the width and every pointer of the column
};

struct QkCatShared {
  uint16_t map[QK_CT_TILE];  // the tile's live rows, in order
  uint32_t warp[QK_CT_WARPS];
  uint32_t excl;
  unsigned int ticket;
  int part;
  long long first;  // the part's first tile
};

// a status word: the state (1 aggregate, 2 inclusive prefix) in bits 62-63
// and the count in bits 0-31; 0 = not published yet
__device__ __forceinline__ unsigned long long qk_ct_word(uint32_t v, unsigned long long state) {
  return (state << 62) | (unsigned long long)v;
}

__device__ __forceinline__ unsigned long long qk_ct_load(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void qk_ct_store(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Tile k's look-back, by one whole warp: publishes agg, the tile's live
// rows, and returns the live rows of tiles 0 .. k - 1, then publishes its
// inclusive prefix.  Lane l reads tiles j0 - l L, j0 - l L - 1, ... (L =
// QK_CAT_LOOK) up to the first inclusive prefix; before tile 0 stands an
// empty inclusive prefix.
__device__ __forceinline__ uint32_t qk_cat_look_back(unsigned long long* status, long long k,
                                                     uint32_t agg) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) qk_ct_store(status + k, qk_ct_word(agg, k == 0 ? 2ull : 1ull));
  uint32_t acc = 0;
  for (long long j0 = k - 1; j0 >= 0; j0 -= 32 * QK_CAT_LOOK) {
    const long long j1 = j0 - (long long)lane * QK_CAT_LOOK;
    unsigned long long word[QK_CAT_LOOK];
#pragma unroll
    for (int i = 0; i < QK_CAT_LOOK; ++i)
      word[i] = j1 - i >= 0 ? qk_ct_load(status + j1 - i) : qk_ct_word(0u, 2ull);
    uint32_t add = 0;
    bool stop = false;
#pragma unroll
    for (int i = 0; i < QK_CAT_LOOK; ++i) {
      if (stop) break;
      while ((word[i] >> 62) == 0) word[i] = qk_ct_load(status + j1 - i);
      add += (uint32_t)word[i];
      stop = (word[i] >> 62) == 2;
    }
    // the lanes in window order, up to the first that met an inclusive prefix
    const unsigned hit = __ballot_sync(0xffffffffu, stop);
    if (hit != 0u && lane > __ffs(hit) - 1) add = 0;
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) add += __shfl_xor_sync(0xffffffffu, add, d);
    acc += add;
    if (hit != 0u) break;
  }
  if (lane == 0 && k > 0) qk_ct_store(status + k, qk_ct_word(acc + agg, 2ull));
  return acc;
}

// copy the tile's live rows of one column: output row excl + s gets tile
// row map[s], for s below lim (the live rows placed before total), a row
// of `units` units; up to 8 bytes a unit, four units a thread in flight
template <typename V>
__device__ __forceinline__ void qk_cat_copy(const QkCatShared& sh, const char* src, char* dst,
                                            long long row0, int lim, int units) {
  constexpr int kFlight = sizeof(V) <= 8 ? 4 : 1;
  const V* s = (const V*)src + row0 * units;
  V* d = (V*)dst + (long long)sh.excl * units;
  const int n = lim * units;
  for (int k0 = threadIdx.x; k0 < n; k0 += kFlight * QK_CT_THREADS) {
    V x[kFlight];
#pragma unroll
    for (int q = 0; q < kFlight; ++q) {
      const int k = k0 + q * QK_CT_THREADS;
      if (k < n) {
        const int r = units == 1 ? k : k / units;
        x[q] = s[(long long)sh.map[r] * units + (k - r * units)];
      }
    }
#pragma unroll
    for (int q = 0; q < kFlight; ++q) {
      const int k = k0 + q * QK_CT_THREADS;
      if (k < n) d[k] = x[q];
    }
  }
}

// zero bytes [lo, hi) of base, block-wide, with 16-byte stores between
// the unaligned ends
__device__ __forceinline__ void qk_cat_zero(char* base, long long lo, long long hi) {
  if (lo >= hi) return;
  const long long a = ((long long)(((uintptr_t)(base + lo) + 15u) & ~(uintptr_t)15u) - (long long)(uintptr_t)base);
  const long long mid0 = a < hi ? a : hi;
  const long long mid1 = mid0 + ((hi - mid0) & ~15LL);
  for (long long i = lo + threadIdx.x; i < mid0; i += QK_CT_THREADS) base[i] = 0;
  for (long long i = mid0 + 16LL * threadIdx.x; i < mid1; i += 16LL * QK_CT_THREADS)
    *(uint4*)(base + i) = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = mid1 + threadIdx.x; i < hi; i += QK_CT_THREADS) base[i] = 0;
}

__global__ void __launch_bounds__(QK_CT_THREADS)
    qk_concat_kernel(const QkCatPart* __restrict__ parts, int n_parts,
                     const QkCatCol* __restrict__ cols, const char* const* __restrict__ srcs,
                     int n_cols, long long total, long long out_padded,
                     uint8_t* __restrict__ out_valid, unsigned long long* status,
                     unsigned int* ticket) {
  __shared__ QkCatShared sh;
  const long long nz = (out_padded + QK_CAT_ZERO_ROWS - 1) / QK_CAT_ZERO_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid == 0) sh.ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long ticket0 = sh.ticket;
  if (ticket0 < nz) {
    // the first tickets: the output validity and the zeroed tail
    const long long lo = ticket0 * QK_CAT_ZERO_ROWS;
    const long long hi = lo + QK_CAT_ZERO_ROWS < out_padded ? lo + QK_CAT_ZERO_ROWS : out_padded;
    if (out_valid != nullptr) {
      for (long long r = lo + 16LL * tid; r < hi; r += 16LL * QK_CT_THREADS) {
        if (r + 16 <= hi && (((uintptr_t)(out_valid + r)) & 15u) == 0) {
          uint32_t x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[q] = 0u;
#pragma unroll
            for (int b = 0; b < 4; ++b) x[q] |= (r + 4 * q + b < total ? 1u : 0u) << (8 * b);
          }
          *(uint4*)(out_valid + r) = make_uint4(x[0], x[1], x[2], x[3]);
        } else {
          for (long long i = r; i < r + 16 && i < hi; ++i) out_valid[i] = i < total ? 1 : 0;
        }
      }
    }
    const long long zlo = lo > total ? lo : total;
    for (int c = 0; c < n_cols; ++c) {
      const long long wd = cols[c].width;
      qk_cat_zero(cols[c].dst, zlo * wd, hi * wd);
    }
    return;
  }
  const long long k = ticket0 - nz;  // the tile
  // the part that holds tile k: the first whose tiles, counted from part
  // 0 on, pass k (a warp scan of 32 parts' tile counts a step)
  if (w == 0) {
    long long before = 0;  // the tiles of the earlier steps' parts
    for (int p0 = 0; p0 < n_parts; p0 += 32) {
      const int p = p0 + lane;
      const long long t = p < n_parts ? qk_cat_tiles(parts[p].rows) : 0;
      long long inc = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += y;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, before + inc > k);
      if (hit != 0u) {
        if (lane == __ffs(hit) - 1) {
          sh.part = p;
          sh.first = before + inc - t;
        }
        break;
      }
      before += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  const QkCatPart P = parts[sh.part];
  const long long row0 = (k - sh.first) * QK_CT_TILE;
  const long long left = P.rows - row0 - (long long)tid * QK_CT_ITEMS;
  const int cnt = left <= 0 ? 0 : (left < QK_CT_ITEMS ? (int)left : QK_CT_ITEMS);
  const uint8_t* v = P.valid + row0 + (long long)tid * QK_CT_ITEMS;
  uint32_t live = 0;  // bit q: the thread's row q is live
  if (cnt == QK_CT_ITEMS && (((uintptr_t)v) & 15u) == 0) {
    const uint4 f = __ldcs((const uint4*)v);
    const uint32_t x[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int q = 0; q < 16; ++q) live |= (((x[q >> 2] >> (8 * (q & 3))) & 0xffu) != 0 ? 1u : 0u) << q;
  } else {
    for (int q = 0; q < cnt; ++q) live |= (v[q] != 0 ? 1u : 0u) << q;
  }
  // the thread's first place in the tile: its warp's, then its lanes'
  const uint32_t c = __popc(live);
  uint32_t inc = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh.warp[w] = inc;
  __syncthreads();
  uint32_t off = inc - c, agg = 0;
#pragma unroll
  for (int u = 0; u < QK_CT_WARPS; ++u) {
    off += u < w ? sh.warp[u] : 0u;
    agg += sh.warp[u];
  }
  for (uint32_t m = live; m != 0u; m &= m - 1u) {
    sh.map[off++] = (uint16_t)(tid * QK_CT_ITEMS + __ffs(m) - 1);
  }
  if (w == 0) {
    const uint32_t excl = qk_cat_look_back(status, k, agg);
    if (lane == 0) sh.excl = excl;
  }
  __syncthreads();
  const long long room = total - (long long)sh.excl;  // output rows left before total
  const int lim = room <= 0 ? 0 : (room < (long long)agg ? (int)room : (int)agg);
  for (int ci = 0; ci < n_cols; ++ci) {
    const QkCatCol col = cols[ci];
    const char* src = srcs[(long long)sh.part * n_cols + ci];
    const int units = col.width / col.unit;
    switch (col.unit) {
      case 16: qk_cat_copy<uint4>(sh, src, col.dst, row0, lim, units); break;
      case 8: qk_cat_copy<unsigned long long>(sh, src, col.dst, row0, lim, units); break;
      case 4: qk_cat_copy<uint32_t>(sh, src, col.dst, row0, lim, units); break;
      case 2: qk_cat_copy<uint16_t>(sh, src, col.dst, row0, lim, units); break;
      default: qk_cat_copy<uint8_t>(sh, src, col.dst, row0, lim, units); break;
    }
  }
}

extern "C" {

// K8's scratch (uint64 words) for parts of rows[0 .. n_parts - 1] rows: a
// status word a tile and the ticket.
long long qk_concat_scratch(const long long* rows, int n_parts) {
  long long nt = 0;
  for (int p = 0; p < n_parts; ++p) nt += qk_cat_tiles(rows[p]);
  return nt + 1;
}

// parts (n_parts QkCatPart), cols (n_cols QkCatCol) and srcs (n_parts x
// n_cols source pointers, part-major) in device memory; rows (host) the
// parts' rows as parts holds them; out_valid (out_padded bytes) may be
// null, and then is not written; scratch (qk_concat_scratch(rows,
// n_parts) words, zeroed here).  Writes every row of every column's dst
// and of out_valid.
int qk_concat(const void* parts, const long long* rows, int n_parts, const void* cols,
              const void* srcs, int n_cols, long long total, long long out_padded,
              void* out_valid, void* scratch, void* stream) {
  if (n_parts < 1 || n_cols < 0 || n_cols > QK_CAT_MAX_COLS || total < 0 || total > out_padded
      || out_padded > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < n_parts; ++p)
    if (rows[p] < 0) return (int)cudaErrorInvalidValue;
  const long long nt = qk_concat_scratch(rows, n_parts) - 1;
  const long long nz = (out_padded + QK_CAT_ZERO_ROWS - 1) / QK_CAT_ZERO_ROWS;
  if (nt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (nt + nz == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 8 * (size_t)(nt + 1), st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* status = (unsigned long long*)scratch;
  qk_concat_kernel<<<(unsigned int)(nt + nz), QK_CT_THREADS, 0, st>>>(
      (const QkCatPart*)parts, n_parts, (const QkCatCol*)cols, (const char* const*)srcs, n_cols,
      total, out_padded, (uint8_t*)out_valid, status, (unsigned int*)(status + nt));
  return (int)cudaGetLastError();
}

}  // extern "C"
