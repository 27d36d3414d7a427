// Small-key bucket aggregates for Hopper (sm_90a): K2's bucket core and
// K6's one-hot product on the FP64 tensor cores.  Each has its own wrapper
// and launch count (ops/fuse.py), and both read a partial's plain numeric
// column in place (typed by a tag); only expression inputs come from a
// Triton pre-pass:
// - K2 replaces quokka_tpu/ops/fuse.py:462 `_build_small_scatter` (the
//   scatter strategy, the GPU default) and runs the bucket core below;
// - K6 replaces quokka_tpu/ops/fuse.py:367 / :386 `_build_small` (the
//   one-hot matmul strategy, groupby=sort) and runs qk_onehot_mma_kernel,
//   whose note is at its section further down.
//
// Each valid row's bucket is the mixed radix sum((code_k + 1) * stride_k)
// of its dictionary codes (a null code, -1, takes slot 0 of its key);
// invalid rows go to a dump bucket G that no output reads, so a NaN in a
// padded row never reaches a sum.  Per bucket g < G: the float64 sum of
// every float column (float64 or float32, read in place), the exact int64
// sum of every integer column (int64 or int32), the row count (int32 or
// int64) and the smallest row index (n when empty).  A column tagged
// QK_AGG_NN0 adds 0 for a null (NaN, or the int sentinel), the reference's
// `__nn0` wrapper of sum(x); one tagged QK_AGG_NNCOUNT, summed among the
// integer columns, adds 1 for each value that is not null, its
// `__nncount` wrapper of count(x) and avg(x).
//
// What bounds it: bytes.  A row reads its codes (4 B a key), validity and
// each column once; the outputs are a few hundred entries.  The one-hot
// the reference builds costs n x G x columns; the Triton kernel this core
// replaced selected a [block, G] tile per partial and reduced it across
// warps (G x the adds, 16x its bound at Q1).
//
// The bucket core's design, deterministic, with no atomics and no block
// barrier in the row loop: each warp owns private per-bucket accumulators
// in shared memory and takes 32 rows a step.  A step groups its lanes into one run per
// bucket (__match_any_sync gives a lane's run; a shuffle scan of the run
// sizes at each run's first lane gives where the run starts, the runs in
// the order of their first lanes), stages each column through shared
// memory in that order, and sums each run with a segmented shuffle scan,
// as many levels as log2 of the widest run (five at Q1's four heavy
// buckets, one or two at the tick paths' 128 light ones).  The run's last
// lane adds the sum into the warp's accumulator, the run's first lane the
// count and its row, the smallest of the bucket in this step.  The first
// columns' loads are issued before the grouping.  At the end a block adds
// its warps' accumulators in warp order into [entries][blocks] partials,
// and a second kernel adds each entry's blocks in block order (a warp per
// entry: lanes take every 32nd block, loads issued four at a time, then a
// fixed shuffle tree), so the result is the same bits every run.  Eight
// warps a block unless their accumulators (entries x 8 B each) pass the
// shared memory; the grid is the card's resident blocks.  Tensor cores
// are not used.  On the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md,
// PR 14) a step's grouping and waits take about 40% of the core's time at
// Q1 and most of it at the tick paths' shape; ordering the runs by bucket
// with one ballot per bit of the bucket id was 8-19% slower, and keeping
// the next steps' rows in flight with cp.async slower still.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#define QK_AGG_MAX_KEYS 8
#define QK_AGG_MAX_COLS 32
#define QK_AGG_MAX_BUCKETS 256
#define QK_AGG_WARPS 8       // warps a block holds at most
#define QK_AGG_PREFETCH 4    // columns loaded ahead
#define QK_AGG_SMEM 232448   // shared memory a block may use on sm_90

// a column's tag: its type in the low two bits, QK_AGG_NN0 or
// QK_AGG_NNCOUNT above
enum { QK_AGG_F64 = 0, QK_AGG_F32 = 1, QK_AGG_I64 = 2, QK_AGG_I32 = 3 };
#define QK_AGG_NN0 4
#define QK_AGG_NNCOUNT 8

struct QkAggIn {
  const void* col[QK_AGG_MAX_COLS];  // nf float columns, then ni integer columns
  int tag[QK_AGG_MAX_COLS];
  const int32_t* codes[QK_AGG_MAX_KEYS];
  int stride[QK_AGG_MAX_KEYS];
  int nf, ni, nk;
};

// a column's value at row as raw 64 bits (float32 and int32 widened later)
__device__ __forceinline__ long long qk_agg_raw(const QkAggIn& in, int a, long long row) {
  const void* p = in.col[a];
  switch (in.tag[a] & 3) {
    case QK_AGG_F64: return __ldg((const long long*)p + row);
    case QK_AGG_F32: return (long long)(uint32_t)__ldg((const int*)p + row);
    case QK_AGG_I64: return __ldg((const long long*)p + row);
    default: return (long long)__ldg((const int*)p + row);
  }
}

__device__ __forceinline__ double qk_agg_float(int tag, long long raw) {
  const double x = (tag & 3) == QK_AGG_F32 ? (double)__int_as_float((int)raw)
                                           : __longlong_as_double(raw);
  return ((tag & QK_AGG_NN0) && x != x) ? 0.0 : x;
}

__device__ __forceinline__ long long qk_agg_int(int tag, long long raw) {
  const int t = tag & 3;
  bool null;
  if (t == QK_AGG_F64) {
    const double x = __longlong_as_double(raw);
    null = x != x;
  } else if (t == QK_AGG_F32) {
    const float x = __int_as_float((int)raw);
    null = x != x;
  } else {
    null = raw == (t == QK_AGG_I32 ? (long long)INT_MIN : LLONG_MIN);
  }
  if (tag & QK_AGG_NNCOUNT) return null ? 0 : 1;
  return ((tag & QK_AGG_NN0) && null) ? 0 : raw;
}

// inclusive sum over the lanes of one run: lane's run starts at lane
// `head`, and no run is wider than `widest` lanes, which bounds the levels
template <class T>
__device__ __forceinline__ T qk_seg_scan(T s, int lane, int head, int widest) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= widest) break;
    const T y = __shfl_up_sync(0xffffffffu, s, d);
    if (lane - d >= head) s += y;
  }
  return s;
}

// acc (per warp): [A][G] slots, A = columns + count + smallest row; then
// the warps' staging: [W][32] values, [W][32] run heads, [W][32] buckets.
// partial: [A * G][gridDim.x] raw 64-bit entries.
__global__ void qk_bucket_agg_kernel(QkAggIn in, const uint8_t* __restrict__ valid, long long n,
                                     int G, long long* __restrict__ partial) {
  extern __shared__ long long smem[];
  const int W = blockDim.x >> 5;
  const int C = in.nf + in.ni, A = C + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = A * G;
  long long* acc = smem;
  long long* stage = acc + (long long)W * slots + warp * 32;
  int* heads = (int*)(acc + (long long)W * slots + W * 32) + warp * 32;
  int* bucket = heads + W * 32;
  long long* my = acc + (long long)warp * slots;
  for (int j = lane; j < slots; j += 32) my[j] = j >= (A - 1) * G ? n : 0;
  const unsigned lower = (1u << lane) - 1u;
  const long long step = (long long)gridDim.x * W * 32;
  for (long long base = ((long long)blockIdx.x * W + warp) * 32; base < n; base += step) {
    const long long row = base + lane;
    const bool have = row < n;
    long long v[QK_AGG_PREFETCH];
#pragma unroll
    for (int k = 0; k < QK_AGG_PREFETCH; ++k) v[k] = (k < C && have) ? qk_agg_raw(in, k, row) : 0;
    int g = G;
    if (have) {
      int id = 0;
      for (int k = 0; k < in.nk; ++k) id += (__ldg(in.codes[k] + row) + 1) * in.stride[k];
      if (valid[row] && (unsigned)id < (unsigned)G) g = id;
    }
    // order the lanes by run: eq holds the lanes of g; a run starts after
    // the runs whose first lane is below its own (a scan of run sizes)
    const unsigned eq = __match_any_sync(0xffffffffu, g);
    const int size = __popc(eq);
    const bool lead = (eq & lower) == 0u;  // the run's first lane
    int start = lead ? size : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, start, d);
      if (lane >= d) start += y;
    }
    start -= lead ? size : 0;
    const int head = __shfl_sync(0xffffffffu, start, __ffs(eq) - 1);
    const int dest = head + __popc(eq & lower);
    const int widest = (int)__reduce_max_sync(0xffffffffu, (unsigned)size);
    if (g < G && lead) {  // the run's count and smallest row
      my[C * G + g] += size;
      long long* m = my + (C + 1) * G + g;
      if (row < *m) *m = row;
    }
    heads[dest] = head;
    bucket[dest] = g;
    __syncwarp();
    const int h = heads[lane], gs = bucket[lane];
    const int next = __shfl_down_sync(0xffffffffu, h, 1);
    const bool add = gs < G && (lane == 31 || next != h);  // the run's last lane
    for (int a0 = 0; a0 < C; a0 += QK_AGG_PREFETCH) {
#pragma unroll
      for (int k = 0; k < QK_AGG_PREFETCH; ++k) {
        const int a = a0 + k;
        if (a >= C) break;
        stage[dest] = v[k];
        if (a + QK_AGG_PREFETCH < C && have) v[k] = qk_agg_raw(in, a + QK_AGG_PREFETCH, row);
        __syncwarp();
        const long long raw = stage[lane];
        __syncwarp();
        if (a < in.nf) {
          const double s = qk_seg_scan(qk_agg_float(in.tag[a], raw), lane, h, widest);
          if (add) my[a * G + gs] = __double_as_longlong(__longlong_as_double(my[a * G + gs]) + s);
        } else {
          const long long s = qk_seg_scan(qk_agg_int(in.tag[a], raw), lane, h, widest);
          if (add) my[a * G + gs] += s;
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int e = tid; e < slots; e += blockDim.x) {
    const int a = e / G;
    long long out;
    if (a < in.nf) {
      double s = 0.0;
      for (int w = 0; w < W; ++w) s += __longlong_as_double(acc[(long long)w * slots + e]);
      out = __double_as_longlong(s);
    } else if (a < A - 1) {
      out = 0;
      for (int w = 0; w < W; ++w) out += acc[(long long)w * slots + e];
    } else {
      out = n;
      for (int w = 0; w < W; ++w) out = min(out, acc[(long long)w * slots + e]);
    }
    partial[(long long)e * gridDim.x + blockIdx.x] = out;
  }
}

// one warp per entry (a, g): lane l combines blocks l, l + 32, ... in
// order, four loads in flight, then a fixed shuffle tree
__global__ void qk_bucket_reduce_kernel(const long long* __restrict__ partial, int blocks,
                                        int G, int nf, int ni, long long n,
                                        double* __restrict__ fout, long long* __restrict__ iout,
                                        void* __restrict__ cnt, int cnt64,
                                        long long* __restrict__ rep) {
  const int e = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int A = nf + ni + 2;
  if (e >= A * G) return;
  const int a = e / G, g = e % G;
  const long long* p = partial + (long long)e * blocks;
  if (a < nf) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 128) {
      double x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = b + 32 * k < blocks ? __longlong_as_double(p[b + 32 * k]) : 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += x[k];
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) fout[(long long)a * G + g] = s;
    return;
  }
  const bool is_min = a == A - 1;
  long long s = is_min ? n : 0;
  for (int b = lane; b < blocks; b += 128) {
    long long x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = b + 32 * k < blocks ? p[b + 32 * k] : (is_min ? n : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) s = is_min ? min(s, x[k]) : s + x[k];
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, s, o);
    s = is_min ? min(s, y) : s + y;
  }
  if (lane != 0) return;
  if (is_min)
    rep[g] = s;
  else if (a == A - 2 && cnt64)
    ((long long*)cnt)[g] = s;
  else if (a == A - 2)
    ((int32_t*)cnt)[g] = (int32_t)s;
  else
    iout[(long long)(a - nf) * G + g] = s;
}

// ---------------------------------------------------------------------------
// K6: the one-hot product on the FP64 tensor cores
// ---------------------------------------------------------------------------
//
// The reference's K6 stacks its columns and multiplies them by the n x
// (G + 1) one-hot of the bucket ids on the TPU's matrix unit.  Here the
// product runs on Hopper's FP64 tensor cores (mma.sync m16n8k16, sm_90):
// buckets are M, the product's columns N, rows K.  The one-hot operand is
// built in registers from each row's bucket id and never stored; invalid
// rows (and the rows past n) take bucket -1, which no tile row matches.
//
// What bounds it: bytes.  Each distinct column is read once (a column that
// feeds two partials, as l_quantity feeds sum(l_quantity) and the count in
// avg(l_quantity), is one source), with the codes and the mask; the outputs
// are a few hundred entries.  Q1: 5 float64 columns, 2 int32 codes and the
// mask, 49 B a row, 15.3 us at 2^20 rows; its product, 16 buckets x 8
// columns (six used), is 2^27 FMAs, about 4 us at 67 TFLOP/s.  Q5's, 32
// buckets x 8 columns for one column, is as large on 13 B a row.
//
// Design, deterministic (the same bits every run):
// - QK_OH_BLOCKS_PER_SM persistent blocks an SM (grid.x: the resident
//   blocks, or the tiles when fewer); block b takes the tiles b, b +
//   grid.x, ... of T rows (T the largest of 512, 256, 128 and 64 whose
//   buffers fit), so that one block's barriers overlap another's work;
// - thread 0 keeps a ring of QK_OH_STAGES stages in flight: each source's,
//   code's and the mask's span of a tile is one cp.async.bulk (TMA, 1-D)
//   into the stage, on the stage's mbarrier (the tail tile past the last
//   whole one is read with plain loads after the ring has drained);
// - a tile's scan pass (row by thread) writes each row's bucket id, takes
//   the smallest row of a bucket by a shared atomicMin (read first, so
//   that only a bucket's first rows in a block write) and ORs into one
//   word the sources that hold NaN, an infinity or the int sentinel;
// - a float64 column with none of those in the tile is read by the MMA
//   from the stage as it lies (under __nn0 too: it has no NaN to drop),
//   and the count column is a tile of ones, since the one-hot already
//   zeroes invalid rows.  Only the other columns pass through a
//   conversion into a column-major B tile padded to T + 4 rows: a float
//   column (float32, or a tile with a special value: NaN to 0 under
//   __nn0), an integer column as three 22-bit limbs (the low two
//   unsigned, the top one signed: each limb's sum stays an exact integer
//   in float64 far past 2^25 rows, and the reduce puts them together mod
//   2^64, so int64 sums wrap as index_add_ does).  A non-finite float goes
//   in as 0 (NaN x 0 would poison every bucket of its tile) and sets its
//   bucket's NaN, +inf or -inf flag by an order-free atomicOr, applied in
//   the epilogue: NaN if any NaN or both infinities, else that infinity.
//   A count(x) / avg(x) count is no product column: its nulls are counted
//   by shared atomicAdd in the tiles whose source holds one, and the
//   reduce takes them from the ones column.  Sources are padded by 32 B
//   in a stage, so that fragment loads of neighbouring columns fall on
//   other banks;
// - the MMA pass: (16-bucket tile, 8-column tile) pairs are shared out to
//   the warps, and when they are fewer than the warps the rows of a tile
//   are cut into slices too; each warp keeps its pairs' accumulators in
//   registers across its tiles, C independent chains a pair so that MMAs
//   overlap;
// - at the end a block adds its chains, then its slices, in order into
//   shared memory and writes [entries][blocks] partials; a second kernel
//   adds each entry's blocks in block order (a warp an entry), so the
//   result does not depend on timing.  More than QK_OH_PAIRS pairs (wide
//   plans at many buckets) are cut into chunks of columns, grid.y.
// On the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6-7) a tile's
// scan and its product each cost about 5-8 us of Q1 sort's 29-32: the
// product is padded to 8 columns and 16 buckets a tile, and at Q5's 32
// buckets and one column it is about half of the call.

#define QK_OH_MAX_SRC 32                        // distinct columns read
#define QK_OH_MAX_ENT QK_AGG_MAX_COLS           // entries (partial sums)
#define QK_OH_MAX_COLS (3 * QK_OH_MAX_ENT + 1)  // product columns: limbs, the ones
#define QK_OH_WARPS 8
#define QK_OH_BLOCKS_PER_SM 2
#define QK_OH_STAGES 2     // at most 3
#define QK_OH_SMEM_SM 233472  // shared memory of an SM on sm_90, 1 KB of it a block's own
#define QK_OH_TILE 512     // rows a tile at most
#define QK_OH_K 16         // rows an MMA takes
#define QK_OH_PAIRS 64     // (bucket tile, column tile) pairs a block at most
#define QK_OH_LIMB 22      // bits of an integer limb
#define QK_OH_SPIN (1u << 24)  // failed waits on a stage before the kernel traps

// what a product column takes from its source
enum { QK_OH_F = 0, QK_OH_L0 = 1, QK_OH_L1 = 2, QK_OH_L2 = 3, QK_OH_ONE = 4 };

struct QkOhIn {
  const void* src[QK_OH_MAX_SRC];  // the distinct columns, 16-byte aligned
  const int32_t* codes[QK_AGG_MAX_KEYS];
  int src_type[QK_OH_MAX_SRC];     // QK_AGG_F64 ... QK_AGG_I32
  int src_off[QK_OH_MAX_SRC];      // byte offset of a source's span in a stage
  int code_off[QK_AGG_MAX_KEYS];
  int stride[QK_AGG_MAX_KEYS];
  int valid_off, stage_bytes;      // the bytes a stage receives (T x row bytes)
  int stage_span;                  // a stage's bytes in shared memory (with the pads)
  int ns, nk, ne, ncols, ncnt, G, T, nb;  // nb: product columns a chunk
  unsigned col[QK_OH_MAX_COLS];    // source | op << 8 | entry << 16 | __nn0 << 24
  unsigned cnt[QK_OH_MAX_ENT];     // the count(x) entries: source | entry << 8
};

// how the reduce forms an entry: kind 0 a float column, 1 three limb
// columns from `at`, 2 the ones column less the null-count row `at`
struct QkOhRed {
  int ne, nf, G, ncols, ncnt, one;
  int kind[QK_OH_MAX_ENT];
  int at[QK_OH_MAX_ENT];
};

__host__ __device__ __forceinline__ int qk_oh_size(int type) {
  return (type == QK_AGG_F64 || type == QK_AGG_I64) ? 8 : 4;
}

__device__ __forceinline__ uint32_t qk_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void qk_mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void qk_mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool qk_mbar_try_wait(uint32_t bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void qk_bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a source's value at row r of a stage, as raw 64 bits (as qk_agg_raw)
__device__ __forceinline__ long long qk_oh_raw(const unsigned char* st, const QkOhIn& in, int s,
                                               int r) {
  const unsigned char* p = st + in.src_off[s];
  switch (in.src_type[s]) {
    case QK_AGG_F64:
    case QK_AGG_I64: return ((const long long*)p)[r];
    case QK_AGG_F32: return (long long)(uint32_t)((const int*)p)[r];
    default: return (long long)((const int*)p)[r];
  }
}

// d[16 x 8] += onehot[16 x 16] * B[16 x 8] (m16n8k16): bk points at the
// row (lane & 3) of the step, m is the lane's bucket (lane >> 2) of the
// bucket tile, b at the lane's column (lane >> 2) and row (lane & 3) of the
// step's B rows; a lane holds rows lane & 3 + 4j, j < 4, of both operands
__device__ __forceinline__ void qk_oh_mma(double* d, const int* bk, int m, const double* b) {
  double a[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[2 * j] = bk[4 * j] == m ? 1.0 : 0.0;
    a[2 * j + 1] = bk[4 * j] == m + 8 ? 1.0 : 0.0;
  }
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[4]), "d"(b[8]), "d"(b[12]));
}

// a float64 column's addends can be read as they lie in a stage when the
// tile holds no NaN or infinity in that column (bit s of spec clear):
// then __nn0 changes nothing and the product sees only finite values
__device__ __forceinline__ bool qk_oh_in_place(const QkOhIn& in, unsigned d, unsigned spec) {
  const int s = d & 0xff;
  return ((d >> 8) & 0xff) == QK_OH_F && in.src_type[s] == QK_AGG_F64 && !((spec >> s) & 1u);
}

// do rows r (even) and, when two, r + 1 of source s hold a value the
// product cannot take as it lies: NaN or an infinity (floats), the null
// sentinel (integers)?
__device__ __forceinline__ bool qk_oh_special(const unsigned char* st, const QkOhIn& in, int s,
                                              int r, bool two) {
  const unsigned char* p = st + in.src_off[s];
  switch (in.src_type[s]) {
    case QK_AGG_F64: {
      const uint4 q = ((const uint4*)p)[r >> 1];  // the high words: y, w
      return (q.y & 0x7ff00000u) == 0x7ff00000u || (two && (q.w & 0x7ff00000u) == 0x7ff00000u);
    }
    case QK_AGG_F32: {
      const uint2 q = ((const uint2*)p)[r >> 1];
      return (q.x & 0x7f800000u) == 0x7f800000u || (two && (q.y & 0x7f800000u) == 0x7f800000u);
    }
    case QK_AGG_I64: {
      const longlong2 q = ((const longlong2*)p)[r >> 1];
      return q.x == LLONG_MIN || (two && q.y == LLONG_MIN);
    }
    default: {
      const int2 q = ((const int2*)p)[r >> 1];
      return q.x == INT_MIN || (two && q.y == INT_MIN);
    }
  }
}

// shared memory: the stages (each source's span padded by 32 B, so that
// fragment loads from neighbouring sources fall on other banks); their
// mbarriers and two words of per-tile source flags (32 B); B [nb][T + 4]
// float64 for the columns that are converted; T float64 ones (the count
// column, and columns past the last); the block's sums [16 MT][nb]
// float64; the tile's bucket ids [T]; the smallest rows [16 MT]; the
// flags and null counts [16 MT][ne]
template <int PPW, int C>
__global__ void __launch_bounds__(QK_OH_WARPS * 32, QK_OH_BLOCKS_PER_SM)
    qk_onehot_mma_kernel(const __grid_constant__ QkOhIn in, const uint8_t* __restrict__ valid,
                         long long n, double* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char qk_oh_smem[];
  const int T = in.T, G = in.G, nb = in.nb, ne = in.ne;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int MT = (G + 15) >> 4, Gp = MT << 4;
  const int c0 = blockIdx.y * nb, ncol = min(nb, in.ncols - c0);
  const int NT = (ncol + 7) >> 3, P = MT * NT;
  const int LD = T + 4;
  const bool first = blockIdx.y == 0;  // the chunk that counts nulls and smallest rows
  unsigned char* stages = qk_oh_smem;
  unsigned long long* bar =
      (unsigned long long*)(stages + (size_t)QK_OH_STAGES * in.stage_span);
  unsigned* spec_word = (unsigned*)(bar + 3);
  double* B = (double*)(bar + 4);
  double* ones = B + (size_t)nb * LD;
  double* acc_s = ones + T;
  int* bk = (int*)(acc_s + (size_t)Gp * nb);
  int* minrow = bk + T;
  unsigned* side = (unsigned*)(minrow + Gp);
  const int bx = blockIdx.x, BX = gridDim.x;
  const long long full = n / T;
  const int tail = (int)(n - full * T);
  const long long mine = full > bx ? (full - 1 - bx) / BX + 1 : 0;  // this block's whole tiles

  auto issue = [&](long long i) {  // thread 0: tile i of this block into its stage
    const int s = (int)(i % QK_OH_STAGES);
    const long long r0 = (bx + i * BX) * (long long)T;
    unsigned char* dst = stages + (size_t)s * in.stage_span;
    const uint32_t b = qk_smem(&bar[s]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    qk_mbar_expect_tx(b, (unsigned)in.stage_bytes);
    for (int k = 0; k < in.ns; ++k) {
      const int es = qk_oh_size(in.src_type[k]);
      qk_bulk_load(qk_smem(dst + in.src_off[k]), (const char*)in.src[k] + r0 * es,
                   (unsigned)(T * es), b);
    }
    for (int k = 0; k < in.nk; ++k)
      qk_bulk_load(qk_smem(dst + in.code_off[k]), in.codes[k] + r0, (unsigned)(T * 4), b);
    qk_bulk_load(qk_smem(dst + in.valid_off), valid + r0, (unsigned)T, b);
  };

  // the first tiles' copies go out before the rest of the set-up
  if (tid == 0) {
    for (int s = 0; s < QK_OH_STAGES; ++s) qk_mbar_init(qk_smem(&bar[s]), 1);
    spec_word[0] = spec_word[1] = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long i = 0; i < QK_OH_STAGES && i < mine; ++i) issue(i);
  }
  for (int i = tid; i < Gp * nb; i += blockDim.x) acc_s[i] = 0.0;
  for (int i = tid; i < T; i += blockDim.x) ones[i] = 1.0;
  for (int i = tid; i < Gp; i += blockDim.x) minrow[i] = INT_MAX;
  for (int i = tid; i < Gp * ne; i += blockDim.x) side[i] = 0u;
  // the sources whose values this chunk's product reads in place or
  // counts nulls of (watch), and whether some column is converted on
  // every tile (always)
  unsigned watch = 0u;
  bool always = false;
  for (int c = 0; c < ncol; ++c) {
    const unsigned d = in.col[c0 + c];
    if (qk_oh_in_place(in, d, 0u))
      watch |= 1u << (d & 0xff);
    else if (((d >> 8) & 0xff) != QK_OH_ONE)
      always = true;
  }
  if (first)
    for (int j = 0; j < in.ncnt; ++j) watch |= 1u << (in.cnt[j] & 0xff);
  __syncthreads();

  // each row's bucket id (-1: invalid, or past the rows), the smallest
  // rows, and which sources hold a special value in this tile; a thread
  // takes two neighbouring rows, each source's pair in one load
  auto scan = [&](const unsigned char* st, long long r0, int rows, unsigned* sw) {
    unsigned spec = 0u;
    for (int r = 2 * tid; r < T; r += 2 * blockDim.x) {
      const uchar2 v = *(const uchar2*)(st + in.valid_off + r);
      int i0 = 0, i1 = 0;
      for (int k = 0; k < in.nk; ++k) {
        const int2 c = *(const int2*)(st + in.code_off[k] + 4 * r);
        i0 += (c.x + 1) * in.stride[k];
        i1 += (c.y + 1) * in.stride[k];
      }
      const int b0 = r < rows && v.x && (unsigned)i0 < (unsigned)G ? i0 : -1;
      const int b1 = r + 1 < rows && v.y && (unsigned)i1 < (unsigned)G ? i1 : -1;
      *(int2*)(bk + r) = make_int2(b0, b1);
      const int row = (int)(r0 + r);
      if (first && b0 >= 0 && row < minrow[b0]) atomicMin(&minrow[b0], row);
      if (first && b1 >= 0 && row + 1 < minrow[b1]) atomicMin(&minrow[b1], row + 1);
      if (r < rows)
        for (int s = 0; s < in.ns; ++s)
          if (((watch >> s) & 1u) && qk_oh_special(st, in, s, r, r + 1 < rows)) spec |= 1u << s;
    }
    spec = __reduce_or_sync(0xffffffffu, spec);
    if (lane == 0 && spec) atomicOr(sw, spec);
  };

  // the columns that are not read in place, as float64 into B: a float
  // column (NaN to 0 under __nn0), an integer column's 22-bit limbs; a
  // non-finite float goes in as 0 and flags its bucket; the nulls of a
  // count(x) entry whose source holds a special value are counted
  auto convert = [&](const unsigned char* st, unsigned spec) {
    for (int r = tid; r < T; r += blockDim.x) {
      const int b = bk[r];
      int last = -1;
      long long raw = 0;
      for (int c = 0; c < ncol; ++c) {
        const unsigned d = in.col[c0 + c];
        const int s = d & 0xff, op = (d >> 8) & 0xff;
        if (op == QK_OH_ONE || qk_oh_in_place(in, d, spec)) continue;
        if (s != last) {
          raw = qk_oh_raw(st, in, s, r);
          last = s;
        }
        double x = 0.0;
        if (b >= 0) {
          const int tag = in.src_type[s] | ((d >> 24) ? QK_AGG_NN0 : 0);
          if (op == QK_OH_F) {
            x = qk_agg_float(tag, raw);
            if (!isfinite(x)) {
              atomicOr(&side[b * ne + ((d >> 16) & 0xff)], x != x ? 1u : x > 0.0 ? 2u : 4u);
              x = 0.0;
            }
          } else {
            const long long v = qk_agg_int(tag, raw);
            x = (double)(op == QK_OH_L2 ? v >> (2 * QK_OH_LIMB)
                                        : (v >> ((op - QK_OH_L0) * QK_OH_LIMB))
                                              & ((1ll << QK_OH_LIMB) - 1));
          }
        }
        B[c * LD + r] = x;
      }
      if (first && b >= 0)
        for (int j = 0; j < in.ncnt; ++j) {
          const int s = in.cnt[j] & 0xff;
          if (((spec >> s) & 1u)
              && qk_agg_int(in.src_type[s] | QK_AGG_NNCOUNT, qk_oh_raw(st, in, s, r)) == 0)
            atomicAdd(&side[b * ne + (in.cnt[j] >> 8)], 1u);
        }
    }
  };

  // the warps' share of the product: KS slices of a tile's rows, WPS warps
  // a slice, each warp the pairs wi, wi + WPS, ... of its slice
  const int KSTEPS = T / QK_OH_K;
  int KS = 1;
  while (KS < QK_OH_WARPS && 2 * KS * P <= QK_OH_WARPS && 2 * KS <= KSTEPS) KS *= 2;
  const int WPS = QK_OH_WARPS / KS, ks = warp / WPS, wi = warp % WPS;
  const int s_lo = ks * (KSTEPS / KS), s_hi = s_lo + KSTEPS / KS;
  double acc[PPW][C][4];
#pragma unroll
  for (int j = 0; j < PPW; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c][e] = 0.0;
  const int* bkl = bk + (lane & 3);

  // B's fragments come from the stage (a column read in place), from the
  // converted tile, or from the ones (the count column, columns past the
  // last)
  auto product = [&](const unsigned char* st, unsigned spec) {
    const double* col[PPW];
#pragma unroll
    for (int j = 0; j < PPW; ++j) {
      const int p = wi + j * WPS, nn = (p % NT) * 8 + (lane >> 2), cg = c0 + nn;
      const double* at = ones;
      if (p < P && nn < ncol) {
        const unsigned d = in.col[cg];
        if (qk_oh_in_place(in, d, spec))
          at = (const double*)(st + in.src_off[d & 0xff]);
        else if (((d >> 8) & 0xff) != QK_OH_ONE)
          at = B + nn * LD;
      }
      col[j] = at + (lane & 3);
    }
    for (int s = s_lo; s < s_hi; s += C) {
#pragma unroll
      for (int j = 0; j < PPW; ++j) {
        const int p = wi + j * WPS;
        if (p < P) {
          const int m = (p / NT) * 16 + (lane >> 2);
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (s + c < s_hi) {
              const int k0 = (s + c) * QK_OH_K;
              qk_oh_mma(acc[j][c], bkl + k0, m, col[j] + k0);
            }
        }
      }
    }
  };

  auto tile = [&](const unsigned char* st, long long r0, int rows, long long i) {
    unsigned* sw = spec_word + (i & 1);
    if (rows < T && tid == 0) atomicOr(sw, ~0u);  // the tail: no column read in place
    scan(st, r0, rows, sw);
    __syncthreads();  // bucket ids and flags written
    const unsigned spec = *sw;
    if (tid == 0) spec_word[(i + 1) & 1] = 0u;
    if (always || (spec & watch)) {
      convert(st, spec);
      __syncthreads();
    }
    product(st, spec);
    __syncthreads();  // the stage, B and the bucket ids are read
  };

  for (long long i = 0; i < mine; ++i) {
    const int s = (int)(i % QK_OH_STAGES);
    const uint32_t b = qk_smem(&bar[s]);
    const unsigned parity = (unsigned)((i / QK_OH_STAGES) & 1);
    unsigned spins = 0;
    while (!qk_mbar_try_wait(b, parity))
      if (++spins == QK_OH_SPIN) __trap();  // a lost copy: fail, do not hang
    tile(stages + (size_t)s * in.stage_span, (bx + i * BX) * (long long)T, T, i);
    if (tid == 0 && i + QK_OH_STAGES < mine) issue(i + QK_OH_STAGES);
  }
  if (tail && full % BX == bx) {  // the tail tile, by plain loads into stage 0
    const long long r0 = full * T;
    for (int k = 0; k < in.ns; ++k) {
      const int es = qk_oh_size(in.src_type[k]);
      for (int r = tid; r < tail; r += blockDim.x) {
        if (es == 8)
          ((long long*)(stages + in.src_off[k]))[r] = ((const long long*)in.src[k])[r0 + r];
        else
          ((int*)(stages + in.src_off[k]))[r] = ((const int*)in.src[k])[r0 + r];
      }
    }
    for (int k = 0; k < in.nk; ++k)
      for (int r = tid; r < tail; r += blockDim.x)
        ((int*)(stages + in.code_off[k]))[r] = in.codes[k][r0 + r];
    for (int r = tid; r < tail; r += blockDim.x) stages[in.valid_off + r] = valid[r0 + r];
    __syncthreads();
    tile(stages, r0, tail, mine);
  }

  // the block's sums: each pair's chains in order, then the slices in order
  for (int k = 0; k < KS; ++k) {
    if (ks == k) {
#pragma unroll
      for (int j = 0; j < PPW; ++j) {
        const int p = wi + j * WPS;
        if (p < P) {
          const int m = (p / NT) * 16 + (lane >> 2), col = (p % NT) * 8 + 2 * (lane & 3);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            double x = acc[j][0][e];
#pragma unroll
            for (int c = 1; c < C; ++c) x += acc[j][c][e];
            acc_s[(m + 8 * (e >> 1)) * nb + col + (e & 1)] += x;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < ncol * G; e += blockDim.x) {
    const int c = e / G, g = e - c * G;
    const unsigned d = in.col[c0 + c];
    double x = acc_s[g * nb + c];
    if (((d >> 8) & 0xff) == QK_OH_F) {
      const unsigned f = side[g * ne + ((d >> 16) & 0xff)];
      if ((f & 1u) || (f & 6u) == 6u)
        x = __longlong_as_double(0x7ff8000000000000ll);
      else if (f & 2u)
        x = __longlong_as_double(0x7ff0000000000000ll);
      else if (f & 4u)
        x = __longlong_as_double((long long)0xfff0000000000000ull);
    }
    partial[((long long)(c0 + c) * G + g) * BX + bx] = x;
  }
  if (first) {
    for (int e = tid; e < in.ncnt * G; e += blockDim.x) {
      const int j = e / G, g = e - j * G;
      partial[((long long)(in.ncols + j) * G + g) * BX + bx] =
          (double)side[g * ne + (in.cnt[j] >> 8)];
    }
    for (int g = tid; g < G; g += blockDim.x)
      partial[((long long)(in.ncols + in.ncnt) * G + g) * BX + bx] = (double)minrow[g];
  }
}

// a row of partials added over the blocks: lane l takes blocks l, l + 32,
// ... in order, then a fixed shuffle tree (lane 0 holds the sum)
__device__ __forceinline__ double qk_oh_sum(const double* p, int blocks, int lane) {
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += p[b];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// one warp an output (item, bucket): the entries, then the count, then the
// smallest row
__global__ void qk_onehot_reduce_kernel(const __grid_constant__ QkOhRed r,
                                        const double* __restrict__ partial, int blocks,
                                        long long n, double* __restrict__ fout,
                                        long long* __restrict__ iout, int32_t* __restrict__ cnt,
                                        long long* __restrict__ rep) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int G = r.G;
  if (w >= (r.ne + 2) * G) return;
  const int item = w / G, g = w - item * G;
  auto row = [&](int c) { return partial + ((long long)c * G + g) * blocks; };
  if (item == r.ne + 1) {
    const double* p = row(r.ncols + r.ncnt);
    double m = (double)INT_MAX;
    for (int b = lane; b < blocks; b += 32) m = fmin(m, p[b]);
    for (int o = 16; o > 0; o >>= 1) m = fmin(m, __shfl_down_sync(0xffffffffu, m, o));
    if (lane == 0) rep[g] = m >= (double)INT_MAX ? n : (long long)m;
    return;
  }
  if (item == r.ne) {
    const double s = qk_oh_sum(row(r.one), blocks, lane);
    if (lane == 0) cnt[g] = (int32_t)s;
    return;
  }
  const int kind = r.kind[item], at = r.at[item];
  if (kind == 0) {
    const double s = qk_oh_sum(row(at), blocks, lane);
    if (lane == 0) fout[(long long)item * G + g] = s;
    return;
  }
  unsigned long long v;
  if (kind == 1) {
    const double s0 = qk_oh_sum(row(at), blocks, lane);
    const double s1 = qk_oh_sum(row(at + 1), blocks, lane);
    const double s2 = qk_oh_sum(row(at + 2), blocks, lane);
    v = (unsigned long long)(long long)s0
        + ((unsigned long long)(long long)s1 << QK_OH_LIMB)
        + ((unsigned long long)(long long)s2 << (2 * QK_OH_LIMB));
  } else {
    const double all = qk_oh_sum(row(r.one), blocks, lane);
    const double nulls = qk_oh_sum(row(r.ncols + at), blocks, lane);
    v = (unsigned long long)((long long)all - (long long)nulls);
  }
  if (lane == 0) iout[(long long)(item - r.nf) * G + g] = (long long)v;
}

typedef void (*QkOhKernel)(const QkOhIn, const uint8_t*, long long, double*);

extern "C" {

// The bucket aggregate (K2 and K6).  cols: nf float columns then ni integer
// columns of n rows, tags[c] their QK_AGG_* types (| QK_AGG_NN0 or, for an
// integer column, | QK_AGG_NNCOUNT over a column of any type); codes:
// nk int32 columns; valid: n uint8.  partial holds cap_blocks x (nf + ni +
// 2) x n_groups 8-byte entries of scratch.  Outputs: fout [nf][n_groups]
// float64, iout [ni][n_groups] int64, cnt [n_groups] (int64 when cnt64,
// else int32), rep [n_groups] int64 (n where a bucket is empty).
int qk_small_agg(const void* const* cols, const int* tags, int nf, int ni,
                 const void* const* codes, const int* strides, int nk, const void* valid,
                 long long n, int n_groups, void* partial, int cap_blocks, void* fout,
                 void* iout, void* cnt, int cnt64, void* rep, void* stream) {
  if (nf < 0 || ni < 0 || nf + ni > QK_AGG_MAX_COLS || nk < 1 || nk > QK_AGG_MAX_KEYS
      || n_groups < 1 || n_groups > QK_AGG_MAX_BUCKETS - 1 || n < 0 || cap_blocks < 1)
    return (int)cudaErrorInvalidValue;
  QkAggIn in;
  in.nf = nf;
  in.ni = ni;
  in.nk = nk;
  for (int c = 0; c < nf + ni; ++c) {
    const int t = tags[c] & 3;
    const bool fl = (t == QK_AGG_F64 || t == QK_AGG_F32) && !(tags[c] & QK_AGG_NNCOUNT);
    if ((c < nf) != fl || tags[c] & ~(3 | QK_AGG_NN0 | QK_AGG_NNCOUNT))
      return (int)cudaErrorInvalidValue;
    in.col[c] = cols[c];
    in.tag[c] = tags[c];
  }
  for (int k = 0; k < nk; ++k) {
    in.codes[k] = (const int32_t*)codes[k];
    in.stride[k] = strides[k];
  }
  const int A = nf + ni + 2;
  const size_t per_warp = (size_t)A * n_groups * 8 + 32 * 16;
  int warps = (int)(QK_AGG_SMEM / per_warp);
  warps = warps > QK_AGG_WARPS ? QK_AGG_WARPS : warps;
  const size_t smem = warps * per_warp;
  static size_t smem_set = 48 * 1024;  // the opt-in granted so far
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(qk_bucket_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  int dev = 0, sms = 1, per_sm = 1;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_bucket_agg_kernel,
                                                               warps * 32, smem)) != cudaSuccess)
    return (int)err;
  long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (n + warps * 32 - 1) / (warps * 32);
  blocks = blocks < need ? blocks : need;
  blocks = blocks < cap_blocks ? blocks : cap_blocks;
  blocks = blocks < 1 ? 1 : blocks;
  cudaStream_t st = (cudaStream_t)stream;
  qk_bucket_agg_kernel<<<(unsigned)blocks, warps * 32, smem, st>>>(
      in, (const uint8_t*)valid, n, n_groups, (long long*)partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int entries = A * n_groups;
  qk_bucket_reduce_kernel<<<(entries + 7) / 8, 256, 0, st>>>(
      (const long long*)partial, (int)blocks, n_groups, nf, ni, n, (double*)fout,
      (long long*)iout, cnt, cnt64, (long long*)rep);
  return (int)cudaGetLastError();
}

// K6, the one-hot product.  srcs: ns distinct columns of n rows (types
// src_types, QK_AGG_F64 ... QK_AGG_I32), 16-byte aligned; entries: nf float
// sums then ni integer sums, entry e reading source ent_src[e] under tag
// ent_tags[e] (the bucket core's tags); codes: nk int32 columns; valid: n
// uint8.  partial: partial_len float64 of scratch, at least (product
// columns + count(x) entries + 1) x n_groups x cap_blocks.  Outputs: fout
// [nf][n_groups] float64, iout [ni][n_groups] int64, cnt [n_groups] int32,
// rep [n_groups] int64 (n where a bucket is empty).
int qk_onehot_agg(const void* const* srcs, const int* src_types, int ns, const int* ent_src,
                  const int* ent_tags, int nf, int ni, const void* const* codes,
                  const int* strides, int nk, const void* valid, long long n, int n_groups,
                  void* partial, long long partial_len, int cap_blocks, void* fout, void* iout,
                  void* cnt, void* rep, void* stream) {
  const int ne = nf + ni, G = n_groups;
  if (ns < 0 || ns > QK_OH_MAX_SRC || nf < 0 || ni < 0 || ne > QK_OH_MAX_ENT || nk < 1
      || nk > QK_AGG_MAX_KEYS || G < 1 || G > QK_AGG_MAX_BUCKETS - 1 || n < 1
      || n > INT_MAX - QK_OH_TILE || cap_blocks < 1 || ((uintptr_t)valid & 15))
    return (int)cudaErrorInvalidValue;
  QkOhIn in;
  QkOhRed red;
  memset(&in, 0, sizeof in);
  memset(&red, 0, sizeof red);
  int rb = 1 + 4 * nk;  // bytes a row of a stage
  for (int s = 0; s < ns; ++s) {
    if (src_types[s] < 0 || src_types[s] > 3 || ((uintptr_t)srcs[s] & 15))
      return (int)cudaErrorInvalidValue;
    in.src[s] = srcs[s];
    in.src_type[s] = src_types[s];
    rb += qk_oh_size(src_types[s]);
  }
  for (int k = 0; k < nk; ++k) {
    if ((uintptr_t)codes[k] & 15) return (int)cudaErrorInvalidValue;
    in.codes[k] = (const int32_t*)codes[k];
    in.stride[k] = strides[k];
  }
  int nc = 0;
  for (int e = 0; e < ne; ++e) {
    const int tag = ent_tags[e], s = ent_src[e], t = tag & 3;
    if (s < 0 || s >= ns || src_types[s] != t || (tag & ~(3 | QK_AGG_NN0 | QK_AGG_NNCOUNT)))
      return (int)cudaErrorInvalidValue;
    const bool fl = (t == QK_AGG_F64 || t == QK_AGG_F32) && !(tag & QK_AGG_NNCOUNT);
    if ((e < nf) != fl) return (int)cudaErrorInvalidValue;
    const unsigned nn0 = (tag & QK_AGG_NN0) ? 1u << 24 : 0u;
    if (fl) {
      red.kind[e] = 0;
      red.at[e] = nc;
      in.col[nc++] = s | QK_OH_F << 8 | e << 16 | nn0;
    } else if (tag & QK_AGG_NNCOUNT) {
      red.kind[e] = 2;
      red.at[e] = in.ncnt;
      in.cnt[in.ncnt++] = s | e << 8;
    } else {
      red.kind[e] = 1;
      red.at[e] = nc;
      for (int l = 0; l < 3; ++l) in.col[nc++] = s | (QK_OH_L0 + l) << 8 | e << 16 | nn0;
    }
  }
  red.one = nc;
  in.col[nc++] = QK_OH_ONE << 8;
  in.ns = ns;
  in.nk = nk;
  in.ne = ne;
  in.ncols = nc;
  in.G = G;
  red.ne = ne;
  red.nf = nf;
  red.G = G;
  red.ncols = nc;
  red.ncnt = in.ncnt;
  // columns a chunk: at most QK_OH_PAIRS (bucket tile, column tile) pairs
  const int MT = (G + 15) / 16, Gp = 16 * MT, nt_all = (nc + 7) / 8;
  int ntc = QK_OH_PAIRS / MT;
  ntc = ntc < nt_all ? ntc : nt_all;
  in.nb = 8 * ntc;
  const int chunks = (nt_all + ntc - 1) / ntc;
  // per device: the SMs, and the shared-memory opt-in of each kernel
  static int sms_of[64], opted[64][4];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms_of[dev]
      && (err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev))
             != cudaSuccess)
    return (int)err;
  long long resident = (long long)QK_OH_BLOCKS_PER_SM * sms_of[dev];
  resident = resident < cap_blocks ? resident : cap_blocks;
  // rows a tile: the most whose buffers fit QK_OH_BLOCKS_PER_SM blocks an SM
  size_t budget = QK_OH_SMEM_SM / QK_OH_BLOCKS_PER_SM - 1024, smem = 0;
  budget = budget < QK_AGG_SMEM ? budget : QK_AGG_SMEM;
  int T = QK_OH_TILE;
  for (; T >= 64; T /= 2) {
    const size_t span = (size_t)T * rb + 32 * ns + 16;
    smem = QK_OH_STAGES * span + 32 + (size_t)in.nb * (T + 4) * 8 + (size_t)T * 8
           + (size_t)Gp * in.nb * 8 + (size_t)T * 4 + (size_t)Gp * 4 + (size_t)Gp * ne * 4;
    if (smem <= budget) break;
  }
  if (T < 64) return (int)cudaErrorInvalidValue;
  in.T = T;
  int off = 0;
  for (int s = 0; s < ns; ++s) {  // 32 B between sources: fragment loads spread over banks
    in.src_off[s] = off;
    off += T * qk_oh_size(src_types[s]) + 32;
  }
  for (int k = 0; k < nk; ++k) {
    in.code_off[k] = off;
    off += T * 4;
  }
  in.valid_off = off;
  in.stage_span = (off + T + 15) / 16 * 16;
  in.stage_bytes = T * rb;
  // the kernel by the pairs a warp holds
  const int pairs = MT * ntc, ppw = (pairs + QK_OH_WARPS - 1) / QK_OH_WARPS;
  static const QkOhKernel kernels[4] = {qk_onehot_mma_kernel<1, 4>, qk_onehot_mma_kernel<2, 4>,
                                        qk_onehot_mma_kernel<4, 2>, qk_onehot_mma_kernel<8, 1>};
  const int which = ppw <= 1 ? 0 : ppw <= 2 ? 1 : ppw <= 4 ? 2 : 3;
  if (!opted[dev][which]) {
    err = cudaFuncSetAttribute(kernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)budget);
    if (err != cudaSuccess) return (int)err;
    opted[dev][which] = 1;
  }
  long long blocks = (n + T - 1) / T;
  blocks = blocks < resident ? blocks : resident;
  if ((long long)(nc + in.ncnt + 1) * G * blocks > partial_len) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  kernels[which]<<<dim3((unsigned)blocks, (unsigned)chunks), QK_OH_WARPS * 32, smem, st>>>(
      in, (const uint8_t*)valid, n, (double*)partial);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int items = (ne + 2) * G;
  qk_onehot_reduce_kernel<<<(items + 7) / 8, 256, 0, st>>>(
      red, (const double*)partial, (int)blocks, n, (double*)fout, (long long*)iout,
      (int32_t*)cnt, (long long*)rep);
  return (int)cudaGetLastError();
}

}  // extern "C"
