// Fused cosine similarity + per-query top-k for Hopper (sm_90a): K21.
//
// Replaces quokka_tpu/executors/vector.py:49 `_sims` with the
// `jax.lax.top_k` of :61 and the host merge of the running state at
// :82-91.  The reference normalises a batch's vectors, forms the whole
// [Q, N] similarity matrix (queries @ v.T), masks invalid rows to -inf,
// takes each query's top k, and merges that with the running [Q, k] state
// on the host.  At 10,000 queries and a 2^20-row batch that matrix is 42 GB;
// this kernel never writes it.
//
// What bounds it: operations.  2 Q N d float32 multiply-adds (2.1e12 at
// glove-100-angular's shape, 31.3 ms at 67 TFLOP/s) against N d 8 bytes of
// float64 vectors (0.25 ms at 3.35 TB/s).  The design is an SGEMM-class loop
// on the FMA units (no tensor cores, no TF32: every score is the one float32
// `fmaf` chain over the depth that the plain version's order tests hold):
//
// - The prologue (`qk_sims_stage_kernel`, one launch) converts the batch's
//   float64 vectors once to float32 (as `vec.data.astype(float32)` does)
//   into a scratch of 128-row tiles, each [d_pad][128] (depth-major, d_pad
//   = d rounded up to 16, so a depth slice of a tile is contiguous), and
//   writes each row's scale: 1 / max(|v|, 1e-12) from the same `fmaf` chain
//   of squares, or -1 for an invalid row; its last blocks lay the queries
//   out the same way.  Each vector byte is read once as float64 and once as
//   float32, not once per query tile.
// - The main kernel (`qk_sims_topk_kernel`) gives a block 128 queries and a
//   range of 128-row tiles.  Depth slices of 8 come in by `cp.async` into a
//   4-stage ring of shared memory; each of 256 threads holds an 8 x 8 block
//   of scores in registers (128 registers, two blocks an SM, no spills) and
//   reads its operands as float4 (two broadcast, two across 256 contiguous
//   bytes: no bank conflicts).
// - After each tile every thread tests its 64 scores against its queries'
//   thresholds (the list's k-th key as of the query's last fold, in shared
//   memory): first one bound per query from the largest |acc * scale|
//   (integer max of the bits), which rejects most tiles in a few
//   instructions, then exact keys.  A key that passes takes a slot in the
//   query's 32-key queue (a shared atomic counter); no barrier is spent
//   unless a queue runs full.  Then the warps fold every queue at least half
//   full into its query's sorted list of k keys (ranks by shuffles and one
//   binary search), the thresholds rise, and the pending keys are offered
//   again; at the end the warps fold what the queues still hold.  While a
//   list holds fewer than k keys its threshold is 0 and every row enters,
//   -inf rows included.
// - Blocks with the query tiles fastest share one row range at a time in
//   L2; the wrapper picks the row splits so the blocks fill whole waves.
//   Each split writes its k best keys per query: [Q, S, k] candidates.
//   `qk_topk_merge_kernel`, one thread per query, merges the S sorted lists
//   into the batch's top kb and that into the running state.
//
// Arithmetic, bit for bit the earlier single-pass kernel's: the score is
// one `fmaf` chain over the depth in ascending order, zero-padded to a
// multiple of 16 (here the product reads the depth rounded up to 8; a depth
// that is a multiple of 8 but not of 16 adds the zero product that padding
// added: +0.0f, which turns a -0.0 into +0.0), times the row's scale; NaN
// becomes the positive quiet NaN and an invalid row -inf.  A batch's top k
// of unique keys does not depend on the order the keys are seen, so (out_s,
// out_h) are the same bits whatever the splits.
//
// Orders (held against the reference on the CPU, tests/test_torch_vector.py):
// - a batch's top k is lax.top_k's: the IEEE total order of the float bits
//   (NaN above +inf, +0.0 above -0.0), ties to the lower row.  NaN scores
//   are made the positive quiet NaN first;
// - the running merge is the reference's host merge, argsort(-scores):
//   by value with -0.0 equal to +0.0, NaN below -inf, ties keeping the
//   running state first, then the batch in its own order (a stable sort);
//   an empty slot (handle < 0) ranks below everything.
// Candidate keys pack (total-order key << 32) | (0xFFFFFFFF - row), so one
// unsigned compare orders score, then row; an empty candidate is 0, and
// every real key is above 0 (the least, -inf's, is 0x007FFFFF << 32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define QK_TQ 128      // queries per block
#define QK_TN 128      // rows per tile
#define QK_PAD 16      // the scratch's depth stride: d rounded up to 16
#define QK_TD 8        // depth of one staged slice: the product reads d rounded up to it
#define QK_STAGES 4    // slices in flight
#define QK_MIN_BLOCKS 2  // blocks an SM holds at k = 10 (caps registers at 128)
#define QK_THREADS 256
#define QK_WARPS (QK_THREADS / 32)
#define QK_QCAP 32     // a query's queue: keys that passed its threshold, not yet folded
#define QK_FOLD_AT (QK_QCAP / 2)  // when a queue runs full, fold those this full
#define QK_MAX_K 128
#define QK_MAX_S 64
#define QK_STAGE_COLS 16  // prologue: columns per staged chunk

static_assert(QK_PAD % QK_TD == 0, "a slice must divide the depth stride");
static_assert(QK_QCAP % 32 == 0, "a warp folds a queue 32 keys at a time");

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t qk_total_key(float s) {
  uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float qk_from_total_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the host merge's order: empty 0, NaN 1, then by value (-0.0 == +0.0)
__device__ __forceinline__ u64 qk_merge_key(float s, long long h) {
  if (h < 0) return 0ull;
  if (s != s) return 1ull;
  if (s == 0.0f) s = 0.0f;
  return 2ull + (u64)qk_total_key(s);
}

// the score of the dot product `acc` of a row with scale `sc` (-1: the row
// is invalid)
__device__ __forceinline__ float qk_score(float acc, float sc, bool pad_fix) {
  float s = pad_fix ? acc + 0.0f : acc;
  s = s * sc;
  if (s != s) s = __uint_as_float(0x7fc00000u);
  return sc < 0.0f ? -INFINITY : s;
}

__device__ __forceinline__ u64 qk_key(float s, uint32_t row) {
  return ((u64)qk_total_key(s) << 32) | (u64)(0xFFFFFFFFu - row);
}

__device__ __forceinline__ void qk_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void qk_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void qk_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(QK_STAGES - 2));
}

// Prologue: blocks [0, n_tiles) take 128 rows each of the vectors v [n, d]
// (row major), blocks past them 128 each of the queries q [nq, d], into
// tiles [d_pad][128] float32 of vt / qt (depth columns [0, d_used) written,
// zero beyond d and beyond the last row).  A vector row also gets its scale:
// 1 / max(|v|, 1e-12) over the float32 values (one fmaf chain in column
// order), or -1 where the row is invalid.
__global__ void __launch_bounds__(QK_TN)
    qk_sims_stage_kernel(const double* __restrict__ v, long long n,
                         const uint8_t* __restrict__ valid, const float* __restrict__ q, int nq,
                         int d, int d_pad, int d_used, unsigned int n_tiles,
                         float* __restrict__ vt, float* __restrict__ qt,
                         float* __restrict__ scale) {
  __shared__ float chunk[QK_TN][QK_STAGE_COLS + 1];
  const int t = threadIdx.x;
  const bool is_q = blockIdx.x >= n_tiles;
  const unsigned int tile = is_q ? blockIdx.x - n_tiles : blockIdx.x;
  const long long rows = is_q ? nq : n;
  const long long r0 = (long long)tile * QK_TN;
  float* out = (is_q ? qt : vt) + (long long)tile * d_pad * QK_TN;
  // thread t stages column t % 16 of rows t / 16 + 8 m
  const int c = t % QK_STAGE_COLS, rb = t / QK_STAGE_COLS;
  float ss = 0.0f;
  for (int c0 = 0; c0 < d_used; c0 += QK_STAGE_COLS) {
    const int col = c0 + c;
    float x[QK_STAGE_COLS];  // 128 rows x 16 columns over 128 threads: 16 each
#pragma unroll
    for (int m = 0; m < QK_STAGE_COLS; ++m) {
      const long long row = r0 + rb + 8 * m;
      x[m] = 0.0f;
      if (row < rows && col < d) x[m] = is_q ? q[row * d + col] : (float)v[row * d + col];
    }
#pragma unroll
    for (int m = 0; m < QK_STAGE_COLS; ++m) chunk[rb + 8 * m][c] = x[m];
    __syncthreads();
    for (int cc = 0; cc < QK_STAGE_COLS && c0 + cc < d_used; ++cc) {
      const float y = chunk[t][cc];
      ss = fmaf(y, y, ss);
      out[(long long)(c0 + cc) * QK_TN + t] = y;
    }
    __syncthreads();
  }
  if (!is_q) {
    const long long row = r0 + t;
    scale[row] = (row < rows && valid[row]) ? 1.0f / fmaxf(sqrtf(ss), 1e-12f) : -1.0f;
  }
}

// Merge c (<= 32) unsorted keys Q into L, the k best keys sorted best
// first (0 = empty), by one warp.  Keys are unique, so the ranks are a
// permutation.
__device__ __forceinline__ void qk_fold_queue(u64* L, int k, const u64* Q, int c, int lane) {
  const u64 x = lane < c ? Q[lane] : 0ull;
  int pos = 0;  // keys of the queue above x, then of the list above x
  for (int t = 0; t < c; ++t) pos += __shfl_sync(0xffffffffu, x, t) > x;
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (L[mid] > x) lo = mid + 1;
    else hi = mid;
  }
  pos += lo;
  u64 lv[QK_MAX_K / 32];
  int lp[QK_MAX_K / 32];
#pragma unroll
  for (int m = 0; m < QK_MAX_K / 32; ++m) {
    const int i = lane + 32 * m;
    lv[m] = i < k ? L[i] : 0ull;
    lp[m] = i;
  }
  for (int t = 0; t < c; ++t) {
    const u64 y = __shfl_sync(0xffffffffu, x, t);
#pragma unroll
    for (int m = 0; m < QK_MAX_K / 32; ++m) lp[m] += y > lv[m];
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < QK_MAX_K / 32; ++m)
    if (lane + 32 * m < k && lp[m] < k) L[lp[m]] = lv[m];
  if (lane < c && pos < k) L[pos] = x;
  __syncwarp();
}

// By each warp, for its queries warp + 8 l (l < 16): fold every queue that
// holds at least `at_least` keys into its query's list, and raise the
// query's threshold to the list's k-th key.
__device__ __forceinline__ void qk_fold_queues(u64* lists, const u64* queue, u64* thr, int* cnt,
                                               int k, int at_least, int warp, int lane) {
  const int mine = lane < QK_TQ / QK_WARPS ? cnt[warp + QK_WARPS * lane] : 0;
  unsigned todo = __ballot_sync(0xffffffffu, mine > 0 && mine >= at_least);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int qq = warp + QK_WARPS * l;
    const int c = min(__shfl_sync(0xffffffffu, mine, l), QK_QCAP);
    for (int c0 = 0; c0 < c; c0 += 32)
      qk_fold_queue(lists + qq * k, k, queue + qq * QK_QCAP + c0, min(c - c0, 32), lane);
    if (lane == 0) {
      thr[qq] = lists[qq * k + k - 1];
      cnt[qq] = 0;
    }
  }
}

__global__ void __launch_bounds__(QK_THREADS, QK_MIN_BLOCKS)
    qk_sims_topk_kernel(const float* __restrict__ qt, int nq, int d_pad, int d_used,
                        const float* __restrict__ vt, const float* __restrict__ scale,
                        long long n, int k, int pad_fix, long long rows_per_split, int n_split,
                        u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = (float*)smem;                               // [STAGES][TD][TQ]
  float* Bs = As + QK_STAGES * QK_TD * QK_TQ;             // [STAGES][TD][TN]
  u64* lists = (u64*)(Bs + QK_STAGES * QK_TD * QK_TN);    // [TQ][k], best first
  u64* queue = lists + QK_TQ * k;                         // [TQ][QCAP]
  u64* thr = queue + QK_TQ * QK_QCAP;                     // [TQ]: the list's k-th key
  int* cnt = (int*)(thr + QK_TQ);                         // [TQ]: keys queued

  // thread tid holds queries qa + {0..3} and qa + 64 + {0..3}, and rows
  // ra + {0..3} and ra + 64 + {0..3} of the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qa = (tid >> 4) * 4, ra = (tid & 15) * 4;
  const int q0 = blockIdx.x * QK_TQ;
  const int split = blockIdx.y;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = r_begin + rows_per_split < n ? r_begin + rows_per_split : n;
  const int steps = (int)((r_end - r_begin + QK_TN - 1) / QK_TN);
  const int nsl = d_used / QK_TD;
  const float* a_tile = qt + (long long)blockIdx.x * d_pad * QK_TQ;
  const float* b_tiles = vt + r_begin * d_pad;  // r_begin is a multiple of 128

  for (int i = tid; i < QK_TQ * k; i += QK_THREADS) lists[i] = 0ull;
  for (int i = tid; i < QK_TQ; i += QK_THREADS) {
    thr[i] = 0ull;
    cnt[i] = 0;
  }

  // the block's slices in order: tile by tile, each tile's depth slices
  int ld_st = 0, ld_ks = 0, ld_buf = 0;
  auto load_next = [&]() {
    if (ld_st < steps) {
      const float* a = a_tile + ld_ks * (QK_TD * QK_TQ);
#pragma unroll
      for (int e = tid * 4; e < QK_TD * QK_TQ; e += QK_THREADS * 4)
        qk_cp_async16(As + ld_buf * (QK_TD * QK_TQ) + e, a + e);
      const float* b = b_tiles + (long long)ld_st * d_pad * QK_TN + ld_ks * (QK_TD * QK_TN);
#pragma unroll
      for (int e = tid * 4; e < QK_TD * QK_TN; e += QK_THREADS * 4)
        qk_cp_async16(Bs + ld_buf * (QK_TD * QK_TN) + e, b + e);
      if (++ld_ks == nsl) {
        ld_ks = 0;
        ++ld_st;
      }
      if (++ld_buf == QK_STAGES) ld_buf = 0;
    }
    qk_cp_commit();
  };
  for (int s = 0; s < QK_STAGES - 1; ++s) load_next();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int buf = 0;
  for (int st = 0; st < steps; ++st) {
    for (int ks = 0; ks < nsl; ++ks) {
      qk_cp_wait();
      __syncthreads();  // this slice has landed, and the last one's buffer is free
      load_next();
      const float* a = As + buf * (QK_TD * QK_TQ) + qa;
      const float* b = Bs + buf * (QK_TD * QK_TN) + ra;
#pragma unroll
      for (int kk = 0; kk < QK_TD; ++kk) {
        const float4 a0 = *(const float4*)(a + kk * QK_TQ);
        const float4 a1 = *(const float4*)(a + kk * QK_TQ + 64);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float4 b0 = *(const float4*)(b + kk * QK_TN);
        const float4 b1 = *(const float4*)(b + kk * QK_TN + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (++buf == QK_STAGES) buf = 0;
    }

    // the tile's scores are complete: fold them into the lists
    const long long row0 = r_begin + (long long)st * QK_TN + ra;
    const float4 s0 = *(const float4*)(scale + row0);
    const float4 s1 = *(const float4*)(scale + row0 + 64);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    // each score above its query's threshold (the list's k-th key when the
    // query's queue was last folded) takes a slot in the query's queue, or
    // stays pending (its score in place of its sum) while the queue is full
    u64 pend = 0ull;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qq = qa + (i < 4 ? 0 : 64) + (i & 3);
      const u64 th = thr[qq];
      // first a bound: no key of the query's scores exceeds that of the
      // largest |acc * sc| (a NaN product is a positive quiet NaN, above the
      // canonical one; the +0.0 of the padding and -inf of an invalid row
      // only lower a key)
      uint32_t top = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        top = max(top, __float_as_uint(acc[i][j] * sc[j]) & 0x7fffffffu);
      if ((u64)(top | 0x80000000u) < (th >> 32) || q0 + qq >= nq) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long row = row0 + (j >> 2) * 64 + (j & 3);
        const float s = qk_score(acc[i][j], sc[j], pad_fix != 0);
        acc[i][j] = s;
        const u64 key = qk_key(s, (uint32_t)row);
        if (row < r_end && key > th) {
          const int slot = atomicAdd(&cnt[qq], 1);
          if (slot < QK_QCAP) queue[qq * QK_QCAP + slot] = key;
          else pend |= 1ull << (i * 8 + j);
        }
      }
    }
    // a queue ran full: fold the queues at least half full, then offer the
    // pending keys again against the raised thresholds
    while (__syncthreads_or(pend != 0ull)) {
      qk_fold_queues(lists, queue, thr, cnt, k, QK_FOLD_AT, warp, lane);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qq = qa + (i < 4 ? 0 : 64) + (i & 3);
        const u64 th = thr[qq];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int bit = i * 8 + j;
          if ((pend >> bit) & 1ull) {
            const long long row = row0 + (j >> 2) * 64 + (j & 3);
            const u64 key = qk_key(acc[i][j], (uint32_t)row);
            bool done = key <= th;
            if (!done) {
              const int slot = atomicAdd(&cnt[qq], 1);
              if (slot < QK_QCAP) {
                queue[qq * QK_QCAP + slot] = key;
                done = true;
              }
            }
            if (done) pend &= ~(1ull << bit);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  __syncthreads();
  qk_fold_queues(lists, queue, thr, cnt, k, 1, warp, lane);  // what the queues still hold
  __syncthreads();
  for (int i = tid; i < QK_TQ * k; i += QK_THREADS) {
    const int qq = i / k, j = i % k;
    if (q0 + qq < nq) cand[((long long)(q0 + qq) * n_split + split) * k + j] = lists[i];
  }
}

__global__ void qk_topk_merge_kernel(const u64* __restrict__ cand, int nq, int n_split, int k,
                                     int kb, const float* __restrict__ state_s,
                                     const long long* __restrict__ state_h, long long handle_hi,
                                     float* __restrict__ out_s, long long* __restrict__ out_h) {
  int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float* os = out_s + (long long)qi * k;
  long long* oh = out_h + (long long)qi * k;
  // the running state is already in merge order: it starts the stable merge
  for (int j = 0; j < k; ++j) {
    os[j] = state_s[(long long)qi * k + j];
    oh[j] = state_h[(long long)qi * k + j];
  }
  const u64* C = cand + (long long)qi * n_split * k;
  int pos[QK_MAX_S];
  for (int s = 0; s < n_split; ++s) pos[s] = 0;
  for (int t = 0; t < kb; ++t) {
    // the batch's next best candidate (lax.top_k order)
    u64 best = 0ull;
    int bs = -1;
    for (int s = 0; s < n_split; ++s) {
      if (pos[s] < k) {
        u64 c = C[(long long)s * k + pos[s]];
        if (c > best) {
          best = c;
          bs = s;
        }
      }
    }
    if (bs < 0) break;
    pos[bs]++;
    float sc = qk_from_total_key((uint32_t)(best >> 32));
    long long h = handle_hi | (long long)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFull));
    u64 mk = qk_merge_key(sc, h);
    if (mk <= qk_merge_key(os[k - 1], oh[k - 1])) continue;  // ties keep the earlier entry
    int p = k - 1;
    while (p > 0 && qk_merge_key(os[p - 1], oh[p - 1]) < mk) {
      os[p] = os[p - 1];
      oh[p] = oh[p - 1];
      --p;
    }
    os[p] = sc;
    oh[p] = h;
  }
}

static size_t qk_sims_smem(int k) {
  return (size_t)QK_STAGES * QK_TD * (QK_TQ + QK_TN) * sizeof(float) +
         (size_t)QK_TQ * (k + QK_QCAP + 1) * sizeof(u64) + (size_t)QK_TQ * sizeof(int);
}

static int qk_sims_attr(int k) {
  return (int)cudaFuncSetAttribute(qk_sims_topk_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)qk_sims_smem(k));
}

extern "C" {

// Blocks of the main kernel the card holds at once at this k (SMs times
// blocks per SM), or minus a CUDA error.
int qk_sims_slots(int k) {
  if (k < 1 || k > QK_MAX_K) return -(int)cudaErrorInvalidValue;
  int err = qk_sims_attr(k);
  if (err != 0) return -err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qk_sims_topk_kernel,
                                                            QK_THREADS, qk_sims_smem(k));
  if (err != 0) return -err;
  return sms * per_sm;
}

// q [nq, d] float32 (normalised), v [n, d] float64, valid [n] uint8,
// state_s [nq, k] float32 and state_h [nq, k] int64 (the running state in
// merge order; handle -1 = empty).  Scratch: qt [ceil(nq / 128) * d_pad *
// 128] and vt [ceil(n / 128) * d_pad * 128] float32, scale [ceil(n / 128) *
// 128] float32, cand [nq, n_split, k] uint64, with d_pad = d rounded up to
// a multiple of 16.  Rows [s * rows_per_split, (s + 1) * rows_per_split) go
// to split s (rows_per_split a multiple of 128).  out_s / out_h [nq, k]
// receive the merged state; a row of this batch gets the handle (batch <<
// 32) | row, with handle_hi = batch << 32.
int qk_sims_topk(const void* q, int nq, int d, const void* v, long long n, const void* valid,
                 int k, int kb, int n_split, long long rows_per_split, void* qt, void* vt,
                 void* scale, void* cand, const void* state_s, const void* state_h,
                 long long handle_hi, void* out_s, void* out_h, void* stream) {
  if (nq < 0 || d < 1 || n < 0 || k < 1 || k > QK_MAX_K || kb < 0 || kb > k ||
      n_split < 1 || n_split > QK_MAX_S || rows_per_split < 1 ||
      rows_per_split % QK_TN != 0 || n > 0xFFFFFFFFll ||
      (long long)n_split * rows_per_split < n ||
      (long long)(n_split - 1) * rows_per_split >= (n > 0 ? n : 1))
    return (int)cudaErrorInvalidValue;
  if (nq == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int d_pad = (d + QK_PAD - 1) / QK_PAD * QK_PAD;
  const int d_used = (d + QK_TD - 1) / QK_TD * QK_TD;
  // the earlier kernel padded the depth to 16: a depth that this one does
  // not pad (a multiple of the slice) but that one did adds its zero
  // product in the epilogue
  const int pad_fix = (d % 16 != 0) && (d_used == d);
  if (n > 0 && kb > 0) {
    const unsigned int q_tiles = (unsigned int)((nq + QK_TQ - 1) / QK_TQ);
    const unsigned int n_tiles = (unsigned int)((n + QK_TN - 1) / QK_TN);
    qk_sims_stage_kernel<<<n_tiles + q_tiles, QK_TN, 0, st>>>(
        (const double*)v, n, (const uint8_t*)valid, (const float*)q, nq, d, d_pad, d_used,
        n_tiles, (float*)vt, (float*)qt, (float*)scale);
    int err = qk_sims_attr(k);
    if (err != 0) return err;
    dim3 grid(q_tiles, (unsigned int)n_split);
    qk_sims_topk_kernel<<<grid, QK_THREADS, qk_sims_smem(k), st>>>(
        (const float*)qt, nq, d_pad, d_used, (const float*)vt, (const float*)scale, n, k,
        pad_fix, rows_per_split, n_split, (u64*)cand);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  } else {
    kb = 0;
  }
  qk_topk_merge_kernel<<<(nq + 127) / 128, 128, 0, st>>>(
      (const u64*)cand, nq, n_split, k, kb, (const float*)state_s, (const long long*)state_h,
      handle_hi, (float*)out_s, (long long*)out_h);
  return (int)cudaGetLastError();
}

}  // extern "C"
