// Wire decode for Hopper (sm_90a): K23.
//
// Replaces quokka_tpu/ops/pack.py:128 `_build_decode`, the jitted program
// (one per layout) that turns a batch's narrowed wire list back into its
// logical arrays: `arange(padded) < count` for the validity mask,
// `wire != 0` for bools, `(T)wire + bias` for integers narrowed to
// uint8 / uint16, and `table[code]` for float columns shipped as a
// dictionary.  Leaves shipped at full width ("pass") are not touched: they
// stay views into the copied buffer.
//
// The layout changes with each batch signature, so nothing of it is
// compiled in: the wrapper (ops/pack.py) stages one 64-byte descriptor per
// leaf in the same pinned buffer as the wires, and ONE launch decodes the
// whole batch, the grid's y dimension over leaves and a grid-stride loop
// over each leaf's elements.  Every descriptor is read once per block into
// shared memory; the kind branch is uniform across a block.  A dictionary
// entry is copied as a bit pattern (uint32 / uint64), so NaN payloads and
// -0.0 come back as they were shipped.
//
// What bounds it: bytes.  Each wire element (1 or 2 bytes) is read once and
// each logical element (1, 4 or 8 bytes) written once; the tables (at most
// 65,536 entries) stay in L1 / L2.  Per Q1 batch of 2^20 rows that is about
// 8 MB written and 5 MB read: about 4 us over 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

struct QkLeaf {
  long long src;    // byte offset of the wire in the buffer
  long long dst;    // output pointer
  long long n;      // elements
  long long bias;   // widen: the bias; valid: the live count
  long long table;  // dict: byte offset of the table in the buffer
  int kind;         // 0 valid, 1 bool, 2 widen, 3 dict
  int src_bytes;    // wire element width: 1 or 2
  int dst_bytes;    // output element width: 1, 4 or 8
  int table_len;    // dict: table entries
  long long pad;
};

static_assert(sizeof(QkLeaf) == 64, "QkLeaf must match ops/pack.py _DESC");

__device__ __forceinline__ unsigned qk_wire(const uint8_t* __restrict__ w, int bytes,
                                            long long i) {
  return bytes == 1 ? (unsigned)w[i] : (unsigned)((const uint16_t*)w)[i];
}

__global__ void __launch_bounds__(256)
qk_decode_kernel(const uint8_t* __restrict__ buf, const QkLeaf* __restrict__ leaves) {
  __shared__ QkLeaf L;
  if (threadIdx.x == 0) L = leaves[blockIdx.y];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint8_t* w = buf + L.src;
  switch (L.kind) {
    case 0: {
      uint8_t* out = (uint8_t*)L.dst;
      for (long long i = first; i < L.n; i += stride) out[i] = i < L.bias ? 1 : 0;
      break;
    }
    case 1: {
      uint8_t* out = (uint8_t*)L.dst;
      for (long long i = first; i < L.n; i += stride) out[i] = w[i] != 0 ? 1 : 0;
      break;
    }
    case 2: {
      if (L.dst_bytes == 4) {
        int32_t* out = (int32_t*)L.dst;
        const int32_t b = (int32_t)L.bias;
        for (long long i = first; i < L.n; i += stride)
          out[i] = (int32_t)qk_wire(w, L.src_bytes, i) + b;
      } else {
        long long* out = (long long*)L.dst;
        for (long long i = first; i < L.n; i += stride)
          out[i] = (long long)qk_wire(w, L.src_bytes, i) + L.bias;
      }
      break;
    }
    default: {
      const uint8_t* t = buf + L.table;
      if (L.dst_bytes == 8) {
        const unsigned long long* tab = (const unsigned long long*)t;
        unsigned long long* out = (unsigned long long*)L.dst;
        for (long long i = first; i < L.n; i += stride) out[i] = tab[qk_wire(w, L.src_bytes, i)];
      } else {
        const uint32_t* tab = (const uint32_t*)t;
        uint32_t* out = (uint32_t*)L.dst;
        for (long long i = first; i < L.n; i += stride) out[i] = tab[qk_wire(w, L.src_bytes, i)];
      }
      break;
    }
  }
}

extern "C" {

// buf: the copied buffer; its descriptors start at byte desc_off (256-byte
// aligned).  max_n: the largest leaf's element count.
int qk_decode(const void* buf, long long desc_off, int n_leaves, long long max_n,
              void* stream) {
  if (n_leaves <= 0) return 0;
  if (n_leaves > 65535) return (int)cudaErrorInvalidValue;
  long long bx = (max_n + 1023) / 1024;  // four elements a thread
  if (bx < 1) bx = 1;
  if (bx > 4096) bx = 4096;
  dim3 grid((unsigned)bx, (unsigned)n_leaves);
  qk_decode_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const QkLeaf*)((const uint8_t*)buf + desc_off));
  return (int)cudaGetLastError();
}

}  // extern "C"
