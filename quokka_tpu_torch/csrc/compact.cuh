// The tile shape of K8 (csrc/concat.cu) and K17 (csrc/partition.cu): a
// block compacts or partitions one tile of 4096 rows, 16 rows a thread,
// each thread's validity bytes read with one 16-byte load (and K17's ids
// with four).

#pragma once

#define QK_CT_THREADS 256
#define QK_CT_ITEMS 16  // rows a thread: one 16-byte load of flags, four of int32
#define QK_CT_TILE (QK_CT_THREADS * QK_CT_ITEMS)
#define QK_CT_WARPS (QK_CT_THREADS / 32)
