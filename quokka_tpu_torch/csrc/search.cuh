// The sorted searches of K12 (csrc/join.cu) and K18 (csrc/asof.cu) for
// Hopper (sm_90a): one bound search over lexicographically sorted limbs,
// typed at compile time for the signatures the main paths use, and a
// runtime-dispatch twin for every other signature.
//
// Rows and limbs.  A sorted array is a set of limb columns (int32, int64,
// float32, float64, bool as uint8) compared lexicographically, IEEE `<` and
// `==` per limb, as the reference's _lex_lt_eq.  QkRow<Ts...> holds one row's
// limbs in registers; QkCols<Ts...> loads a row from the columns in device
// memory, every limb of a level before any comparison, so a level's loads
// issue together; QkStaged<Row> reads rows staged in shared memory.
// QkDyn compares limbs whose dtypes are known only at run time (a dtype
// `switch` per limb per level, reading both sides from device memory): the
// wrappers count the launches that take it.
//
// The search (qk_bound) walks power-of-two steps: with `step` the largest
// power of two <= n, it tests row pos + step - 1 and moves pos past it when
// the predicate holds, halving the step each level.  Positions are 32-bit
// (the wrappers refuse arrays of 2^31 rows or more), the trip count is
// floor(log2 n) + 1 whatever the data, and no row is read twice: the
// result is the row of the last test that failed (a test past the end
// fails with "not equal"), so the equality seen at that test is the
// equality at the result, and the caller needs no second read there.
//
// Why any exact search gives the full-range halving's answer.  Each search
// finds the boundary of a predicate over the sorted order:
//   upper bound: s[i] <= x;   lower bound: s[i] < x
// (lexicographic, IEEE per limb).  Both are monotone over the order the
// stable torch sorts give: NaN sorts last within its limb and compares
// neither less nor equal, so rows with a NaN limb are "greater" than every
// probe, and a NaN in the probe makes every row that agrees on the earlier
// limbs "greater"; -0.0 and +0.0 sort as equal and compare equal.  A
// monotone predicate has one boundary, so every exact search for it
// returns the same position: the halving of [lo, hi), these power-of-two
// steps, a search over runs of equal keys followed by a search inside the
// run (K18), a staged first level, or narrower indices.  K18's two levels
// rest on one more fact: runs split where neighbouring keys differ under
// `!=`, so a probe key without NaN equals at most one run (equal keys are
// contiguous in the sorted order) and a key with NaN equals none.
// tests/test_torch_search.py holds the two-level identity on NaN, -0.0
// and ties.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define QK_MAX_LIMBS 16

enum { QK_F64 = 0, QK_F32 = 1, QK_I64 = 2, QK_I32 = 3, QK_BOOL = 4 };

// -- the runtime-dispatch path ------------------------------------------------

struct TypedLimbs {
  const void* p[QK_MAX_LIMBS];
  int dt[QK_MAX_LIMBS];  // QK_F64 ... QK_BOOL
  int n;
};

template <typename T>
__device__ __forceinline__ void qk_cmp(const void* a, uint32_t ia, const void* b,
                                       uint32_t ib, bool* lt, bool* eq) {
  T x = ((const T*)a)[ia];
  T y = ((const T*)b)[ib];
  *lt = x < y;
  *eq = x == y;
}

__device__ __forceinline__ void qk_cmp_limb(int dt, const void* a, uint32_t ia,
                                            const void* b, uint32_t ib, bool* l, bool* e) {
  switch (dt) {
    case QK_F64: qk_cmp<double>(a, ia, b, ib, l, e); break;
    case QK_F32: qk_cmp<float>(a, ia, b, ib, l, e); break;
    case QK_I64: qk_cmp<long long>(a, ia, b, ib, l, e); break;
    case QK_I32: qk_cmp<int32_t>(a, ia, b, ib, l, e); break;
    default: qk_cmp<uint8_t>(a, ia, b, ib, l, e); break;
  }
}

// lexicographic (S[ia] < P[ib], S[ia] == P[ib]) over S.n limbs
__device__ __forceinline__ void qk_lex(const TypedLimbs& S, uint32_t ia, const TypedLimbs& P,
                                       uint32_t ib, bool* out_lt, bool* out_eq) {
  bool lt = false, eq = true;
  for (int j = 0; j < S.n; ++j) {
    bool l, e;
    qk_cmp_limb(S.dt[j], S.p[j], ia, P.p[j], ib, &l, &e);
    lt = lt || (eq && l);
    eq = eq && e;
  }
  *out_lt = lt;
  *out_eq = eq;
}

// sorted limbs S searched for probe row x of P (the key is the row index)
struct QkDyn {
  TypedLimbs S, P;
  __device__ __forceinline__ uint32_t load(uint32_t i) const { return i; }
  __device__ __forceinline__ void lex(uint32_t i, uint32_t x, bool* lt, bool* eq) const {
    qk_lex(S, i, P, x, lt, eq);
  }
};

// -- typed rows ---------------------------------------------------------------

template <typename... Ts>
struct QkRow;

template <>
struct QkRow<> {  // no limbs: every row equals every key
  __device__ __forceinline__ void lex(const QkRow&, bool* lt, bool* eq) const {
    *lt = false;
    *eq = true;
  }
};

template <typename T>
struct QkRow<T> {
  T v;
  __device__ __forceinline__ void lex(const QkRow& x, bool* lt, bool* eq) const {
    *lt = v < x.v;
    *eq = v == x.v;
  }
};

template <typename T, typename... Rest>
struct QkRow<T, Rest...> {
  T v;
  QkRow<Rest...> rest;
  __device__ __forceinline__ void lex(const QkRow& x, bool* lt, bool* eq) const {
    bool l, e;
    rest.lex(x.rest, &l, &e);
    *lt = v < x.v || (v == x.v && l);
    *eq = v == x.v && e;
  }
};

template <typename... Ts>
struct QkCols;

template <>
struct QkCols<> {
  typedef QkRow<> Row;
  static QkCols at(const void* const*) { return QkCols(); }
  __device__ __forceinline__ Row load(uint32_t) const { return Row(); }
  __device__ __forceinline__ void lex(uint32_t, const Row&, bool* lt, bool* eq) const {
    *lt = false;
    *eq = true;
  }
};

template <typename T>
struct QkCols<T> {
  typedef QkRow<T> Row;
  const T* p;
  static QkCols at(const void* const* ptrs) {
    QkCols c;
    c.p = (const T*)ptrs[0];
    return c;
  }
  __device__ __forceinline__ Row load(uint32_t i) const {
    Row r;
    r.v = __ldg(p + i);
    return r;
  }
  __device__ __forceinline__ void lex(uint32_t i, const Row& x, bool* lt, bool* eq) const {
    load(i).lex(x, lt, eq);
  }
};

template <typename T, typename... Rest>
struct QkCols<T, Rest...> {
  typedef QkRow<T, Rest...> Row;
  const T* p;
  QkCols<Rest...> rest;
  static QkCols at(const void* const* ptrs) {
    QkCols c;
    c.p = (const T*)ptrs[0];
    c.rest = QkCols<Rest...>::at(ptrs + 1);
    return c;
  }
  __device__ __forceinline__ Row load(uint32_t i) const {
    Row r;
    r.v = __ldg(p + i);
    r.rest = rest.load(i);
    return r;
  }
  __device__ __forceinline__ void lex(uint32_t i, const Row& x, bool* lt, bool* eq) const {
    load(i).lex(x, lt, eq);
  }
};

// rows staged in shared memory
template <class Row>
struct QkStaged {
  const Row* r;
  __device__ __forceinline__ void lex(uint32_t i, const Row& x, bool* lt, bool* eq) const {
    r[i].lex(x, lt, eq);
  }
};

// -- the search -----------------------------------------------------------------

// The boundary over rows [lo, lo + n) of src against key x: with kUpper the
// first row that is not <= x, else the first row that is not < x.  *eq is
// whether that row equals x (false when it is lo + n).
template <bool kUpper, class Src, class Key>
__device__ __forceinline__ uint32_t qk_bound(const Src& src, uint32_t lo, uint32_t n,
                                             const Key& x, bool* eq) {
  uint32_t pos = lo;
  const uint32_t end = lo + n;
  bool e = false;
  for (uint32_t step = n ? 1u << (31 - __clz((int)n)) : 0u; step != 0; step >>= 1) {
    const uint32_t idx = pos + step - 1;
    if (idx < end) {
      bool lt, q;
      src.lex(idx, x, &lt, &q);
      if (kUpper ? (lt || q) : lt) pos += step;
      else e = q;
    } else {
      e = false;
    }
  }
  *eq = e;
  return pos;
}
