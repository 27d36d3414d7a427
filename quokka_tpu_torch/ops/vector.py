"""Vector search kernel K21: fused cosine similarity + per-query top-k.

Port of the reference's ``executors/vector.py:49`` ``_sims`` with
``jax.lax.top_k`` (``:61``) and the host merge of the running state
(``:82-91``).  ``sims_topk`` scores every row of a batch against the
normalised queries, keeps each query's ``min(k, rows)`` best in
``lax.top_k``'s order, and merges them into the running ``[Q, k]`` state
(scores float32, row handles int64) in the host merge's order:

- a batch's order: the IEEE total order of the float32 bits (NaN, made the
  positive quiet NaN, above +inf; +0.0 above -0.0), ties to the lower row;
- the merge's order: by value with -0.0 equal to +0.0, NaN below -inf,
  ties keeping the running state first, then the batch in its own order;
  an empty slot (handle -1) last.

A row of batch ``b`` gets the handle ``(b << 32) | row``.  The scores are
``(q . v) / max(|v|, 1e-12)`` in float32, the vectors converted to float32
first: a null (zero) row scores 0 and an invalid row -inf.  CUDA tensors
launch the kernel (``csrc/vector.cu``, k up to ``MAX_K``; beyond it a CUDA
batch raises): a prologue that converts the batch to float32 tiles with
each row's scale, a register-tiled float32 product with a threshold-filtered
top-k per row split, and the merge; CPU tensors take ``sims_topk_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import native

# launches of K21
LAUNCHES = 0
MAX_K = 128
_TN = 128  # rows per tile of the main kernel (csrc/vector.cu QK_TN)
_TQ = 128  # queries per block (QK_TQ)
_PAD = 16  # the float32 scratch's depth stride: d rounded up to it (QK_PAD)
_MAX_SPLIT = 64  # row splits the merge takes (QK_MAX_S)
_NAN = float("nan")
_PLAIN_ROWS = 1 << 16  # rows per chunk of the plain version's score matrix

EMPTY_HANDLE = -1


def normalize_queries(queries) -> np.ndarray:
    """The reference's host normalisation, ``q / max(|q|, 1e-12)`` in
    float32."""
    q = np.asarray(queries, dtype=np.float32)
    return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)


def empty_state(nq: int, k: int, device):
    """A running state with every slot empty."""
    return (torch.full((nq, k), float("-inf"), dtype=torch.float32, device=device),
            torch.full((nq, k), EMPTY_HANDLE, dtype=torch.int64, device=device))


def _lib():
    lib = native.library("vector")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_sims_topk.argtypes = [P, I, I, P, L, P, I, I, I, L, P, P, P, P, P, P, L, P, P,
                                     P]
        lib.qk_sims_topk.restype = I
        lib.qk_sims_slots.argtypes = [I]
        lib.qk_sims_slots.restype = I
        lib.qk_bound = True
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _total_key(s: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) whose order is the IEEE total order of float32
    ``s``."""
    bits = s.contiguous().view(torch.int32)
    signed = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return signed.to(torch.int64) + (1 << 31)


def _merge_key(s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The host merge's order as an int64: empty 0, NaN 1, then by value."""
    zeroed = torch.where(s == 0, torch.zeros_like(s), s)
    mk = 2 + _total_key(zeroed)
    mk = torch.where(torch.isnan(s), torch.ones_like(mk), mk)
    return torch.where(h < 0, torch.zeros_like(mk), mk)


def _scores(q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[Q, rows] float32 cosine scores of one chunk of rows."""
    v = v.to(torch.float32)
    inv = 1.0 / torch.clamp(torch.sqrt((v * v).sum(1)), min=1e-12)
    s = (q @ v.T) * inv[None, :]
    s = torch.where(torch.isnan(s), torch.full_like(s, _NAN), s)
    return torch.where(valid[None, :], s, torch.full_like(s, float("-inf")))


def batch_topk_plain(q: torch.Tensor, vecs: torch.Tensor, valid: torch.Tensor, kb: int):
    """A batch's top ``kb`` per query in ``lax.top_k``'s order: (scores
    [Q, kb] float32, rows [Q, kb] int64).  Row chunks keep the score matrix
    small; a key packing (total-order key, inverted row) makes every entry
    distinct, so ``torch.topk`` gives the one order there is."""
    n = vecs.shape[0]
    dev = q.device
    if n >= 1 << 31:
        raise ValueError(f"sims_topk: {n} rows do not fit the row key")
    row_bits = max(1, n.bit_length())
    low = (1 << row_bits) - 1
    keys, scores = [], []
    for r0 in range(0, n, _PLAIN_ROWS):
        r1 = min(n, r0 + _PLAIN_ROWS)
        s = _scores(q, vecs[r0:r1], valid[r0:r1])
        rows = torch.arange(r0, r1, dtype=torch.int64, device=dev)
        key = (_total_key(s) << row_bits) | (low - rows)[None, :]
        top, at = torch.topk(key, min(kb, r1 - r0), dim=1)
        keys.append(top)
        scores.append(torch.gather(s, 1, at))
    if not keys or kb == 0:
        return (torch.zeros((q.shape[0], 0), dtype=torch.float32, device=dev),
                torch.zeros((q.shape[0], 0), dtype=torch.int64, device=dev))
    key, at = torch.topk(torch.cat(keys, 1), kb, dim=1)
    return torch.gather(torch.cat(scores, 1), 1, at), low - (key & low)


def sims_topk_plain(q: torch.Tensor, vecs: torch.Tensor, valid: torch.Tensor, k: int,
                    state_s: torch.Tensor, state_h: torch.Tensor, batch: int):
    """Plain version of K21.  Returns the new (scores [Q, k] float32,
    handles [Q, k] int64)."""
    bs, rows = batch_topk_plain(q, vecs, valid, min(k, vecs.shape[0]))
    ms = torch.cat([state_s, bs], 1)
    mh = torch.cat([state_h, (batch << 32) | rows], 1)
    width = ms.shape[1]
    pos_bits = max(1, width.bit_length())
    pos = torch.arange(width, dtype=torch.int64, device=q.device)
    ck = (_merge_key(ms, mh) << pos_bits) | ((1 << pos_bits) - 1 - pos)[None, :]
    _, at = torch.topk(ck, k, dim=1)
    return torch.gather(ms, 1, at), torch.gather(mh, 1, at)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _plan(nq: int, n: int, slots: int) -> tuple:
    """(row splits, rows per split) of a launch over ``n`` rows for ``nq``
    queries on a card that holds ``slots`` main-kernel blocks at once.
    Splits are whole 128-row tiles, every one holds rows, and together they
    cover [0, n) once.  Of 1 to ``_MAX_SPLIT`` splits it takes the fewest
    that least loads the busiest slot: whole waves of query tiles x splits,
    times the tiles per split."""
    q_tiles = max(1, -(-nq // _TQ))
    tiles = max(1, -(-n // _TN))
    best = None
    for s in range(1, min(_MAX_SPLIT, tiles) + 1):
        per = -(-tiles // s)
        used = -(-tiles // per)
        cost = -(-q_tiles * used // max(1, slots)) * per
        if best is None or cost < best[0]:
            best = (cost, used, per)
    return best[1], best[2] * _TN


_SLOTS = {}  # (device index, k) -> main-kernel blocks the card holds at once


def _slots(dev, k: int) -> int:
    key = (dev.index, k)
    if key not in _SLOTS:
        got = _lib().qk_sims_slots(k)
        if got <= 0:
            raise RuntimeError(f"qk_sims_slots: CUDA error {-got}" if got else
                               f"qk_sims_slots: the main kernel does not fit an SM at k = {k}")
        _SLOTS[key] = got
    return _SLOTS[key]


def sims_topk_cuda(q: torch.Tensor, vecs: torch.Tensor, valid: torch.Tensor, k: int,
                   state_s: torch.Tensor, state_h: torch.Tensor, batch: int):
    global LAUNCHES
    dev = vecs.device
    if dev.type != "cuda":
        raise RuntimeError(f"sims_topk: unsupported device {dev}")
    if k > MAX_K:
        raise NotImplementedError(
            f"sims_topk: k = {k} is above K21's cap of {MAX_K}: ROADMAP Queue 1, "
            "\"The rest of the vector tier\"")
    nq, d = q.shape
    n = vecs.shape[0]
    if (q.dtype != torch.float32 or vecs.dtype != torch.float64
            or vecs.dim() != 2 or vecs.shape[1] != d or valid.shape != (n,)
            or valid.dtype != torch.bool or state_s.shape != (nq, k)
            or state_h.shape != (nq, k) or state_s.dtype != torch.float32
            or state_h.dtype != torch.int64 or k < 1
            or any(t.device != dev for t in (q, valid, state_s, state_h))):
        raise TypeError("sims_topk: needs float32 queries [Q, d], float64 vectors [n, d], "
                        "bool valid [n] and a float32 / int64 [Q, k] state, all on one "
                        "device")
    if d == 0:
        raise ValueError("sims_topk: vectors of width 0")
    q, vecs = q.contiguous(), vecs.contiguous()
    state_s, state_h = state_s.contiguous(), state_h.contiguous()
    n_split, per = _plan(nq, n, _slots(dev, k))
    d_pad = -(-d // _PAD) * _PAD
    q_len = -(-nq // _TQ) * _TQ * d_pad
    n_rows = -(-n // _TN) * _TN
    # float32 scratch: the query tiles, the vector tiles, the rows' scales
    scratch = torch.empty(q_len + n_rows * (d_pad + 1), dtype=torch.float32, device=dev)
    cand = torch.empty((nq, n_split, k), dtype=torch.int64, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_h = torch.empty((nq, k), dtype=torch.int64, device=dev)
    base = scratch.data_ptr()
    native.check(_lib().qk_sims_topk(
        q.data_ptr(), nq, d, vecs.data_ptr(), n,
        valid.contiguous().view(torch.uint8).data_ptr(), k, min(k, n), n_split, per,
        base, base + 4 * q_len, base + 4 * (q_len + n_rows * d_pad), cand.data_ptr(),
        state_s.data_ptr(), state_h.data_ptr(), batch << 32, out_s.data_ptr(),
        out_h.data_ptr(), native.stream_ptr(dev)), "qk_sims_topk")
    LAUNCHES += 1
    return out_s, out_h


def sims_topk(q: torch.Tensor, vecs: torch.Tensor, valid: torch.Tensor, k: int,
              state_s: torch.Tensor, state_h: torch.Tensor, batch: int):
    """K21: merge batch ``batch``'s top k of cosine scores of ``vecs`` [n, d]
    against the normalised float32 queries ``q`` [Q, d] into the running
    state.  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    nq, (n, d) = q.shape[0], vecs.shape
    devprof.on_dispatch(
        ("K21", vecs.device.type, nq, n, d, str(vecs.dtype), k),
        lambda: (float(2 * nq * n * d),
                 float(n * d * vecs.element_size() + n + nq * d * 4 + 2 * nq * k * 12),
                 float(nq * k * 12)))
    if vecs.device.type == "cpu":
        return sims_topk_plain(q, vecs, valid, k, state_s, state_h, batch)
    return sims_topk_cuda(q, vecs, valid, k, state_s, state_h, batch)
