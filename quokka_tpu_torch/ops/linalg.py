"""Gramian kernel K22: the masked ``m^T m`` and column sums of a batch.

Port of the reference's ``executors/linalg.py:37`` ``_accumulate``: the
batch's columns stacked and cast to float32 (``:46``), invalid rows zeroed
(a null float stays NaN and propagates, as there), then the Gramian and the
column sums.  The port forms each product of two float32 values exactly in
float64 and sums in float64, where the reference sums in float32: the
result is the exact sum of the reference's products up to float64
rounding.  CUDA tensors launch the kernel (``csrc/linalg.cu``: one pass
with the sums in registers for up to 8 columns, shared-memory staging past
8; block partials, then the last block adds them in block order and writes
the symmetric [d, d] and the sums, so the result is the same every run);
CPU tensors take ``gramian_plain``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from quokka_tpu_torch.obs import devprof
from quokka_tpu_torch.ops import native

# launches of K22
LAUNCHES = 0
MAX_COLUMNS = 128
_SMALL_D = 8  # up to this many columns the kernel keeps its sums in registers
_THREADS = 256
_DT = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3, torch.bool: 4}


def _lib():
    lib = native.library("linalg")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_gramian.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_int), I, L, P, I, P, P, P, P]
        lib.qk_gramian.restype = I
        lib.qk_gram_blocks_per_sm.argtypes = [I]
        lib.qk_gram_blocks_per_sm.restype = I
        lib.qk_bound = True
    return lib


def _masked_f32(cols: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    m = torch.stack([c.to(torch.float32) for c in cols], 1)
    return torch.where(valid[:, None], m, torch.zeros((), dtype=m.dtype, device=m.device))


def gramian_plain(cols: Sequence[torch.Tensor],
                  valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K22: (``m^T m`` [d, d], column sums [d]), float64."""
    m = _masked_f32(cols, valid).to(torch.float64)
    return m.T @ m, m.sum(0)


_PER_SM = {}  # (device index, d) -> blocks of the d <= 8 kernel an SM holds


def _blocks(dev, d: int, n: int) -> int:
    """The launch's blocks: the card full at the kernel's occupancy (d <=
    8), or two an SM (d > 8)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if d > _SMALL_D:
        return 2 * sms
    key = (dev.index, d)
    if key not in _PER_SM:
        got = _lib().qk_gram_blocks_per_sm(d)
        if got <= 0:
            raise RuntimeError(f"qk_gram_blocks_per_sm: CUDA error {-got}" if got else
                               f"qk_gram_blocks_per_sm: no block of d = {d} fits an SM")
        _PER_SM[key] = got
    return max(1, min(sms * _PER_SM[key], -(-n // _THREADS)))


def gramian_cuda(cols: Sequence[torch.Tensor],
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    dev = valid.device
    if dev.type != "cuda":
        raise RuntimeError(f"gramian: unsupported device {dev}")
    d, n = len(cols), valid.shape[0]
    if not 1 <= d <= MAX_COLUMNS:
        raise NotImplementedError(
            f"gramian: {d} columns; K22 takes 1 to {MAX_COLUMNS}: ROADMAP Queue 1, "
            "\"The rest of the vector tier\"")
    cols: List[torch.Tensor] = [c.contiguous() for c in cols]
    if (valid.dtype != torch.bool
            or any(c.dtype not in _DT or c.shape != (n,) or c.device != dev for c in cols)):
        raise TypeError("gramian: needs 1-D float64 / float32 / int64 / int32 / bool "
                        "columns of the mask's length on its device")
    entries = d * (d + 1) // 2 + d
    blocks = _blocks(dev, d, n)
    stream = native.stream_ptr(dev)
    # the Gramian [d, d], the sums [d], then the block partials [blocks, entries]
    out = torch.empty(d * d + d + blocks * entries, dtype=torch.float64, device=dev)
    base = out.data_ptr()
    native.check(_lib().qk_gramian(
        native.ptr_array([c.view(torch.uint8).data_ptr() if c.dtype == torch.bool
                          else c.data_ptr() for c in cols]),
        native.int_array([_DT[c.dtype] for c in cols]), d, n,
        valid.contiguous().view(torch.uint8).data_ptr(), blocks, base + 8 * (d * d + d),
        native.tickets(dev, stream).data_ptr(), base, stream), "qk_gramian")
    LAUNCHES += 1
    return out[:d * d].view(d, d), out[d * d:d * d + d]


def gramian(cols: Sequence[torch.Tensor],
            valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K22: (``m^T m``, column sums) in float64 of the columns cast to
    float32 with invalid rows zeroed.  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    d = len(cols)
    out = 8 * (d * (d + 1) // 2 + d)
    devprof.on_dispatch(("K22", valid.device.type, valid.shape[0], tuple(str(c.dtype) for c in cols)),
                        lambda: (0.0, float(devprof.nbytes(*cols, valid) + out), float(out)))
    if valid.device.type == "cpu":
        return gramian_plain(cols, valid)
    return gramian_cuda(cols, valid)
