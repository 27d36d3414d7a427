"""Gramian kernel K22: the masked ``m^T m`` and column sums of a batch.

Port of the reference's ``executors/linalg.py:37`` ``_accumulate``: the
batch's columns stacked and cast to float32 (``:46``), invalid rows zeroed
(a null float stays NaN and propagates, as there), then the Gramian and the
column sums.  The port forms each product of two float32 values exactly in
float64 and sums in float64, where the reference sums in float32: the
result is the exact sum of the reference's products up to float64
rounding.  CUDA tensors launch the kernel (``csrc/linalg.cu``: block
partials, then a second pass in block order, so the result is the same
every run); CPU tensors take ``gramian_plain``.
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
_DT = {torch.float64: 0, torch.float32: 1, torch.int64: 2, torch.int32: 3, torch.bool: 4}


def _lib():
    lib = native.library("linalg")
    if not getattr(lib, "qk_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qk_gramian.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_int), I, L, P, I, P, P, P]
        lib.qk_gramian.restype = I
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


def _unpack(flat: torch.Tensor, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's output (upper triangle row by row, then the sums) as a
    symmetric [d, d] and [d]."""
    iu = torch.triu_indices(d, d, device=flat.device)
    g = torch.zeros((d, d), dtype=flat.dtype, device=flat.device)
    tri = flat[: iu.shape[1]]
    g[iu[0], iu[1]] = tri
    g[iu[1], iu[0]] = tri
    return g, flat[iu.shape[1]:]


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
    chunk = max(1, min(256, 11776 // d - 1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(2 * sms, -(-n // chunk)))
    partial = torch.empty((blocks, entries), dtype=torch.float64, device=dev)
    out = torch.empty(entries, dtype=torch.float64, device=dev)
    native.check(_lib().qk_gramian(
        native.ptr_array([c.view(torch.uint8).data_ptr() if c.dtype == torch.bool
                          else c.data_ptr() for c in cols]),
        native.int_array([_DT[c.dtype] for c in cols]), d, n,
        valid.contiguous().view(torch.uint8).data_ptr(), blocks, partial.data_ptr(),
        out.data_ptr(), native.stream_ptr(dev)), "qk_gramian")
    LAUNCHES += 1
    return _unpack(out, d)


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
