"""Build and bind the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/quokka_tpu_torch/lib<name>-<hash>.so`` beside the
package (the hash is of the source, of every header ``csrc/*.cuh`` and of
the flags, so an edited source or shared header such as ``csrc/search.cuh``
rebuilds), then loaded with ctypes.  Pointers and the stream are passed as
``c_void_p``; every entry point returns ``cudaGetLastError()``, which
``check`` raises on.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them, so a cold process pays for the slowest build, not the sum.  Triton
kernels compile through Triton's own cache, which ``triton_cache_dir()``
points into the same build directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

from quokka_tpu_torch import config

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = Path(config.CACHE_ROOT)
SOURCES = ("hashtable", "partition", "join", "asof", "window", "vector", "linalg", "onehot",
           "pack", "concat", "rank")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def triton_cache_dir() -> str:
    return str(BUILD_DIR / "triton")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out, cmd


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed for {name} ({' '.join(cmd)}):\n{log.decode(errors='replace')}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every listed source that is not built yet, in parallel."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, st in started.items():
            _finish(n, st)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    """The raw cudaStream_t of the device's current stream."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


_TICKETS = {}  # (device index, stream) -> zeroed int32 tickets
_TICKETS_LOCK = threading.Lock()


def tickets(device, stream: int, count: int = 1):
    """At least ``count`` int32 tickets of the stream, zeroed once: the
    kernels that take a ticket (a last-block count) leave it at zero, so
    launches on one stream share them."""
    import torch

    key = (device.index, stream)
    with _TICKETS_LOCK:  # the engine's threads share the default stream
        t = _TICKETS.get(key)
        if t is None or t.numel() < count:
            t = _TICKETS[key] = torch.zeros(count, dtype=torch.int32, device=device)
    return t


def ptr_array(ptrs: List[int]):
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


def int_array(vals: List[int]):
    return (ctypes.c_int * max(len(vals), 1))(*vals)
