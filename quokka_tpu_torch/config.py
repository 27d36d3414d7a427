"""Device resolution, padding buckets and engine defaults for the PyTorch port.

Counterpart of ``quokka_tpu/config.py``.  The port runs in the reference's
x64 regime with native dtypes: integers are int64, floats float64, dates
int32 days, string codes int32.  There is no compile cache to configure:
torch runs eagerly and the hand-written kernels build on first use
(``ops/native.py`` for CUDA C++, Triton's own cache for Triton).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

import torch

from quokka_tpu_torch.ops import sigkey

# where the port keeps what it builds and measures at run time (the CUDA
# libraries, Triton's cache, the devprof and cardinality profiles): inside
# the checkout, in a directory git ignores
CACHE_ROOT = str(Path(__file__).resolve().parent.parent / "build" / "quokka_tpu_torch")

MIN_BUCKET = sigkey.MIN_BUCKET
MAX_BUCKET = sigkey.MAX_BUCKET

# a join channel's build past this many rows would enter the reference's
# grace-join spill tier, which the port does not carry yet
SPILL_JOIN_BUILD_ROWS = 1 << 22

# Masked-split cap: a partition split stays in masked-view mode (no host
# sync, shared column buffers) while n_parts * padded_len is at or below
# this; past it the compacted split (K17) runs instead.  Read at import, as
# the reference does: set ``config.SHUFFLE_MASKED_CAP`` to change it later.
SHUFFLE_MASKED_CAP = int(os.environ.get("QUOKKA_SHUFFLE_MASKED_CAP", 1 << 25))

DEFAULT_EXEC_CONFIG = {
    # batches an executor may consume in one dispatch
    "max_pipeline_batches": 8,
    # outstanding (produced, unconsumed) input batches per source channel
    "max_pipeline": 3,
}

# options of the reference engine that this slice does not carry yet
UNSUPPORTED_EXEC_CONFIG = ("fault_tolerance", "checkpoint_interval",
                           "inject_failure", "inject_kill_worker",
                           "hbq_path")


def bucket_size(n: int) -> int:
    """Smallest padding bucket that fits n rows (the reference's ladder)."""
    return sigkey.bucket_rows(n)


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device a context or entry point runs on.

    ``None`` means CUDA: the port's entry points run on the card unless the
    caller asks for the CPU.  Without a CUDA device, anything but an
    explicit CPU request raises instead of quietly running on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions on "
                "the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {str(dev)!r}")
    return dev


def check_exec_config(exec_config: Optional[dict]) -> None:
    for key in exec_config or ():
        if key in UNSUPPORTED_EXEC_CONFIG:
            raise NotImplementedError(
                f"exec_config[{key!r}] needs the fault-tolerance slice, "
                "which quokka_tpu_torch does not carry yet")


def adapt_enabled() -> bool:
    """``QK_ADAPT=0`` turns the adaptive exchange off: no join is marked
    eligible (``planner/decide.py``) and the engine's skew trigger never
    fires.  Read on every call, so one process can run both variants."""
    return os.environ.get("QK_ADAPT", "1") not in ("0", "false", "no")


def adapt_min_rows() -> int:
    """Rows a join's build edge must have delivered before the skew trigger
    may fire (``QK_ADAPT_MIN_ROWS``, default 32768)."""
    try:
        return int(os.environ.get("QK_ADAPT_MIN_ROWS", 1 << 15))
    except ValueError:
        return 1 << 15


# one definition of the skew threshold, in the ledger that reports skew
from quokka_tpu_torch.obs.opstats import skew_ratio_threshold  # noqa: E402,F401
