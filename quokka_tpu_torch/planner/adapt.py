"""Mid-query skew re-partitioning (port of ``quokka_tpu/planner/adapt.py``).

When the engine sees one channel of an eligible join-build exchange receive
``QK_SKEW_RATIO`` times the mean row volume, it rewrites the exchange's
routing; no executor state moves:

- **build edge ("salt" mode)**: batches from sequence ``from_seq`` on have
  the fat channel's rows re-dealt round-robin by row position across all
  build channels.  Earlier sequences already shipped under plain hashing
  and keep their placement; every build row lands on exactly one channel.
- **probe edge ("replicate" mode)**: each probe channel receives its own
  hash partition plus a copy of the fat partition.  Stage gating keeps the
  probe stream unread until the build side is done, so replication applies
  from sequence 0.

An inner join then still matches each pair once: a build row of a non-fat
key sits on its hash channel, met there by that key's probe rows; a fat-key
build row sits on one channel, and the fat probe partition visits every
channel.  Non-inner joins are not eligible (``decide.py``).

The routing programs are kernel K26 (``ops/kernels.adapt_split``): the hash,
the salt or the replication, the masks and the counts in one launch.  The
record of an adaptation is written to the ADT table before the first salted
batch ships.  ``QK_ADAPT=0`` disables eligibility and trigger both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.ops import kernels
from quokka_tpu_torch.ops.batch import DeviceBatch, key_limbs

# ---------------------------------------------------------------------------
# routing (K26; no host syncs on the push path)
# ---------------------------------------------------------------------------


def salt_pids(pids: torch.Tensor, fat: int, n_parts: int) -> torch.Tensor:
    """Partition ids with the fat partition's rows re-dealt across all
    ``n_parts`` channels by row position (``arange(n) % n_parts``)."""
    out, _, _ = kernels.adapt_split([], pids, None, n_parts, int(fat), "salt", masks=False)
    return out


def replicate_parts(batch: DeviceBatch, pids: torch.Tensor, fat: int,
                    n_parts: int) -> List[DeviceBatch]:
    """Per-channel probe parts: channel c's hash partition plus a copy of
    the fat partition, as masked views over the source batch."""
    _, masks, counts = kernels.adapt_split([], pids, batch.valid, n_parts, int(fat),
                                           "replicate")
    return kernels.masked_parts(batch, masks, counts)


def salt_split(batch: DeviceBatch, keys: Sequence[str], fat: int,
               n_parts: int) -> List[DeviceBatch]:
    """A build batch's hash split with the fat partition salted: one K26
    launch hashes, salts and writes the masks; a compacted split (as
    ``kernels.compact_choice`` decides) plans from the salted ids (K17)."""
    limbs = key_limbs(batch, keys)
    if kernels.compact_choice(batch, n_parts):
        pids, _, _ = kernels.adapt_split(limbs, None, batch.valid, n_parts, int(fat), "salt",
                                         masks=False)
        return kernels.compacted_parts(batch, pids, n_parts)
    _, masks, counts = kernels.adapt_split(limbs, None, batch.valid, n_parts, int(fat), "salt")
    return kernels.masked_parts(batch, masks, counts)


def replicate_split(batch: DeviceBatch, keys: Sequence[str], fat: int,
                    n_parts: int) -> List[DeviceBatch]:
    """A probe batch's hash split with the fat partition replicated to every
    channel, in one K26 launch."""
    _, masks, counts = kernels.adapt_split(key_limbs(batch, keys), None, batch.valid,
                                           n_parts, int(fat), "replicate")
    return kernels.masked_parts(batch, masks, counts)


# ---------------------------------------------------------------------------
# trigger predicate (host)
# ---------------------------------------------------------------------------


def skewed_channel(hist: Dict[int, int], n_channels: int,
                   ratio: float) -> Optional[int]:
    """The channel whose delivered rows reach ``ratio`` x the mean across
    all ``n_channels`` (absent channels count zero), or None.  Nothing
    fires below ``config.adapt_min_rows()`` rows in all."""
    if n_channels < 2 or not hist:
        return None
    total = sum(hist.values())
    if total < config.adapt_min_rows():
        return None
    mean = total / n_channels
    if mean <= 0:
        return None
    fat, rows = max(hist.items(), key=lambda kv: kv[1])
    if rows / mean >= ratio:
        return int(fat)
    return None


def build_records(fat: int, build_channels: Dict[int, int]) -> Tuple[dict, dict]:
    """The (build, probe) ADT records of one fired adaptation.
    ``build_channels`` maps the build source's channel to the next sequence
    it will push (sequences already shipped keep their routing)."""
    return (
        {"mode": "salt", "fat": int(fat),
         "from_seq": {int(c): int(s) for c, s in build_channels.items()}},
        {"mode": "replicate", "fat": int(fat), "from_seq": {}},
    )
