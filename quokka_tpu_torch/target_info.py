"""Per-edge routing spec (port of ``quokka_tpu/target_info.py``: the
PassThrough, Broadcast and Hash partitioners).

A TargetInfo hangs on every plan edge; the engine lowers it to a device
partition function.  The reference's per-edge predicate, projection and
batch functions come with the optimizer passes that fold them in
(``fold_maps``), which the port does not carry.
"""

from __future__ import annotations

import dataclasses
from typing import List


class Partitioner:
    pass


@dataclasses.dataclass
class PassThroughPartitioner(Partitioner):
    """Source channel i feeds target channel i % n."""


@dataclasses.dataclass
class BroadcastPartitioner(Partitioner):
    """Every batch goes to every target channel."""


@dataclasses.dataclass
class HashPartitioner(Partitioner):
    keys: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TargetInfo:
    partitioner: Partitioner
