"""The mesh plane on one card (PyTorch port of ``quokka_tpu/parallel/mesh.py``).

The reference runs a query's channels as the shards of a jax device mesh:
each device owns N padded rows, a key shuffle is one ``all_to_all`` inside
a ``shard_map`` program, and every shard's program has the same static
shapes.  Its own checks run that mesh on eight virtual CPU devices.  The
port runs the same layout with ``n_shards`` logical shards on one device:

- a shard is a contiguous row range of a global tensor (shard i = rows
  [i N, (i + 1) N), N = padded length / n_shards), the reference's
  ``P(axis)`` row sharding; sharding a batch is a divisibility check;
- ``shard_map`` is a per-shard apply: a Python loop over the shards' row
  ranges calling the port's single-device kernels on each, as
  ``jax.shard_map`` runs its step on each device;
- ``collective_hash_shuffle`` is kernel K24 (``kernels.mesh_bucketize``):
  it hashes the key limbs of every shard and writes each row straight to
  its receiving slot, so the global result already has the reference's
  exchanged layout (destination d: P frames of N rows, frame s from shard
  s) and ``all_to_all`` has nothing left to move;
- ``psum`` is a sum over the shard axis.

A mesh whose shards span several devices is a different exchange (NCCL
collectives around K24) and is refused: ROADMAP Queue 1, "Multi-GPU,
remaining".
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from quokka_tpu_torch import config
from quokka_tpu_torch.ops import kernels


class Mesh:
    """``n_shards`` logical shards of one device along its one axis."""

    def __init__(self, n_shards: int = 8, devices: Optional[Sequence] = None):
        devices = list(devices) if devices else [None]
        if len({str(d) for d in devices}) > 1:
            raise NotImplementedError(
                "a mesh whose shards span several devices needs NCCL collectives around "
                "K24, which quokka_tpu_torch does not carry yet: ROADMAP Queue 1, "
                "\"Multi-GPU, remaining\"")
        if n_shards < 1 or n_shards > kernels.MAX_PARTS:
            raise ValueError(f"a mesh has 1 to {kernels.MAX_PARTS} shards, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = config.resolve_device(devices[0])

    def shard_rows(self, padded_len: int) -> int:
        """Rows of each shard of a global batch of ``padded_len`` rows."""
        if padded_len % self.n_shards:
            raise ValueError(f"{padded_len} rows do not split into {self.n_shards} shards")
        return padded_len // self.n_shards

    def __repr__(self) -> str:
        return f"Mesh({self.n_shards} shards on {self.device})"


def make_mesh(n_shards: int = 8, device=None) -> Mesh:
    """A mesh of ``n_shards`` shards on one device: the card unless the
    caller asks for the CPU, as ``QuokkaContext(device=None)`` resolves."""
    return Mesh(n_shards, [device])


def shard_map(step: Callable, mesh: Mesh) -> Callable:
    """Per-shard apply: ``shard_map(step, mesh)(*arrays)`` calls ``step`` on
    each shard's rows of every array (shard i of an array of P N rows = rows
    [i N, (i + 1) N); arrays may differ in N) and concatenates each of its
    outputs in shard order, the layout of the reference's
    ``out_specs=P(axis)``.  ``step`` returns a tuple of 1-D tensors whose
    lengths may differ from N but not between shards."""

    def run(*arrays: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        rows = [mesh.shard_rows(a.shape[0]) for a in arrays]
        outs: List[Tuple[torch.Tensor, ...]] = []
        for s in range(mesh.n_shards):
            outs.append(tuple(step(*(a[s * n:(s + 1) * n] for a, n in zip(arrays, rows)))))
        return tuple(torch.cat(parts) for parts in zip(*outs))

    return run


def all_to_all(frames: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The exchange of the reference's ``collective_hash_shuffle``.  On a
    one-device mesh K24 already wrote every row to its receiving slot
    (destination-major, then source frame), so there is nothing to move:
    the frames are returned as they are, after a check of that layout."""
    for f in frames:
        if f.shape[0] % (mesh.n_shards * mesh.n_shards):
            raise ValueError(f"a frame of {f.shape[0]} rows is not {mesh.n_shards} x "
                             f"{mesh.n_shards} frames")
    return list(frames)


def collective_hash_shuffle(cols: Sequence[torch.Tensor], valid: torch.Tensor,
                            key_idx: Sequence[int], mesh: Mesh):
    """Redistribute rows so that equal keys land on one shard: per shard N
    rows in, P * N rows out (P frames of N, padding zeroed and invalid).
    K24 then the exchange.  Returns (columns, validity), global."""
    mesh.shard_rows(valid.shape[0])
    outs, out_valid = kernels.mesh_bucketize(list(cols), valid, tuple(key_idx), mesh.n_shards)
    got = all_to_all(outs + [out_valid], mesh)
    return got[:-1], got[-1]


def psum(per_shard: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over the shard axis of one value per shard."""
    return torch.stack(list(per_shard)).sum(0)


def _as_tensor(a, device) -> torch.Tensor:
    return a.to(device) if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=device)


def distributed_groupby_step(mesh: Mesh, key_cols: int, val_ops: Tuple[str, ...]):
    """Distributed group-by-aggregate: a local partial aggregate per shard,
    the key shuffle of the partials (K24), a final aggregate per shard; the
    same sort group-by the engine uses (``kernels.sorted_groupby``).  The
    full-plan version is ``mesh_exec.mesh_groupby``.  The returned function
    takes key columns, value columns and validity (global, ``n_shards`` x N
    rows) and returns group keys, values and validity, per shard."""
    recombine = tuple("sum" if op == "count" else op for op in val_ops)

    def grouped(ops):
        def step(*arrays):
            keys, vals, valid = arrays[:key_cols], arrays[key_cols:-1], arrays[-1]
            n = valid.shape[0]
            outs, _, rep, num = kernels.sorted_groupby(keys, vals, ops, valid)
            rep = rep.long()
            gvalid = torch.arange(n, device=valid.device) < num
            return tuple(k[rep] for k in keys) + tuple(outs) + (gvalid,)
        return step

    def run(*arrays):
        arrays = [_as_tensor(a, mesh.device) for a in arrays]
        g = shard_map(grouped(tuple(val_ops)), mesh)(*arrays)
        shuf, svalid = collective_hash_shuffle(g[:-1], g[-1], tuple(range(key_cols)), mesh)
        return shard_map(grouped(recombine), mesh)(*shuf, svalid)

    return run


def distributed_join_groupby_step(mesh: Mesh):
    """Distributed shuffle-join and sum: two sharded tables key-shuffled
    (K24), PK-joined per shard by ``join._pk_match`` (dense rank, then
    K14), the joined product summed per shard and over the shards.  Full
    relational joins over a mesh run through ``mesh_exec.mesh_join``.
    Returns (sum of l_val * r_val over matches, matched rows)."""
    from quokka_tpu_torch.ops import join as join_ops

    def step(lk, lv, lvalid, rk, rv, rvalid):
        p = lk.shape[0]
        limbs = (torch.cat([lk, rk.to(lk.dtype)]),)
        build_idx, matched = join_ops._pk_match(limbs, torch.cat([lvalid, rvalid]), p)
        prod = torch.where(matched, lv * rv[build_idx.long()], torch.zeros((), dtype=lv.dtype,
                                                                           device=lv.device))
        return prod.sum().reshape(1), matched.sum(dtype=torch.int64).reshape(1)

    def run(l_key, l_val, l_valid, r_key, r_val, r_valid):
        l_key, l_val, l_valid, r_key, r_val, r_valid = (
            _as_tensor(a, mesh.device) for a in (l_key, l_val, l_valid, r_key, r_val, r_valid))
        (lk, lv), lvalid = collective_hash_shuffle((l_key, l_val), l_valid, (0,), mesh)
        (rk, rv), rvalid = collective_hash_shuffle((r_key, r_val), r_valid, (0,), mesh)
        totals, rows = shard_map(step, mesh)(lk, lv, lvalid, rk, rv, rvalid)
        return psum(totals), psum(rows)

    return run
