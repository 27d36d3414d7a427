"""Vector dataset indexing (port of ``quokka_tpu/dataset/vector.py``): an
IVF sidecar beside a Parquet file and ANN row-group pruning.

``build_vector_index`` k-means the vectors (cosine assignment as one
``[n, d] @ [d, cells]`` product per Lloyd iteration, torch on the context's
device; the centroid update on the host) and records which cells each row
group holds.  An indexed source prunes its row groups to those owning the
queries' ``nprobe`` closest cells.  The sidecar is the reference's ``.npz``
(``centroids``, ``rg_cells``, ``vec_col``), so a sidecar written by either
package is read by the other.  Approximate by nature: the optimizer applies
it only to ``nearest_neighbors(..., approximate=True)``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from quokka_tpu_torch import config


def sidecar_path(parquet_path: str) -> str:
    return parquet_path + ".ivf.npz"


def build_vector_index(parquet_path: str, vec_col: str, n_cells: int = 32, iters: int = 8,
                       seed: int = 0, device=None) -> str:
    """K-means the vectors of ``vec_col`` and write the sidecar; returns its
    path.  ``device=None`` runs the assignment on the card."""
    import pyarrow.parquet as pq

    dev = config.resolve_device(device)
    pf = pq.ParquetFile(parquet_path)
    mats = []
    for rg in range(pf.metadata.num_row_groups):
        arr = pf.read_row_group(rg, columns=[vec_col]).column(vec_col).combine_chunks()
        dim = arr.type.list_size
        mats.append(np.asarray(arr.flatten().to_numpy(zero_copy_only=False),
                               dtype=np.float32).reshape(-1, dim))
    all_vecs = np.concatenate(mats)
    n = len(all_vecs)
    n_cells = min(n_cells, n)
    r = np.random.default_rng(seed)
    cents = all_vecs[r.choice(n, n_cells, replace=False)].copy()
    x = torch.from_numpy(all_vecs).to(dev)
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-9)
    for _ in range(iters):
        c = torch.from_numpy(cents).to(dev)
        cn = c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True), min=1e-9)
        a = torch.argmax(xn @ cn.T, dim=1).cpu().numpy()  # cosine assignment
        for j in range(n_cells):
            sel = all_vecs[a == j]
            if len(sel):
                cents[j] = sel.mean(axis=0)
    rg_cells = np.zeros((len(mats), n_cells), dtype=bool)
    off = 0
    for i, m in enumerate(mats):
        rg_cells[i, np.unique(a[off:off + len(m)])] = True
        off += len(m)
    out = sidecar_path(parquet_path)
    np.savez(out, centroids=cents, rg_cells=rg_cells, vec_col=np.array([vec_col]))
    return out


def prune_row_groups(parquet_path: str, queries: np.ndarray,
                     nprobe: int) -> Optional[np.ndarray]:
    """Row-group indices that may contain any query's ``nprobe`` closest
    cells, or None when no sidecar index exists."""
    p = sidecar_path(parquet_path)
    if not os.path.exists(p):
        return None
    idx = np.load(p, allow_pickle=False)
    cents = idx["centroids"]
    rg_cells = idx["rg_cells"]
    q = np.asarray(queries, dtype=np.float32)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)
    cn = cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-9)
    sims = qn @ cn.T  # [nq, n_cells]
    nprobe = min(nprobe, sims.shape[1])
    probed = np.unique(np.argpartition(-sims, nprobe - 1, axis=1)[:, :nprobe])
    return np.nonzero(rg_cells[:, probed].any(axis=1))[0]
