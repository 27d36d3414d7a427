"""The mesh plane of the PyTorch port (``quokka_tpu/parallel/``): a query's
channels as the shards of a mesh, on one card."""

from quokka_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    collective_hash_shuffle,
    distributed_groupby_step,
    distributed_join_groupby_step,
    make_mesh,
)
