"""The parallel layer: the cells mesh over ``torch.distributed`` ranks, the
distributed merge step and PCA, ring collectives, the distributed fastMNN
driver and multi-host start-up. Counterpart of ``batchelor_tpu/parallel/``,
one process per device (NCCL on the card, gloo on the CPU) where the JAX
package runs one controller over a device mesh."""

from .mesh import (
    make_cells_mesh,
    cells_sharding,
    replicated_sharding,
    pad_to_multiple,
)
from .distributed import (
    DistributedMergeOutput,
    distributed_merge_step,
    distributed_multi_batch_pca,
)
from .driver import distributed_fast_mnn
from .multihost import initialize_multihost, make_multihost_cells_mesh
from .ring import (
    ring_query_knn_local,
    ring_membership,
    ring_segment_reduce,
    ring_weighted_gather,
)

__all__ = [
    "make_cells_mesh",
    "cells_sharding",
    "replicated_sharding",
    "pad_to_multiple",
    "DistributedMergeOutput",
    "distributed_merge_step",
    "distributed_multi_batch_pca",
    "distributed_fast_mnn",
    "initialize_multihost",
    "make_multihost_cells_mesh",
    "ring_query_knn_local",
    "ring_membership",
    "ring_segment_reduce",
    "ring_weighted_gather",
]
