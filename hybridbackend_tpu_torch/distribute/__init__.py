"""Collectives and id partitioning across the ranks of a world."""

from hybridbackend_tpu_torch.distribute.collective import (
    Topology, all_to_all_v, allgather, allreduce, alltoall, broadcast,
    reduce_scatter)
from hybridbackend_tpu_torch.distribute.partition import (
    Partitioned, partition_by_dual_modulo, partition_by_fn,
    partition_by_modulo, unpartition)
