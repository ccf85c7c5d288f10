"""Cluster state over the CUDA topology: chip leases, replicas, pending
workloads."""

from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import TpuTopology, detect_topology

__all__ = ["ClusterState", "TpuTopology", "detect_topology"]
