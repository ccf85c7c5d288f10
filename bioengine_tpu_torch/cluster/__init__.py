from bioengine_tpu_torch.cluster.cluster import TpuCluster
from bioengine_tpu_torch.cluster.state import ClusterState
from bioengine_tpu_torch.cluster.topology import TpuTopology, detect_topology

__all__ = ["TpuCluster", "ClusterState", "TpuTopology", "detect_topology"]
