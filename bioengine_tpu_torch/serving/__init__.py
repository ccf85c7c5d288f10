from bioengine_tpu_torch.serving.batching import ContinuousBatcher
from bioengine_tpu_torch.serving.controller import (
    DeploymentHandle,
    DeploymentSpec,
    RequestOptions,
    ServeController,
)
from bioengine_tpu_torch.serving.errors import (
    AdmissionRejectedError,
    ApplicationError,
    DeadlineExceeded,
    NoHealthyReplicasError,
    ReplicaUnavailableError,
    RetryableTransportError,
    RouterClosedError,
    RouterSaturatedError,
    StaleEpochError,
    StaleTableError,
)
from bioengine_tpu_torch.serving.router import (
    RouterCore,
    RoutingTablePublisher,
    StandaloneRouter,
    remote_replica_resolver,
    shared_object_resolver,
)
from bioengine_tpu_torch.serving.journal import ControlJournal, JournalState
from bioengine_tpu_torch.serving.mesh_plan import (
    MeshConfig,
    MeshPlan,
    MeshPlanError,
    plan_mesh,
)
from bioengine_tpu_torch.serving.mesh_replica import CrossHostEngine, MeshReplica
from bioengine_tpu_torch.serving.outlier import (
    DeploymentLatencyTracker,
    OutlierConfig,
)
from bioengine_tpu_torch.serving.replica import Replica, ReplicaState
from bioengine_tpu_torch.serving.scheduler import (
    DeploymentScheduler,
    HeuristicCostModel,
    LoadPredictor,
    SchedulingConfig,
)
from bioengine_tpu_torch.serving.slo import SLOConfig, SLOEngine
from bioengine_tpu_torch.serving.compile_tier import CompileCacheTier
from bioengine_tpu_torch.serving.warm_pool import WarmPool, WarmPoolConfig

__all__ = [
    "AdmissionRejectedError",
    "ApplicationError",
    "ContinuousBatcher",
    "ControlJournal",
    "CrossHostEngine",
    "DeadlineExceeded",
    "DeploymentHandle",
    "DeploymentLatencyTracker",
    "DeploymentScheduler",
    "DeploymentSpec",
    "HeuristicCostModel",
    "JournalState",
    "LoadPredictor",
    "MeshConfig",
    "MeshPlan",
    "MeshPlanError",
    "MeshReplica",
    "plan_mesh",
    "NoHealthyReplicasError",
    "OutlierConfig",
    "Replica",
    "ReplicaState",
    "ReplicaUnavailableError",
    "RequestOptions",
    "RetryableTransportError",
    "RouterClosedError",
    "RouterCore",
    "RouterSaturatedError",
    "RoutingTablePublisher",
    "SchedulingConfig",
    "SLOConfig",
    "StaleEpochError",
    "StaleTableError",
    "SLOEngine",
    "ServeController",
    "StandaloneRouter",
    "remote_replica_resolver",
    "shared_object_resolver",
    "CompileCacheTier",
    "WarmPool",
    "WarmPoolConfig",
]
