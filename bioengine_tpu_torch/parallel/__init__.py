from bioengine_tpu_torch.parallel.mesh import MeshSpec, VirtualMeshSpec, make_mesh
from bioengine_tpu_torch.parallel.tensor_parallel import (
    CONV_TP_RULES,
    VIT_TP_RULES,
    make_tp_apply,
    shard_params,
    tp_param_specs,
)

__all__ = [
    "MeshSpec",
    "VirtualMeshSpec",
    "make_mesh",
    "CONV_TP_RULES",
    "VIT_TP_RULES",
    "make_tp_apply",
    "shard_params",
    "tp_param_specs",
]
