from bioengine_tpu_torch.parallel.mesh import MeshSpec, VirtualMeshSpec, make_mesh

__all__ = [
    "MeshSpec",
    "VirtualMeshSpec",
    "make_mesh",
]
