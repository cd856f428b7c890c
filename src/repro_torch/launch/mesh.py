"""Production mesh construction (the twin of ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches
no process group. Each mesh is a ``DeviceMesh`` over the process group
that stands, whose world size must be the mesh's size (the dry run
stands a ``fake``-backend world of it in one process).
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Single-device mesh (a world of one) for smoke tests and
    examples."""
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
