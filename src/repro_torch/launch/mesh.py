"""Device meshes (port of ``repro.launch.mesh``): the production meshes,
single pod 16x16 = 256 devices and multi-pod 2x16x16 = 512, and small
test meshes, as ``DeviceMesh``es with the reference's axis names.

FUNCTIONS, not module constants: importing this module starts no process
group. Each builds its mesh over the process group already started: the
production meshes exist only under the ``fake`` backend at world size 256
or 512 (``launch/dryrun.py``), the test meshes over a gloo group of
CPU processes or an NCCL group on the cards.
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(model: int = 2, data: int = 2, pod: int = 0,
                   device_type="cpu"):
    """Small mesh for sharding tests; the world size must be its size."""
    if pod:
        return init_device_mesh(device_type, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
