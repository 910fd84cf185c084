"""Device meshes (the port of ``repro.launch.mesh``): torch.distributed
``DeviceMesh``es with the reference's axis names, built by functions, so
that importing this module touches no process group.

The reference's TPU v5e constants (peak flops, HBM and ICI rates) have no
place here: the card's figures are the roofline's
(:data:`CARD`, from :mod:`repro_torch.launch.roofline`).
"""

from __future__ import annotations

from typing import Dict

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.spmv.autotune import device_spec
from repro_torch.launch.roofline import DEFAULT_PLATFORM

#: the card's figures (HBM rate, f32 rate, shared memory a block)
CARD = device_spec(DEFAULT_PLATFORM)

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the ranks of the
    initialised default process group; raises ``ValueError`` unless the
    world has exactly the ranks the mesh needs (256 or 512)."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"mesh {shape} needs a world of {need} ranks; this "
                         f"one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The 1 x 1 ``("data", "model")`` mesh of this one rank (the
    reference's one-device mesh for smoke paths), on the card unless
    another device type is named.  Without a process group it starts a
    1-rank one from an in-process store (NCCL on the card, gloo on the
    CPU), which the caller destroys with
    ``torch.distributed.destroy_process_group()``; an initialised group
    must have one rank."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"the local mesh is one rank; the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=SINGLE_POD[1])


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """Each named mesh dim's size."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
