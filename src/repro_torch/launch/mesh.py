"""Device meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, built over
the default process group, which the caller initialises first
(``torch.distributed.init_process_group`` with its store, world size and
rank: NCCL on the card, gloo on the CPU). Each rank of the group is one
device of the mesh. Meshes are on the card unless ``device_type="cpu"``
is asked for; without a card a CUDA mesh raises, as every entry point
does. The 256-chip production layout belongs to the language model and
is not ported.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["make_mesh_compat", "make_dp_mesh", "dp_axes"]


def make_mesh_compat(shape, axes, device_type: str = None):
    """DeviceMesh of ``shape`` with dims named ``axes`` over the default
    process group (whose world size must be the product of ``shape``),
    on ``device_type`` (``cuda`` by default)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "torch.distributed.init_process_group (nccl on the card, gloo "
            "on the CPU) with its store, world size and rank first")
    dev = resolve_device(device_type).type
    return init_device_mesh(dev, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_dp_mesh(n_devices: int = None, device_type: str = None):
    """Pure data-parallel mesh: one dim ``data`` over ``n_devices`` ranks
    (the whole default group by default)."""
    n = n_devices or dist.get_world_size()
    return make_mesh_compat((n,), ("data",), device_type)


def dp_axes(mesh) -> tuple:
    """The mesh's data-parallel dims, of ``("pod", "data")``."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)
