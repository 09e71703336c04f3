"""Collectives over one named dim of a ``DeviceMesh``.

They stand where the reference's ``shard_map`` (``repro/parallel/
sharding.py:30``) and its collectives stand: ``axis_group`` resolves
``(mesh, axis)`` to the process group, this rank's index along the dim
(``axis_index``) and the dim's size; ``all_gather_stack`` is
``all_gather`` along a new leading axis and ``all_reduce_sum`` is
``psum``. Every rank of the dim must call them in the same order with
tensors of equal shape. A mesh whose device type is not the tensors'
raises: nothing is copied between devices quietly.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["axis_group", "all_gather_stack", "all_reduce_sum"]


def axis_group(mesh, axis: str, like: torch.Tensor = None) -> tuple:
    """(group, rank, world) of ``mesh``'s dim ``axis``. ``like``: a tensor
    (or device) that the collectives will carry, whose device type must
    be the mesh's."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no dim {axis!r} (dims {names})")
    if like is not None:
        dev = like.device if isinstance(like, torch.Tensor) \
            else torch.device(like)
        if dev.type != mesh.device_type:
            raise ValueError(f"tensors on {dev} but the mesh is on "
                             f"{mesh.device_type!r}")
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def all_gather_stack(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked in rank order:
    [world, *x.shape]."""
    group, _, world = axis_group(mesh, axis, x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` over the dim, on a new tensor."""
    group, _, _ = axis_group(mesh, axis, x)
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
