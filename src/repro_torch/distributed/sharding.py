"""Sharding over ``torch.distributed``: the reference's GSPMD annotations
made explicit.

A leaf's spec (``models.model.spec_tree``) is a tuple with one entry per
tensor dimension: None, a mesh axis name, or a tuple of names.  On a
``DeviceMesh`` each rank stores the block of every leaf that its
coordinates select: dimension ``i`` is cut into as many equal blocks as
the product of the sizes of its axes, and the rank takes the block of its
coordinate on those axes (row-major over them, as a ``PartitionSpec``
lays a tuple of axes out).  A mesh axis that no dimension names
replicates the leaf.  Dimensions must divide evenly: a spec that would
need padding raises.

The collectives are the ones gloo (CPU tensors, the tests) and NCCL (the
card) both take: ``all_gather_into_tensor``, ``reduce_scatter_tensor``
(``all_gather_single`` and ``reduce_scatter_single`` where PyTorch has
those names) and ``all_reduce`` over the mesh's per-axis groups, each on
contiguous tensors cut along their first dimension.  A call with no process group
raises; nothing here falls back to one rank.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def require_process_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call "
                           "torch.distributed.init_process_group first (the mesh runs "
                           "over the ranks that exist, never quietly on one)")


def axes_of(entry) -> tuple:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_coord(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def placements(spec: tuple, mesh) -> tuple:
    """The leaf's placement on each mesh axis: ``Shard(dim)`` on an axis
    that a dimension names, ``Replicate()`` on the others (a
    ``DTensor``'s placements; a dimension split over two axes is a
    ``Shard`` on each)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if name in axes_of(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_slices(shape, spec: tuple, mesh, axes=None) -> tuple:
    """The slices of a full leaf of ``shape`` that this rank stores;
    with ``axes``, only those mesh axes cut (the others are gathered)."""
    out = []
    for i, n in enumerate(shape):
        names = [a for a in axes_of(spec[i] if i < len(spec) else None)
                 if a in mesh.mesh_dim_names and (axes is None or a in axes)]
        parts = math.prod(axis_size(mesh, a) for a in names)
        if n % parts:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not divide into {parts} "
                             f"shards over {names}")
        block, idx = n // parts, 0
        for a in names:                      # row-major over the dimension's axes
            idx = idx * axis_size(mesh, a) + axis_coord(mesh, a)
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


def shard(full: torch.Tensor, spec: tuple, mesh, axes=None) -> torch.Tensor:
    """This rank's block of ``full`` (a copy)."""
    return full[shard_slices(full.shape, spec, mesh, axes)].clone()


def _dim_axes(spec: tuple, mesh, axes) -> list[tuple[int, str]]:
    """(dimension, axis) pairs of the spec that cut a dimension, in layout
    order (a dimension's axes outermost first)."""
    return [(i, a) for i, e in enumerate(spec) for a in axes_of(e)
            if a in mesh.mesh_dim_names and (axes is None or a in axes)]


def gather(local: torch.Tensor, spec: tuple, mesh, axes=None) -> torch.Tensor:
    """The full leaf from each rank's block: all-gathers over every axis
    that cuts a dimension (with ``axes``, only over those), the innermost
    axis of a dimension first."""
    for dim, axis in reversed(_dim_axes(spec, mesh, axes)):
        local = _all_gather(local, dim, mesh.get_group(axis), axis_size(mesh, axis))
    return local


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    # all_gather_single is the newer name of all_gather_into_tensor
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(grad: torch.Tensor, spec: tuple, mesh, sum_axes, axes=None) -> torch.Tensor:
    """A full leaf's gradient summed over the mesh axes ``sum_axes`` (the
    data axes that split the batch) and cut to this rank's block: a
    reduce-scatter over each summed axis that cuts a dimension, an
    all-reduce over each that does not, and a plain slice on the other
    cutting axes (whose ranks hold the same gradient)."""
    cut = _dim_axes(spec, mesh, axes)
    for dim, axis in cut:
        if axis in sum_axes:
            grad = _reduce_scatter(grad, dim, mesh.get_group(axis), axis_size(mesh, axis))
    for axis in sum_axes:
        if axis not in [a for _, a in cut]:
            grad = all_reduce(grad, (axis,), mesh)
    rest = [a for _, a in cut if a not in sum_axes]
    if rest:
        grad = grad[shard_slices(grad.shape, spec, mesh, axes=rest)].contiguous()
    return grad


def all_reduce(t: torch.Tensor, axes, mesh, op=None) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) over the mesh axes ``axes``, in
    place on a contiguous tensor, which is returned."""
    t = t.contiguous()
    for a in axes:
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=mesh.get_group(a))
    return t


class CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient all-reduced (summed) over ``axis``:
    the entry of a body whose ranks each take part of the work on the same
    input (expert parallelism), so each holds part of its gradient."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), (ctx.axis,), ctx.mesh), None, None


class SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward: the exit of such a
    body, whose sum every rank then uses alike."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.clone(), (axis,), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None
