"""Pipeline parallelism over the "pod" axis, GPipe's schedule (port of
``repro/distributed/pipeline.py``).

The layer stack is cut into ``n_stages`` contiguous stages, one per rank
of the "pod" axis, and ``n_micro`` microbatches stream through them.  At
tick t the rank of stage p runs microbatch t - p through its stage and
passes its activation one hop on (``batch_isend_irecv`` to the next stage,
from the previous one: the ring the reference's ``ppermute`` rotates), so
the one hop is the only traffic between stages.  Stage 0 reads the input
stream; the last stage keeps the finished microbatches, and an all-reduce
over the axis of its outputs and everyone else's zeros (the reference's
masked psum) gives every rank the result.  Bubble fraction:
(S - 1) / (M + S - 1).

A rank computes only where its microbatch is real (the reference computes
in the bubble too and discards it), which changes no number.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..tree import map_like
from .sharding import all_reduce, axis_coord, axis_size, require_process_group


@dataclass(frozen=True)
class PipelineSchedule:
    n_stages: int
    n_micro: int
    axis: str = "pod"

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / (self.n_micro + self.n_stages - 1)


def _neighbour(mesh, axis: str, step: int) -> int:
    """The global rank ``step`` hops along ``axis`` from this rank (a ring)."""
    coord = list(mesh.get_coordinate())
    d = mesh.mesh_dim_names.index(axis)
    coord[d] = (coord[d] + step) % mesh.size(d)
    return int(mesh.mesh[tuple(coord)])


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, sched: PipelineSchedule,
                   mesh) -> torch.Tensor:
    """Run microbatches through the pipeline's stages.

    stage_fn(params, x) -> x        one stage's computation (shape-preserving)
    stage_params: this rank's stage, every leaf with a leading stage axis
        of 1 (its block of the (n_stages, ...) stack sharded over the
        axis) or of n_stages (the whole stack: the rank takes its row)
    x_micro: (n_micro, mb, ...), the same on every rank

    Returns (n_micro, mb, ...) outputs, the same on every rank.  Total
    ticks: n_micro + n_stages - 1."""
    require_process_group()
    S, M, axis = sched.n_stages, sched.n_micro, sched.axis
    if axis_size(mesh, axis) != S:
        raise ValueError(f"{S} stages over a {axis!r} axis of {axis_size(mesh, axis)} ranks")
    p = axis_coord(mesh, axis)
    params = map_like(lambda t: t[0] if t.shape[0] == 1 else t[p], stage_params)
    nxt, prev = _neighbour(mesh, axis, 1), _neighbour(mesh, axis, -1)
    carry = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(M + S - 1):
        mb = t - p                                   # this stage's microbatch
        y = carry
        if 0 <= mb < M:
            y = stage_fn(params, x_micro[mb] if p == 0 else carry)
            if p == S - 1:
                outs[mb] = y
        if S > 1:                                    # rotate one hop forward
            y = y.contiguous()
            carry = torch.empty_like(y)
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt),
                                               dist.P2POp(dist.irecv, carry, prev)]):
                req.wait()
    # only the last stage holds real outputs: broadcast them over the axis
    if p != S - 1:
        outs.zero_()
    return all_reduce(outs, (axis,), mesh)
