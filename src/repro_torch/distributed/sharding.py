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

The collectives are the ones gloo (CPU tensors, the tests), NCCL (the
card) and the threaded group both take: ``all_gather_into_tensor``,
``reduce_scatter_tensor`` (``all_gather_single`` and
``reduce_scatter_single`` where PyTorch has those names), ``all_reduce``
and ``all_to_all_single`` over the mesh's per-axis groups, each on
contiguous tensors cut along their first dimension; no point-to-point
send or receive.  A call with no process group
raises; nothing here falls back to one rank.  An axis of one rank moves
nothing: its gather, reduce-scatter and all-reduce return their input.

A partitioned step (``Partition``) runs each layer on this rank's blocks:
``GatherOnUse`` all-gathers a leaf over the data axes (and over "model"
where the layer uses it whole) just before the layer and reduce-scatters
its gradient back to the shard, and ``SeqGather`` / ``SeqScatter`` move
the activations between their sequence shards on "model" and the whole
sequence around a tensor-parallel product, each pair the adjoint of the
other under autograd.  The recurrent blocks (``models/ssm.py``,
``models/xlstm.py``) add two: ``ChannelTake`` brings a column-cut leaf of
k equal parts (mamba's ``w_in``, the mLSTM's ``w_up``, the sLSTM's
``w_x`` and ``w_ff_up``) from the stored "model" block of its
concatenated columns to the rank's channel block of every part, by one
all-to-all (its gradient by the reverse one); ``Partition.feature_gather``
all-gathers a rank's feature block over "model" on the last dimension,
its gradient reduce-scattered back (``SeqGather`` on that dimension).
So each rank holds 1/tp of every recurrent leaf the specs cut over
"model", in a train step, a prefill and a decode step alike, and only
the leaves the specs leave uncut (``w_bc``, ``w_if``, the biases) and
the sLSTM's small ``w_h`` whole.  ``embed`` and the head stay cut over the vocabulary
on "model": a lookup reads zeros outside the rank's rows before its
reduction, and ``VocabParallelNLL`` is the cross entropy over the ranks'
columns of the logits.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, replace

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


@functools.lru_cache(maxsize=4096)
def _cuts(spec: tuple, mesh, axes: tuple) -> bool:
    """Whether an axis of ``axes`` cuts a dimension of ``spec``."""
    return bool(_dim_axes(spec, mesh, axes))


def gather(local: torch.Tensor, spec: tuple, mesh, axes=None) -> torch.Tensor:
    """The full leaf from each rank's block: all-gathers over every axis
    that cuts a dimension (with ``axes``, only over those), the innermost
    axis of a dimension first."""
    for dim, axis in reversed(_dim_axes(spec, mesh, axes)):
        n = axis_size(mesh, axis)
        if n > 1:
            local = _all_gather(local, dim, mesh.get_group(axis), n)
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
        if axis in sum_axes and axis_size(mesh, axis) > 1:
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
        if axis_size(mesh, a) > 1:
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


class GatherOnUse(torch.autograd.Function):
    """``gather`` forward (the leaf whole over ``axes``, from this rank's
    block); ``reduce_scatter`` backward: the gradient summed over
    ``sum_axes`` (the ranks that computed different parts of it) and cut
    back to this rank's block, so it arrives as the shard's gradient."""

    @staticmethod
    def forward(ctx, local, spec, mesh, axes, sum_axes):
        ctx.spec, ctx.mesh, ctx.axes, ctx.sum_axes = spec, mesh, axes, sum_axes
        out = gather(local, spec, mesh, axes)
        return out.view_as(out) if out is local else out

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.spec, ctx.mesh, ctx.sum_axes, ctx.axes), None, None, None, None


class SeqGather(torch.autograd.Function):
    """All-gather of the shards along ``dim`` over ``axis`` forward;
    reduce-scatter (summed) backward: the entry of a tensor-parallel
    product whose ranks each hold part of its input's gradient (the
    sequence's shards, or a recurrent block's feature blocks on the last
    dimension)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(t, dim, mesh.get_group(axis), axis_size(mesh, axis))

    @staticmethod
    def backward(ctx, g):
        n = axis_size(ctx.mesh, ctx.axis)
        return _reduce_scatter(g, ctx.dim, ctx.mesh.get_group(ctx.axis), n), None, None, None


class SeqScatter(torch.autograd.Function):
    """Reduce-scatter (summed) along ``dim`` over ``axis`` forward;
    all-gather backward: the exit of a row-parallel product, whose ranks
    each hold a partial sum of the whole sequence."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(t, dim, mesh.get_group(axis), axis_size(mesh, axis))

    @staticmethod
    def backward(ctx, g):
        n = axis_size(ctx.mesh, ctx.axis)
        return _all_gather(g, ctx.dim, ctx.mesh.get_group(ctx.axis), n), None, None, None


def channel_plan(k: int, tp: int, rank: int) -> tuple[list, list, list]:
    """The exchange of ``ChannelTake`` on rank ``rank`` of ``tp``: a leaf of
    ``k`` equal parts, each of C columns, cut into ``k * tp`` blocks of C /
    tp columns; rank s stores blocks [s k, (s + 1) k) (its "model" block
    of the concatenated columns) and needs block j tp + r of every part j.
    Returns (the rank's stored blocks in sending order: by destination,
    then by position; blocks sent to each rank; blocks received from
    each), the sizes in blocks."""
    mine = range(rank * k, (rank + 1) * k)
    order = [b - rank * k for b in sorted(mine, key=lambda b: (b % tp, b))]
    send = [sum(b % tp == r for b in mine) for r in range(tp)]
    recv = [sum(b % tp == rank for b in range(s * k, (s + 1) * k)) for s in range(tp)]
    return order, send, recv


def _all_to_all(blocks: torch.Tensor, send: list, recv: list, group) -> torch.Tensor:
    """``blocks`` (n, ...) sent ``send[r]`` leading rows to rank r in turn;
    the rows received, ``recv[s]`` from rank s in turn."""
    out = blocks.new_empty((sum(recv),) + tuple(blocks.shape[1:]))
    dist.all_to_all_single(out, blocks.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


class ChannelTake(torch.autograd.Function):
    """A leaf whose columns are ``k`` equal parts (mamba's ``w_in`` [u|z],
    the mLSTM's ``w_up`` [x|z], the sLSTM's ``w_x`` [z|i|f|o] and
    ``w_ff_up`` [a|b]), stored as its (rows, k C / tp) block of the
    concatenated columns, taken as this rank's channel block of every
    part, (rows, k C / tp): one all-to-all over ``axis`` forward
    (``channel_plan``; at tp = 2 and k = 2 rank 0 stores u and sends z's
    first half), the reverse exchange backward, so the gradient arrives
    as the stored block's."""

    @staticmethod
    def forward(ctx, local, k, mesh, axis):
        tp = axis_size(mesh, axis)
        order, send, recv = channel_plan(k, tp, axis_coord(mesh, axis))
        ctx.k, ctx.group, ctx.plan = k, mesh.get_group(axis), (order, send, recv)
        blocks = local.unflatten(-1, (k, local.shape[-1] // k)).movedim(-2, 0)[order]
        return _all_to_all(blocks, send, recv, ctx.group).movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        order, send, recv = ctx.plan
        k = ctx.k
        got = _all_to_all(g.unflatten(-1, (k, g.shape[-1] // k)).movedim(-2, 0), recv, send,
                          ctx.group)
        back = torch.empty_like(got)
        back[order] = got
        return back.movedim(0, -2).flatten(-2), None, None, None


class VocabParallelNLL(torch.autograd.Function):
    """The cross entropy of logits whose vocabulary is cut over ``axis``:
    ``logits`` (T, Vl) f32 are this rank's columns [lo, lo + Vl) and
    ``labels`` (T,) int64 whole-vocabulary ids (a masked label, < 0, gives
    the logsumexp alone; the caller masks the term).  Forward: the max over
    the vocabulary (all-reduce MAX), the sum of exp (all-reduce), the
    label's logit, which only the rank that holds it contributes
    (all-reduce); every rank returns the same (T,) terms.  Backward:
    softmax - one-hot on the rank's columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo, mesh, axis):
        import torch.distributed as d
        Vl = logits.shape[-1]
        m = all_reduce(logits.amax(dim=-1), (axis,), mesh, op=d.ReduceOp.MAX)
        lse = m + torch.log(all_reduce(torch.exp(logits - m[:, None]).sum(dim=-1), (axis,), mesh))
        local = labels - lo
        mine = (local >= 0) & (local < Vl)
        local = local.clamp(0, Vl - 1)
        ll = torch.where(mine, logits.gather(-1, local[:, None])[:, 0], torch.zeros_like(lse))
        ctx.save_for_backward(logits, lse, local, mine)
        return lse - all_reduce(ll, (axis,), mesh)

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse[:, None])
        grad.scatter_add_(-1, local[:, None], -mine.to(grad.dtype)[:, None])
        return grad * g[:, None], None, None, None, None


TP = "model"        # the tensor-parallel mesh axis


@dataclass(frozen=True)
class Partition:
    """How one rank of a meshed step runs a layer: the mesh, its data axes
    (every axis but "model"), whether the batch is split over them
    (``split``; a batch too small to split stays whole), and whether the
    activations between blocks are split over the sequence on "model"
    (``seq``, the reference's ``shard_act(seq_dim=1)``); ``specs`` are the
    params' specs (``models.model.spec_tree``).

    A block's compute is one of two kinds.  Tensor-parallel: the rank
    computes its heads or its MLP columns (``tp_enter`` gathers the
    sequence, or marks a whole input whose gradient the ranks sum) and
    ends on a row-parallel product whose partial sums ``tp_exit``
    reduce-scatters over the sequence, or all-reduces.  Replicated: every
    "model" rank computes the whole block on the whole sequence
    (``rep_enter``) and keeps its own shard of the result
    (``rep_exit``)."""

    mesh: object
    data: tuple
    split: bool
    seq: bool = False
    specs: dict | None = field(default=None, compare=False)   # the params' spec tree
    # the mesh's axis sizes, its "model" size (tp) and this rank's
    # coordinate there (rank), read once: a decode step asks per leaf
    sizes: dict = field(init=False, compare=False)
    tp: int = field(init=False, compare=False)
    rank: int = field(init=False, compare=False)

    def __post_init__(self):
        names = self.mesh.mesh_dim_names
        object.__setattr__(self, "sizes", {a: axis_size(self.mesh, a) for a in names})
        object.__setattr__(self, "tp", self.sizes.get(TP, 1))
        object.__setattr__(self, "rank", axis_coord(self.mesh, TP) if TP in names else 0)
        # take's (gather axes, sum axes) by (whole, sum_model): axes of one
        # rank move nothing and are left out
        object.__setattr__(self, "_plans", {
            (whole, model): (tuple(a for a, n in self.sizes.items() if (whole or a != TP) and n > 1),
                             tuple(a for a in self.sum_axes(model) if self.sizes[a] > 1))
            for whole in (False, True) for model in (False, True)})

    def with_seq(self, n: int) -> "Partition":
        """Split a sequence of ``n`` over "model" when it divides."""
        return replace(self, seq=self.tp > 1 and n % self.tp == 0 and n >= self.tp)

    def sum_axes(self, model: bool) -> tuple:
        """The axes a gradient is summed over: the data axes when they
        split the batch, and "model" when ``model``."""
        return (self.data if self.split else ()) + ((TP,) if model and self.tp > 1 else ())

    def take(self, local: torch.Tensor, spec: tuple, whole: bool, sum_model: bool):
        """A leaf on use: gathered over the data axes, and over "model"
        too when ``whole``; its gradient summed over ``sum_axes(sum_model)``
        and cut back to ``local``'s block."""
        axes, sums = self._plans[whole, sum_model]
        if not (sums and local.requires_grad) and not _cuts(spec, self.mesh, axes):
            return local           # nothing to gather or to sum: the leaf as it is
        return GatherOnUse.apply(local, spec, self.mesh, axes, sums)

    def take_channels(self, local: torch.Tensor, spec: tuple, k: int) -> torch.Tensor:
        """A column-cut leaf of ``k`` equal parts on use: this rank's channel
        block of every part (``ChannelTake`` over "model", from the stored
        block), then gathered over the data axes as ``take`` gathers a
        leaf that keeps its "model" cut."""
        if self.tp > 1:
            local = ChannelTake.apply(local, k, self.mesh, TP)
        return self.take(local, spec, False, False)

    def feature_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' feature blocks of ``t`` (its last dimension) whole
        over "model"; under grad the gradient is reduce-scattered back to
        the rank's block (``SeqGather``)."""
        if self.tp == 1:
            return t
        return SeqGather.apply(t, self.mesh, TP, t.dim() - 1)

    def own_features(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dimension of ``t`` (a view)."""
        n = t.shape[-1] // self.tp
        return t.narrow(-1, self.rank * n, n)

    def local_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's shard of the sequence (dimension ``dim``) when it is
        split, else ``x``."""
        if not self.seq:
            return x
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.rank * n, n)

    def tp_enter(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if self.seq:
            return SeqGather.apply(x, self.mesh, TP, dim)
        if self.tp > 1 and torch.is_grad_enabled():
            return CopyToGroup.apply(x, self.mesh, TP)
        return x

    def tp_exit(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        if self.seq:
            return SeqScatter.apply(y, self.mesh, TP, dim)
        if self.tp > 1:
            return SumOverGroup.apply(y, self.mesh, TP)
        return y

    def rep_enter(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return SeqGather.apply(x, self.mesh, TP, dim) if self.seq else x

    def rep_exit(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return self.local_seq(y, dim)
