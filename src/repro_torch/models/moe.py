"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, the
single-shard path).

Routing goes through ``kernels.ops.moe_router`` (the fused softmax +
top-k gate: the CUDA kernel on the card).  Expert compute is the
reference's capacity-based batched dispatch:

  sort assignments by expert -> scatter token ids into an (E, C) index
  buffer (capacity C per expert, GShard discipline; overflow drops) ->
  gather tokens to (E, C, D) -> one batched product per projection ->
  scatter-add combine weighted by the gate.

The batched products are ``torch.bmm`` and the dispatch's index work is
plain PyTorch, as the JAX package left both to XLA.  ``mode="drop"``
becomes one spare (expert, slot) row and column that every dropped
assignment writes to and that is cut off afterwards, so the dispatch
needs no host sync.

On a mesh whose "model" axis divides the experts, ``moe_apply`` runs the
reference's expert-parallel body (its ``shard_map`` over the TP/EP axis):
each "model" rank holds E / tp experts, routes the tokens it shares with
its group, keeps the assignments to its own experts, and one reduction
over the group sums the partial outputs, so dispatch needs no all-to-all.
Under a partitioned step whose activations are split over the sequence
on "model", the group's tokens are gathered along the sequence before
the body and the partial outputs reduce-scattered back to the sequence
shards after it; with the sequence whole, they are all-reduced.

Shared experts (kimi-style) are a dense gated MLP added unconditionally
(tensor-parallel beside the expert-parallel body).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import _dtype, dense_init, mlp_apply, mlp_init

TP = "model"        # the tensor/expert-parallel mesh axis


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (D, E) at scale 0.02, the experts' w_gate/w_up (E, D, F)
    and w_down (E, F, D) at 1/sqrt(d_in), and ``shared`` when
    ``n_shared > 0``; drawn on the generator's device."""
    assert cfg.moe is not None
    m = cfg.moe
    D, Fd, E = cfg.d_model, m.d_ff_expert, m.n_experts
    params = {"router": dense_init(gen, D, E, cfg, scale=0.02)}

    def experts(d_in, d_out):
        w = torch.randn((E, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device)
        return w.div_(math.sqrt(d_in)).to(_dtype(cfg.param_dtype))
    params["w_gate"] = experts(D, Fd)
    params["w_up"] = experts(D, Fd)
    params["w_down"] = experts(Fd, D)
    if m.n_shared > 0:
        params["shared"] = mlp_init(gen, cfg, d_ff=Fd * m.n_shared)
    return params


def _dispatch_ffn(x: torch.Tensor, local_e: torch.Tensor, tok_flat: torch.Tensor,
                  w_flat: torch.Tensor, n_local: int, cap_e: int, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Capacity dispatch + batched expert FFN + weighted combine.

    x: (T, D); local_e: (A,) expert id per assignment (n_local = not
    mine); tok_flat/w_flat: (A,) token id / gate weight.  Returns (T, D)
    f32 (zeros for tokens with no assignment kept)."""
    T, D = x.shape
    A = local_e.shape[0]
    local_e = local_e.to(torch.int64)
    order = torch.argsort(local_e, stable=True)     # experts ascending,
    sorted_e = local_e[order]                       # not-mine last
    sorted_tok = tok_flat[order].to(torch.int64)
    sorted_w = w_flat[order]
    # bincount's length depends on the data; a count of static length
    # (ids are at most n_local) traces under fake tensors, and on the card
    # it is one kernel as bincount is
    sizes = torch.zeros(n_local + 1, dtype=torch.int64, device=x.device).scatter_add_(
        0, local_e, torch.ones_like(local_e))[:n_local]
    starts = torch.cumsum(sizes, 0) - sizes
    pos_in_e = (torch.arange(A, device=x.device)
                - starts[sorted_e.clamp(0, n_local - 1)])
    valid = (sorted_e < n_local) & (pos_in_e < cap_e) & (pos_in_e >= 0)
    e_safe = torch.where(valid, sorted_e, n_local)  # the spare row: dropped
    p_safe = torch.where(valid, pos_in_e, cap_e)
    buf = torch.zeros((n_local + 1, cap_e + 1), dtype=torch.int64, device=x.device)
    buf[e_safe, p_safe] = sorted_tok
    buf = buf[:n_local, :cap_e]
    wbuf = torch.zeros((n_local + 1, cap_e + 1), dtype=torch.float32, device=x.device)
    wbuf[e_safe, p_safe] = sorted_w
    wbuf = wbuf[:n_local, :cap_e]
    xs = x[buf]                                     # (E, C, D)
    g = torch.bmm(xs, w_gate.to(xs.dtype))
    u = torch.bmm(xs, w_up.to(xs.dtype))
    h = (F.silu(g.float()) * u.float()).to(xs.dtype)
    del g, u
    ys = torch.bmm(h, w_down.to(xs.dtype))
    contrib = ys.float() * wbuf[..., None]          # gate 0 => adds nothing
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    out.index_add_(0, buf.reshape(-1), contrib.reshape(-1, D))
    return out


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    return max(int(math.ceil(tokens * top_k / max(n_experts, 1) * cf)), 4)


def moe_apply_local(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Single-shard MoE: x (T, D) -> (T, D)."""
    m = cfg.moe
    T, D = x.shape
    logits = (x @ params["router"]).float()
    weights, idx = ops.moe_router(logits, m.top_k)           # (T, k)
    tok_flat = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    cap = _capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    out = _dispatch_ffn(x, idx.reshape(-1), tok_flat, weights.reshape(-1), m.n_experts,
                        cap, params["w_gate"], params["w_up"], params["w_down"])
    out = out.to(x.dtype)
    if m.n_shared > 0:
        out = out + mlp_apply(params["shared"], x)
    return out


def ep_size(cfg: ModelConfig, mesh) -> int:
    """The expert-parallel width: the "model" axis's size when the mesh has
    one of more than one rank that divides ``n_experts``, else 0 (the
    local path)."""
    if mesh is None or cfg.moe is None or TP not in mesh.mesh_dim_names:
        return 0
    tp = mesh.size(mesh.mesh_dim_names.index(TP))
    return tp if tp > 1 and cfg.moe.n_experts % tp == 0 else 0


def _moe_shard_body(x: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, *, cfg: ModelConfig,
                    mesh) -> torch.Tensor:
    """One rank's share of an expert-parallel MoE layer.

    x: (T, D), this rank's tokens, the same on every rank of its "model"
    group; w_*: (E_loc, ...), this rank's slice of the experts (rank r
    holds experts r * E_loc ..).  Every rank of the group routes the same
    tokens (``ops.moe_router``: the kernel on the card), keeps the
    assignments to its own experts at the reference's capacity, runs its
    batched FFN, and the partial outputs are summed over the group in
    ``x.dtype`` (the reference psums in bf16 for a bf16 model): this
    returns the rank's partial output, which the caller reduces.  Under
    grad the router enters through ``CopyToGroup`` (each rank's gradient
    of it covers its own experts: the group sums them)."""
    from ..distributed.sharding import CopyToGroup, axis_coord
    m = cfg.moe
    T, D = x.shape
    E_loc = w_gate.shape[0]
    lo = axis_coord(mesh, TP) * E_loc
    if torch.is_grad_enabled():
        router = CopyToGroup.apply(router, mesh, TP)
    logits = (x @ router).float()
    weights, idx = ops.moe_router(logits, m.top_k)
    idx_flat = idx.reshape(-1).to(torch.int64)
    tok_flat = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    mine = (idx_flat >= lo) & (idx_flat < lo + E_loc)
    local_e = torch.where(mine, idx_flat - lo, E_loc)
    cap = _capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    partial = _dispatch_ffn(x, local_e, tok_flat, weights.reshape(-1), E_loc, cap,
                            w_gate, w_up, w_down)
    return partial.to(x.dtype)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              part=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Expert-parallel (``_moe_shard_body``)
    when the mesh has a "model" axis of more than one rank that divides
    ``n_experts``; all experts local otherwise.  On a mesh, x is this
    rank's tokens: the batch was split over the data axes where it enters
    the model (``transformer.split_batch``, the reference's ``x_spec``
    rule: a batch too small to split stays replicated).

    ``params``' expert stacks may be whole (n_experts, ...) or this
    rank's slice (E / tp, ...); a shared expert's leaves are this rank's
    columns of ``w_gate``/``w_up`` and rows of ``w_down`` (the whole
    leaves on a one-wide "model" axis).  The body and the shared expert
    give partial sums, which ``part.tp_exit`` reduces over the group.
    With ``mesh`` alone the "model" ranks of a data group hold the same
    rows and the sums are all-reduced.  With ``part`` (a partitioned step,
    ``distributed.sharding.Partition``) x is the rank's shard of the
    sequence when ``part.seq``: ``part.tp_enter`` gathers the group's
    sequence and ``part.tp_exit`` reduce-scatters the sums back to the
    shard; without expert parallelism every rank runs the whole layer on
    the whole sequence and keeps its shard."""
    if part is None and mesh is not None:
        from ..distributed.sharding import Partition
        from ..launch.mesh import dp_axes
        part = Partition(mesh, dp_axes(mesh), split=False)
    ep = ep_size(cfg, part.mesh if part is not None else None)
    if not ep:
        h = x if part is None else part.rep_enter(x)
        B, S, D = h.shape
        out = moe_apply_local(params, h.reshape(B * S, D), cfg).reshape(B, S, D)
        return out if part is None else part.rep_exit(out)
    from ..distributed.sharding import axis_coord
    E_loc = cfg.moe.n_experts // ep
    w = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if w[0].shape[0] != E_loc:                       # whole stacks: this rank's slice
        lo = axis_coord(part.mesh, TP) * E_loc
        w = [t[lo:lo + E_loc] for t in w]
    h = part.tp_enter(x)
    B, S, D = h.shape
    ht = h.reshape(B * S, D)
    out = _moe_shard_body(ht, params["router"], *w, cfg=cfg, mesh=part.mesh)
    if cfg.moe.n_shared > 0:
        out = out + mlp_apply(params["shared"], ht)
    return part.tp_exit(out.reshape(B, S, D))
