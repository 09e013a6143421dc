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
its group, keeps the assignments to its own experts, and one all-reduce
over the group sums the partial outputs, so dispatch needs no all-to-all.

Shared experts (kimi-style) are a dense gated MLP added unconditionally.
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
    sizes = torch.bincount(local_e, minlength=n_local + 1)[:n_local]
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
    ``x.dtype`` (the reference psums in bf16 for a bf16 model).  Under
    grad, x and the router enter through ``CopyToGroup`` (each rank's
    gradient of them covers its own experts: the group sums them) and
    the sum leaves through ``SumOverGroup`` (every rank then runs the same
    layers after it)."""
    from ..distributed.sharding import CopyToGroup, SumOverGroup, axis_coord
    m = cfg.moe
    T, D = x.shape
    E_loc = w_gate.shape[0]
    lo = axis_coord(mesh, TP) * E_loc
    if torch.is_grad_enabled():
        x = CopyToGroup.apply(x, mesh, TP)
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
    return SumOverGroup.apply(partial.to(x.dtype), mesh, TP)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Expert-parallel (``_moe_shard_body``)
    when ``mesh`` has a "model" axis of more than one rank that divides
    ``n_experts``; all experts local otherwise.  On a mesh, x is this
    rank's tokens: the batch was split over the data axes where it enters
    the model (``transformer.split_batch``, the reference's ``x_spec``
    rule: a batch too small to split stays replicated), and the "model"
    ranks of a data group hold the same rows.  ``params``' expert stacks
    may be whole (n_experts, ...) or this rank's slice (E / tp, ...)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    ep = ep_size(cfg, mesh)
    if not ep:
        return moe_apply_local(params, xt, cfg).reshape(B, S, D)
    from ..distributed.sharding import axis_coord
    E_loc = cfg.moe.n_experts // ep
    w = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if w[0].shape[0] != E_loc:                       # whole stacks: this rank's slice
        lo = axis_coord(mesh, TP) * E_loc
        w = [t[lo:lo + E_loc] for t in w]
    out = _moe_shard_body(xt, params["router"], *w, cfg=cfg, mesh=mesh)
    if cfg.moe.n_shared > 0:
        out = out + mlp_apply(params["shared"], xt)
    return out.reshape(B, S, D)
