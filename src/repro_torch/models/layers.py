"""Shared layers: norms, RoPE, GQA attention (full-sequence and with a KV
cache), gated MLP.

Port of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors with the JAX package's layout: a weight is (d_in, d_out), so
``x @ W`` is the same product in both packages.  The block norms and
qk-norm go through ``kernels.ops.rmsnorm``, full-sequence attention
(``attn_apply``) through ``kernels.ops.attention`` and the decode
attention through ``kernels.ops.decode_attention``; the projections stay
``torch.matmul``, as the JAX package left them to XLA.

Float32 products run in full float32: ``set_fp32_matmul()`` turns TF32
off for matmuls and cuDNN, so the card computes what the CPU computes.
Cross-attention (``cross_attn_apply``, whisper's decoder over the
encoder's output) goes through ``kernels.ops.attention`` too, non-causal
and without RoPE.

On a mesh (``part``, a ``distributed.sharding.Partition``) the attention
and the MLP are tensor-parallel over "model", as the reference's specs
split them: ``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up`` are this
rank's column block, ``wo`` and ``w_down`` its row block.  The rank
attends over its own query heads (``Heads``, ``head_split``) and the KV
heads they read: its own block of ``wk``/``wv`` when the KV heads divide
over "model", else those heads' columns of the whole leaves.  The input
enters through ``part.tp_enter`` and the row-parallel product's partial
sums leave through one reduction, ``part.tp_exit``.  A decode over a
cache whose head_dim is cut over "model" (``attn_decode_head_dim``) runs
its attention on the rank's columns of every head, through
``kernels.ops.decode_scores`` and ``kernels.ops.decode_combine`` around
an all-reduce of the partial scores.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig


def set_fp32_matmul() -> None:
    """Float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, cfg: ModelConfig,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) matrix; default fan-in init, drawn on the
    generator's device (a CPU generator gives every device the same
    weights from one seed)."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return w.mul_(s).to(_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Unit scale on the generator's device (nothing is drawn)."""
    if cfg.nonparam_ln:
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=_dtype(cfg.param_dtype), device=gen.device)}


def norm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.nonparam_ln:
        # OLMo non-parametric LN: center + normalize, no affine
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        return ((xf - mu) * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    return ops.rmsnorm(x, params["scale"], eps=cfg.norm_eps)


def head_norm_apply(scale: torch.Tensor | None, x: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """qk-norm: RMS over the head dim (last axis)."""
    return ops.rmsnorm(x, scale, eps=eps)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(cfg: ModelConfig, device) -> torch.Tensor:
    d = cfg.head_dim
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S)."""
    ang = positions[..., None].float() * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention block (GQA + optional qk-norm) with a KV cache
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    H, KV, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    params = {
        "wq": dense_init(gen, D, H * Dh, cfg),
        "wk": dense_init(gen, D, KV * Dh, cfg),
        "wv": dense_init(gen, D, KV * Dh, cfg),
        "wo": dense_init(gen, H * Dh, D, cfg),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((Dh,), dtype=_dtype(cfg.param_dtype), device=gen.device)
        params["k_norm"] = torch.ones((Dh,), dtype=_dtype(cfg.param_dtype), device=gen.device)
    return params


@dataclass(frozen=True)
class Heads:
    """A rank's share of an attention layer: query heads [q0, q0 + nq)
    and the KV heads [kv0, kv0 + nkv) they read."""

    q0: int
    nq: int
    kv0: int
    nkv: int


def all_heads(cfg: ModelConfig) -> Heads:
    return Heads(0, cfg.n_heads, 0, cfg.n_kv_heads)


def head_split(cfg: ModelConfig, tp: int, rank: int, groups=None) -> Heads | None:
    """Rank ``rank``'s heads when ``tp`` ranks split the layer's heads:
    H / tp query heads, and either its block of the KV heads (when they
    divide over the ranks) or the one KV head its query heads share.
    None (the layer stays whole on every rank) when H does not divide, when
    its heads span part of a KV group, or when the local group size is not
    in ``groups`` (a kernel's)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if tp == 1:
        return all_heads(cfg)
    if H % tp:
        return None
    nq, G = H // tp, H // KV
    if KV % tp == 0:
        heads = Heads(rank * nq, nq, rank * (KV // tp), KV // tp)
    elif nq < G and G % nq == 0:
        heads = Heads(rank * nq, nq, rank * nq // G, 1)
    else:
        return None
    return heads if groups is None or heads.nq // heads.nkv in groups else None


def _kv_weights(params: dict, heads: Heads, cfg: ModelConfig):
    """``wk``/``wv`` of the KV heads ``heads`` reads: the leaves as they are
    when they hold just those heads, else those heads' columns."""
    wk, wv = params["wk"], params["wv"]
    Dh = cfg.head_dim
    if wk.shape[1] == heads.nkv * Dh:
        return wk, wv
    cols = slice(heads.kv0 * Dh, (heads.kv0 + heads.nkv) * Dh)
    return wk[:, cols], wv[:, cols]


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, wk: torch.Tensor, wv: torch.Tensor):
    """q, k, v of the heads ``params["wq"]``, ``wk`` and ``wv`` hold."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, -1, Dh)
    k = (x @ wk).reshape(B, S, -1, Dh)
    v = (x @ wv).reshape(B, S, -1, Dh)
    if cfg.qk_norm:
        q = head_norm_apply(params["q_norm"], q, cfg.norm_eps)
        k = head_norm_apply(params["k_norm"], k, cfg.norm_eps)
    inv = rope_freqs(cfg, x.device)
    q = apply_rope(q.transpose(1, 2), positions[:, None, :], inv)
    k = apply_rope(k.transpose(1, 2), positions[:, None, :], inv)
    return q, k, v.transpose(1, 2)  # (B, Hq, S, Dh), (B, Hkv, S, Dh) x2


def attn_apply(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               causal: bool = True, part=None, heads: Heads | None = None) -> torch.Tensor:
    """Full-sequence (prefill / loss) attention: x (B, S, D) -> (B, S, D),
    positions 0 .. S-1; causal, or not for an encoder.  With ``part``, the
    rank's ``heads`` (tensor-parallel; x is this rank's input and the
    result its shard of the sum)."""
    h = x if part is None else part.tp_enter(x)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    q, k, v = _project_qkv(params, h, positions, cfg,
                           *_kv_weights(params, heads or all_heads(cfg), cfg))
    o = ops.attention(q, k, v, causal=causal)  # (B, Hq, S, Dh)
    out = o.transpose(1, 2).reshape(B, S, -1) @ params["wo"]
    return out if part is None else part.tp_exit(out)


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params: dict, x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                cfg: ModelConfig, part=None, heads: Heads | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, D); cache k/v (B, KV, S, Dh); lengths (B,).

    Every lane writes its new key and value at position ``lengths`` and
    attends over ``lengths + 1`` positions, as the reference does.  The
    cache is updated IN PLACE (the JAX reference returns a new cache);
    the returned dict holds the same tensors.

    With ``part`` the rank's query ``heads`` attend (tensor-parallel) and
    ``wk``/``wv`` hold the KV heads the cache holds: either the rank's own
    block of them (its KV heads on "model", nothing gathered) or all of
    them (a gathered cache), of which the rank reads its ``heads``."""
    heads = heads or all_heads(cfg)
    h = x if part is None else part.tp_enter(x)
    B = h.shape[0]
    q, k_new, v_new = _project_qkv(params, h, lengths[:, None], cfg, params["wk"], params["wv"])
    b_idx = torch.arange(B, device=x.device)
    pos = lengths.to(torch.int64)
    cache["k"][b_idx, :, pos, :] = k_new[:, :, 0, :].to(cache["k"].dtype)
    cache["v"][b_idx, :, pos, :] = v_new[:, :, 0, :].to(cache["v"].dtype)
    kc, vc = cache["k"], cache["v"]
    if kc.shape[1] != heads.nkv:                     # all KV heads: read the rank's
        kc, vc = (c[:, heads.kv0:heads.kv0 + heads.nkv].contiguous() for c in (kc, vc))
    o = ops.decode_attention(q[:, :, 0, :], kc, vc, lengths + 1)
    out = o.reshape(B, 1, -1) @ params["wo"]
    return (out if part is None else part.tp_exit(out)), cache


def attn_decode_head_dim(params: dict, x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                         cfg: ModelConfig, part, heads: Heads | None = None
                         ) -> tuple[torch.Tensor, dict]:
    """One-token decode over a cache whose head_dim is cut over "model"
    (the reference's "head_dim" layout): ``cache`` k/v hold this rank's
    columns [r*Dl, (r+1)*Dl) of every KV head, (B, KV, S, Dl).

    q, k_new and v_new are projected, qk-normed and rotated on the whole
    head vector (RoPE pairs column d with d + Dh/2, which lie on different
    ranks), q of this rank's ``heads`` (then all-gathered over "model") or,
    with ``heads`` None, of every head; ``wk``/``wv`` are whole.  The rank
    writes its columns of k_new and v_new at ``lengths`` (no cache byte
    moves), computes its partial scores (``ops.decode_scores``, scaled by
    the whole head's 1/sqrt(Dh)), all-reduces them over "model" (the
    reference's psum of the Dh-partial logits), and applies the softmax
    to its V columns (``ops.decode_combine``); the outputs' columns are
    all-gathered over "model" and the rank's heads finish through its
    ``wo`` rows (``part.tp_exit``), or every head through the whole
    ``wo``."""
    from ..distributed.sharding import TP, _all_gather, all_reduce
    tp, group = part.tp, part.mesh.get_group(TP)
    h = x if heads is None else part.tp_enter(x)
    B = h.shape[0]
    Dh = cfg.head_dim
    Dl = Dh // tp
    q, k_new, v_new = _project_qkv(params, h, lengths[:, None], cfg, params["wk"], params["wv"])
    q = q[:, :, 0, :]
    if heads is not None:                            # every rank's heads, in rank order
        q = _all_gather(q, 1, group, tp)
    cols = slice(part.rank * Dl, (part.rank + 1) * Dl)
    b_idx = torch.arange(B, device=x.device)
    pos = lengths.to(torch.int64)
    cache["k"][b_idx, :, pos, :] = k_new[:, :, 0, cols].to(cache["k"].dtype)
    cache["v"][b_idx, :, pos, :] = v_new[:, :, 0, cols].to(cache["v"].dtype)
    live = lengths + 1
    s = ops.decode_scores(q[..., cols].contiguous(), cache["k"], live,
                          sm_scale=1.0 / math.sqrt(Dh))
    s = all_reduce(s, (TP,), part.mesh)
    o = _all_gather(ops.decode_combine(s, cache["v"], live), 2, group, tp)   # (B, Hq, Dh)
    if heads is None:
        return o.reshape(B, 1, -1) @ params["wo"], cache
    o = o[:, heads.q0:heads.q0 + heads.nq]
    return part.tp_exit(o.reshape(B, 1, -1) @ params["wo"]), cache


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------
def cross_attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return attn_init(gen, cfg)


def cross_attn_apply(params: dict, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig, part=None, heads: Heads | None = None) -> torch.Tensor:
    """x: (B, Sq, D) queries; enc_out: (B, Se, D) keys and values.  No
    RoPE and no qk-norm (whisper's positions are folded into the stub's
    frames); non-causal, so Sq may exceed Se.  With ``part``, the rank's
    ``heads`` as in ``attn_apply``; ``enc_out`` is whole (the caller
    entered it once for every layer)."""
    h = x if part is None else part.tp_enter(x)
    B, Sq, _ = h.shape
    Se = enc_out.shape[1]
    Dh = cfg.head_dim
    wk, wv = _kv_weights(params, heads or all_heads(cfg), cfg)
    q = (h @ params["wq"]).reshape(B, Sq, -1, Dh).transpose(1, 2)
    k = (enc_out @ wk).reshape(B, Se, -1, Dh).transpose(1, 2)
    v = (enc_out @ wv).reshape(B, Se, -1, Dh).transpose(1, 2)
    o = ops.attention(q, k, v, causal=False)
    out = o.transpose(1, 2).reshape(B, Sq, -1) @ params["wo"]
    return out if part is None else part.tp_exit(out)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    return {"w_gate": dense_init(gen, D, Fd, cfg),
            "w_up": dense_init(gen, D, Fd, cfg),
            "w_down": dense_init(gen, Fd, D, cfg)}


def mlp_apply(params: dict, x: torch.Tensor, part=None) -> torch.Tensor:
    """The gated MLP; with ``part``, over this rank's columns of
    ``w_gate``/``w_up`` and rows of ``w_down`` (tensor-parallel)."""
    h = x if part is None else part.tp_enter(x)
    g = F.silu((h @ params["w_gate"]).float())
    u = (h @ params["w_up"]).float()
    out = (g * u).to(h.dtype) @ params["w_down"]
    return out if part is None else part.tp_exit(out)
