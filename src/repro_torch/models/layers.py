"""Shared layers: norms, RoPE, GQA attention with a KV cache, gated MLP.

Port of ``repro/models/layers.py`` for the decode path.  Parameters are
plain dicts of tensors with the JAX package's layout: a weight is
(d_in, d_out), so ``x @ W`` is the same product in both packages.  The
block norms and qk-norm go through ``kernels.ops.rmsnorm`` and the decode
attention through ``kernels.ops.decode_attention``; the projections stay
``torch.matmul``, as the JAX package left them to XLA.

Float32 products run in full float32: ``set_fp32_matmul()`` turns TF32
off for matmuls and cuDNN, so the card computes what the CPU computes.
Full-sequence attention (``attn_apply``, ``cross_attn_apply``) needs the
flash-attention kernel and comes with that slice.
"""
from __future__ import annotations

import math

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
    """(d_in, d_out) matrix; default fan-in init, drawn on the CPU
    generator so every device gets the same weights from one seed."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32) * s
    return w.to(_dtype(cfg.param_dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(cfg: ModelConfig) -> dict:
    if cfg.nonparam_ln:
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=_dtype(cfg.param_dtype))}


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
        params["q_norm"] = torch.ones((Dh,), dtype=_dtype(cfg.param_dtype))
        params["k_norm"] = torch.ones((Dh,), dtype=_dtype(cfg.param_dtype))
    return params


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, KV, Dh)
    v = (x @ params["wv"]).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = head_norm_apply(params["q_norm"], q, cfg.norm_eps)
        k = head_norm_apply(params["k_norm"], k, cfg.norm_eps)
    inv = rope_freqs(cfg, x.device)
    q = apply_rope(q.transpose(1, 2), positions[:, None, :], inv)
    k = apply_rope(k.transpose(1, 2), positions[:, None, :], inv)
    return q, k, v.transpose(1, 2)  # (B, H, S, Dh), (B, KV, S, Dh) x2


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params: dict, x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, D); cache k/v (B, KV, S, Dh); lengths (B,).

    Every lane writes its new key and value at position ``lengths`` and
    attends over ``lengths + 1`` positions, as the reference does.  The
    cache is updated IN PLACE (the JAX reference returns a new cache);
    the returned dict holds the same tensors."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, lengths[:, None], cfg)
    b_idx = torch.arange(B, device=x.device)
    pos = lengths.to(torch.int64)
    cache["k"][b_idx, :, pos, :] = k_new[:, :, 0, :].to(cache["k"].dtype)
    cache["v"][b_idx, :, pos, :] = v_new[:, :, 0, :].to(cache["v"].dtype)
    o = ops.decode_attention(q[:, :, 0, :], cache["k"], cache["v"], lengths + 1)
    o = o.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return o @ params["wo"], cache


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    return {"w_gate": dense_init(gen, D, Fd, cfg),
            "w_up": dense_init(gen, D, Fd, cfg),
            "w_down": dense_init(gen, Fd, D, cfg)}


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ params["w_gate"]).float())
    u = (x @ params["w_up"]).float()
    return (g * u).to(x.dtype) @ params["w_down"]
