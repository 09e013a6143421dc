"""Dispatch over the port's kernels: the entry points models/ and core/
call (counterpart of ``repro/kernels/ops.py``).

A tensor on the CPU goes to the plain version in ``ref``; a CUDA tensor
goes to the hand-written kernel, and any failure there raises — there is
no fallback from the card to the plain version.  ``LAUNCHES`` counts the
kernel launches of each wrapper.

Under grad mode, with an input that requires grad, ``attention``,
``rmsnorm`` and ``moe_router`` on the card go through autograd Functions
whose forward is the kernel (the attention's with its log-sum-exp) and
whose backward is the backward kernel (``flash_attention_bwd``,
``rmsnorm_bwd``, ``moe_router_bwd``); on the CPU autograd differentiates
the plain versions.  ``decode_attention`` has no backward kernel and
raises there.  Otherwise (inference) the kernels launch as they are.
"""
from __future__ import annotations

import torch

from . import ref
from .build import LAUNCHES, reset_launches
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import flash_attention_bwd as _flash_bwd_kernel
from .moe_router import moe_router as _router_kernel
from .moe_router import moe_router_bwd as _router_bwd_kernel
from .path_lookup import key64, pad_keys, pad_pinned
from .path_lookup import path_lookup as _lookup_kernel
from .prefix_search import prefix_search as _prefix_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .rmsnorm import rmsnorm_bwd as _rmsnorm_bwd_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _Attention(torch.autograd.Function):
    """flash_attention with its backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = _flash_kernel(q, k, v, causal=causal, sm_scale=sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_kernel(q, k, v, o, lse, do, causal=ctx.causal,
                                       sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with its backward kernel; ``scale`` may be None."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_kernel(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rmsnorm_bwd_kernel(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


class _MoERouter(torch.autograd.Function):
    """moe_router with its backward kernel; the ids carry no gradient."""

    @staticmethod
    def forward(ctx, logits, k, renormalize):
        w, idx = _router_kernel(logits, k, renormalize=renormalize)
        ctx.mark_non_differentiable(idx)
        # with renormalize the backward reads the weights alone
        ctx.save_for_backward(w, idx, None if renormalize else logits)
        ctx.renormalize, ctx.n_experts = renormalize, logits.shape[-1]
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        w, idx, logits = ctx.saved_tensors
        dz = _router_bwd_kernel(logits, w, idx, dw, renormalize=ctx.renormalize,
                                n_experts=ctx.n_experts)
        return dz, None, None


def attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D)^2 -> (B, Hq, Sq, D); the queries
    are the last Sq positions.  On the CPU the plain version the JAX
    package's dispatch would take: the chunked online softmax when
    Skv > 1024 and Skv % 1024 == 0, full attention otherwise."""
    if _on_cpu(q):
        skv = k.shape[2]
        if skv > 1024 and skv % 1024 == 0:
            return ref.chunked_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                             chunk=1024)
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, sm_scale)
    return _flash_kernel(q, k, v, causal=causal, sm_scale=sm_scale)


def rmsnorm(x, scale=None, eps: float = 1e-6):
    """RMSNorm over the last axis; ``scale=None`` is non-parametric."""
    if _on_cpu(x):
        return ref.rmsnorm_ref(x, scale, eps=eps)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_kernel(x, scale, eps=eps)


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale: float | None = None):
    """(B, Hq, D) x (B, Hkv, S, D)^2 x (B,) -> (B, Hq, D)."""
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    return _decode_kernel(q, k_cache, v_cache, lengths, sm_scale=sm_scale)


def moe_router(logits, k: int, *, renormalize: bool = True):
    """(T, E) f32 -> (weights (T, k) f32, indices (T, k) int32)."""
    if _on_cpu(logits):
        return ref.moe_router_ref(logits, k, renormalize=renormalize)
    if _needs_grad(logits):
        return _MoERouter.apply(logits, k, renormalize)
    return _router_kernel(logits, k, renormalize=renormalize)


def path_lookup(keys, queries, *, pinned=None):
    """Sorted int64 digest table x (Q,) int64 queries -> (Q,) int32
    positions or -1.  ``pinned`` is the hot-set staging pair (pin_keys,
    pin_pos): a pinned query resolves to its staged position first."""
    if _on_cpu(keys):
        if pinned is not None:
            return ref.path_lookup_pinned_ref(keys, queries, *pinned)
        return ref.path_lookup_ref(keys, queries)
    return _lookup_kernel(keys, queries, pinned=pinned)


def prefix_search(tokens, prefixes, prefix_lens):
    """(N, L) x (Q, L) x (Q,) -> (N, Q) bool bitmap."""
    if _on_cpu(tokens):
        return ref.prefix_search_ref(tokens, prefixes, prefix_lens)
    return _prefix_kernel(tokens, prefixes, prefix_lens)


__all__ = ["attention", "rmsnorm", "decode_attention", "moe_router", "path_lookup",
           "prefix_search", "key64", "pad_keys", "pad_pinned", "LAUNCHES", "reset_launches"]
