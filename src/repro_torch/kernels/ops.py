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
the plain versions.  ``decode_attention`` and its head_dim split
(``decode_scores``, ``decode_combine``) have no backward kernel and raise
there.  Otherwise (inference) the kernels launch as they are.

A tensor without data off the CPU (a ``FakeTensor``, or a ``meta``
tensor) goes to the kernel's shape rule (``<kernel>_abstract`` in its
module): the outputs' shapes and dtypes, with no launch, no build and no
data read; ``LAUNCHES`` does not move.  While the dry run's counter
traces a step (``TRACER``, ``launch/dryrun.py``), every entry, on the
CPU's plain versions as on the shape rules, is recorded as one call of
its kernel by the kernel's work rule (``<kernel>_work``: FLOPs and
boundary bytes), and none of the ops inside it is; under grad it goes
through the same autograd Functions as the card, so the backward kernels
are recorded alike.  A real CUDA tensor still goes only to the kernel.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import decode_attention as _dec
from . import decode_split as _dsp
from . import flash_attention as _fa
from . import moe_router as _mr
from . import ref
from . import rmsnorm as _rn
from .build import LAUNCHES, reset_launches
from .decode_attention import decode_attention as _decode_kernel
from .decode_split import decode_combine as _combine_kernel
from .decode_split import decode_scores as _scores_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import flash_attention_bwd as _flash_bwd_kernel
from .moe_router import moe_router as _router_kernel
from .moe_router import moe_router_bwd as _router_bwd_kernel
from .path_lookup import key64, pad_keys, pad_pinned
from .path_lookup import path_lookup as _lookup_kernel
from .prefix_search import prefix_search as _prefix_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .rmsnorm import rmsnorm_bwd as _rmsnorm_bwd_kernel


#: the dry run's counter while it traces a step (``launch/dryrun.py``
#: sets it), else None
TRACER = None


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _abstract(t: torch.Tensor) -> bool:
    """A tensor without data: a FakeTensor (off the CPU) or a meta tensor."""
    return isinstance(t, FakeTensor) or t.is_meta


def _traced(name: str, fn):
    """``fn`` (a plain version or a shape rule) as one call of kernel
    ``name``: under ``TRACER``, recorded by the kernel's work rule alone."""
    work = _WORK[name]

    def call(*args, **kw):
        if TRACER is None:
            return fn(*args, **kw)
        return TRACER.kernel(name, work(*args, **kw), fn, *args, **kw)
    return call


def _attention_plain(q, k, v, *, causal=True, sm_scale=None, with_lse=False):
    return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale, return_lse=with_lse)


#: each kernel's work rule, and the two routes that launch nothing, by the
#: kernel wrappers' signatures: the plain versions (the CPU under the dry
#: run) and the shape rules (a FakeTensor off the CPU, a meta tensor)
_WORK = {"flash_attention": _fa.flash_attention_work,
         "flash_attention_bwd": _fa.flash_attention_bwd_work, "rmsnorm": _rn.rmsnorm_work,
         "rmsnorm_bwd": _rn.rmsnorm_bwd_work, "moe_router": _mr.moe_router_work,
         "moe_router_bwd": _mr.moe_router_bwd_work,
         "decode_attention": _dec.decode_attention_work,
         "decode_scores": _dsp.decode_scores_work, "decode_combine": _dsp.decode_combine_work}
_PLAIN = {k: _traced(k, fn) for k, fn in (
    ("flash_attention", _attention_plain), ("flash_attention_bwd", ref.attention_bwd_ref),
    ("rmsnorm", ref.rmsnorm_ref), ("rmsnorm_bwd", ref.rmsnorm_bwd_ref),
    ("moe_router", ref.moe_router_ref), ("moe_router_bwd", ref.moe_router_bwd_ref),
    ("decode_attention", ref.decode_attention_ref), ("decode_scores", ref.decode_scores_ref),
    ("decode_combine", ref.decode_combine_ref))}
_ABSTRACT = {k: _traced(k, getattr(mod, k + "_abstract")) for k, mod in (
    ("flash_attention", _fa), ("flash_attention_bwd", _fa), ("rmsnorm", _rn),
    ("rmsnorm_bwd", _rn), ("moe_router", _mr), ("moe_router_bwd", _mr),
    ("decode_attention", _dec), ("decode_scores", _dsp), ("decode_combine", _dsp))}


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _Attention(torch.autograd.Function):
    """flash_attention with its backward kernel (with a ``route``, the
    plain versions or the shape rules of both)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, route=None):
        fwd = route["flash_attention"] if route else _flash_kernel
        o, lse = fwd(q, k, v, causal=causal, sm_scale=sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.route = causal, sm_scale, route
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = ctx.route["flash_attention_bwd"] if ctx.route else _flash_bwd_kernel
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with its backward kernel; ``scale`` may be None."""

    @staticmethod
    def forward(ctx, x, scale, eps, route=None):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.route = eps, route
        return (route["rmsnorm"] if route else _rmsnorm_kernel)(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        bwd = ctx.route["rmsnorm_bwd"] if ctx.route else _rmsnorm_bwd_kernel
        dx, dscale = bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None, None


class _MoERouter(torch.autograd.Function):
    """moe_router with its backward kernel; the ids carry no gradient."""

    @staticmethod
    def forward(ctx, logits, k, renormalize, route=None):
        w, idx = (route["moe_router"] if route else _router_kernel)(logits, k,
                                                                renormalize=renormalize)
        ctx.mark_non_differentiable(idx)
        # with renormalize the backward reads the weights alone
        ctx.save_for_backward(w, idx, None if renormalize else logits)
        ctx.renormalize, ctx.n_experts, ctx.route = renormalize, logits.shape[-1], route
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        w, idx, logits = ctx.saved_tensors
        bwd = ctx.route["moe_router_bwd"] if ctx.route else _router_bwd_kernel
        dz = bwd(logits, w, idx, dw, renormalize=ctx.renormalize, n_experts=ctx.n_experts)
        return dz, None, None, None


def attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D)^2 -> (B, Hq, Sq, D); the queries
    are the last Sq positions.  On the CPU the plain version the JAX
    package's dispatch would take: the chunked online softmax when
    Skv > 1024 and Skv % 1024 == 0, full attention otherwise."""
    if _on_cpu(q):
        if TRACER is None:
            skv = k.shape[2]
            if skv > 1024 and skv % 1024 == 0:
                return ref.chunked_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                                 chunk=1024)
            return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale)
        route = _PLAIN
    elif _abstract(q):
        route = _ABSTRACT
    else:
        if _needs_grad(q, k, v):
            return _Attention.apply(q, k, v, causal, sm_scale)
        return _flash_kernel(q, k, v, causal=causal, sm_scale=sm_scale)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, sm_scale, route)
    return route["flash_attention"](q, k, v, causal=causal, sm_scale=sm_scale)


def rmsnorm(x, scale=None, eps: float = 1e-6):
    """RMSNorm over the last axis; ``scale=None`` is non-parametric."""
    if _on_cpu(x):
        if TRACER is None:
            return ref.rmsnorm_ref(x, scale, eps=eps)
        route = _PLAIN
    elif _abstract(x):
        route = _ABSTRACT
    else:
        if _needs_grad(x, scale):
            return _RMSNorm.apply(x, scale, eps)
        return _rmsnorm_kernel(x, scale, eps=eps)
    if _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps, route)
    return route["rmsnorm"](x, scale, eps=eps)


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale: float | None = None):
    """(B, Hq, D) x (B, Hkv, S, D)^2 x (B,) -> (B, Hq, D)."""
    if _on_cpu(q):
        if TRACER is None:
            return ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
        return _PLAIN["decode_attention"](q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    if _abstract(q):
        return _ABSTRACT["decode_attention"](q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    return _decode_kernel(q, k_cache, v_cache, lengths, sm_scale=sm_scale)


def decode_scores(q, k_cache, lengths, *, sm_scale: float):
    """(B, Hq, Dl) x (B, Hkv, S, Dl) x (B,) -> (B, Hq, S) f32: one head_dim
    slice's share of the scores (``sm_scale`` the whole head's)."""
    if _on_cpu(q):
        if TRACER is None:
            return ref.decode_scores_ref(q, k_cache, lengths, sm_scale=sm_scale)
        return _PLAIN["decode_scores"](q, k_cache, lengths, sm_scale=sm_scale)
    if _abstract(q):
        return _ABSTRACT["decode_scores"](q, k_cache, lengths, sm_scale=sm_scale)
    return _scores_kernel(q, k_cache, lengths, sm_scale=sm_scale)


def decode_combine(scores, v_cache, lengths):
    """(B, Hq, S) f32 x (B, Hkv, S, Dl) x (B,) -> (B, Hq, Dl): the masked
    softmax of the summed scores times one head_dim slice of V."""
    if _on_cpu(scores):
        if TRACER is None:
            return ref.decode_combine_ref(scores, v_cache, lengths)
        return _PLAIN["decode_combine"](scores, v_cache, lengths)
    if _abstract(scores):
        return _ABSTRACT["decode_combine"](scores, v_cache, lengths)
    return _combine_kernel(scores, v_cache, lengths)


def moe_router(logits, k: int, *, renormalize: bool = True):
    """(T, E) f32 -> (weights (T, k) f32, indices (T, k) int32)."""
    if _on_cpu(logits):
        if TRACER is None:
            return ref.moe_router_ref(logits, k, renormalize=renormalize)
        route = _PLAIN
    elif _abstract(logits):
        route = _ABSTRACT
    else:
        if _needs_grad(logits):
            return _MoERouter.apply(logits, k, renormalize)
        return _router_kernel(logits, k, renormalize=renormalize)
    if _needs_grad(logits):
        return _MoERouter.apply(logits, k, renormalize, route)
    return route["moe_router"](logits, k, renormalize=renormalize)


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


__all__ = ["attention", "rmsnorm", "decode_attention", "decode_scores", "decode_combine",
           "moe_router", "path_lookup",
           "prefix_search", "key64", "pad_keys", "pad_pinned", "LAUNCHES", "reset_launches"]
