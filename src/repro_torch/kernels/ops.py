"""Dispatch over the port's kernels: the entry points models/ and core/
call (counterpart of ``repro/kernels/ops.py``).

A tensor on the CPU goes to the plain version in ``ref``; a CUDA tensor
goes to the hand-written kernel, and any failure there raises — there is
no fallback from the card to the plain version.  ``LAUNCHES`` counts the
kernel launches of each wrapper.
"""
from __future__ import annotations

import torch

from . import ref
from .build import LAUNCHES, reset_launches
from .decode_attention import decode_attention as _decode_kernel
from .path_lookup import key64, pad_keys, pad_pinned
from .path_lookup import path_lookup as _lookup_kernel
from .prefix_search import prefix_search as _prefix_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def rmsnorm(x, scale=None, eps: float = 1e-6):
    """RMSNorm over the last axis; ``scale=None`` is non-parametric."""
    if _on_cpu(x):
        return ref.rmsnorm_ref(x, scale, eps=eps)
    return _rmsnorm_kernel(x, scale, eps=eps)


def decode_attention(q, k_cache, v_cache, lengths, *, sm_scale: float | None = None):
    """(B, Hq, D) x (B, Hkv, S, D)^2 x (B,) -> (B, Hq, D)."""
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, sm_scale=sm_scale)
    return _decode_kernel(q, k_cache, v_cache, lengths, sm_scale=sm_scale)


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


__all__ = ["rmsnorm", "decode_attention", "path_lookup", "prefix_search",
           "key64", "pad_keys", "pad_pinned", "LAUNCHES", "reset_launches"]
