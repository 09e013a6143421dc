"""Blocked online-softmax GQA attention on Hopper — CUDA kernel.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
body ``_flash_kernel``).  The kernel is ``csrc/flash_attention.cu``: one
block per (sequence, query head, query tile) walks the key tiles in a
loop with the running (m, l, acc) in registers; the TPU carried them in
VMEM scratch across a sequential grid dimension.

Semantics are the TPU kernel's: f32 scores times the scale, the finite
-1e30 mask, causal key tiles past a query tile's last visible key skipped,
queries at the last Sq positions (``seq_off = Skv - Sq``), ``l == 0 -> 1``.
Unlike the TPU kernel, Sq and Skv need not be block multiples (ragged
tails are masked in the kernel) and the query-head group Hq / Hkv is any
integer (GQA is index math; no repeated KV).

What bounds it on the card: operations (4·D flops per visible (query,
key) pair).  float32 runs on the CUDA cores in full f32 (no TF32), 64
queries a block.  bfloat16 runs Hopper's warp-specialised body: TMA copies
into a ring of key tiles, both products on wgmma (f32 accumulate, P
rounded to bf16 in registers for the second), 128 queries a block, or 64
where ``query_tile`` finds the grid too small for the card.  The plain
version it is held against is ``ref.attention_ref``.

Training: ``flash_attention(..., with_lse=True)`` also returns the rows'
log-sum-exp, which ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``,
held against ``ref.attention_bwd_ref``) reads to give dq, dk and dv.
``kernels.ops.attention`` joins the two in an autograd Function; called
directly under grad mode with an input that requires grad, these
wrappers raise rather than return an output autograd cannot see.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .build import N_SM

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64            # the smallest query tile; bounds the grid's y extent
MAX_GRID_Y = 65535


def query_tile(B: int, Hq: int, Sq: int, n_sm: int = N_SM) -> int:
    """The bf16 body's queries a block: 128 (two consumer warpgroups)
    when that grid, B * Hq * ceil(Sq / 128) blocks, fills the ``n_sm``
    SMs, else 64 (one warpgroup, twice the blocks: a chunked prefill of
    128 queries over 16 heads runs 32 blocks, not 16)."""
    return 128 if B * Hq * -(-Sq // 128) >= n_sm else 64


_FN = None
_BWD = None


def _launcher():
    global _FN
    if _FN is None:
        fn = build.library("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_launcher():
    global _BWD
    if _BWD is None:
        fn = build.library("flash_attention_bwd").flash_attention_bwd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v):
    """Raise for what the kernels do not take; return (B, Hq, Hkv, Sq, Skv, D)."""
    if not q.is_cuda:
        raise ValueError("flash_attention kernel: tensors must be on a CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if Sq > Skv:
        raise ValueError(f"flash_attention: Sq={Sq} > Skv={Skv}; the queries are the "
                         "last Sq positions of the context")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported head_dim {D}; need one of {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "need one of float32, bfloat16")
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("flash_attention: all tensors must be on one device")
    if -(-Sq // BLOCK_Q) > MAX_GRID_Y:
        raise ValueError(f"flash_attention: Sq={Sq} exceeds {BLOCK_Q * MAX_GRID_Y}")
    return B, Hq, Hkv, Sq, Skv, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    with_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0 and
    Sq <= Skv.  Returns (B, Hq, Sq, D) in q.dtype, and with ``with_lse``
    also the rows' log-sum-exp of the scaled scores, (B, Hq, Sq) float32.
    CUDA tensors only; float32 or bfloat16, D in HEAD_DIMS, any Sq, Skv
    and group."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v)
    build.refuse_grad("flash_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if q.numel() == 0:
        return (out, lse) if with_lse else out
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None,
                     B, Hq, Hkv, Sq, Skv, D, _DTYPES[q.dtype], int(bool(causal)), scale,
                     query_tile(B, Hq, Sq, build.sm_count(q.get_device())), build.stream_of(q))
    build.check("flash_attention", rc)
    build.count_launch("flash_attention")
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        sm_scale: float | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` given its
    output ``o``, its ``lse`` (``with_lse=True``) and the output's gradient
    ``do``, each in its input's dtype.  One launch (the key tiles' dK and
    dV, and the query tiles' dQ, in blocks of their own); the shapes the
    forward takes."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}; need "
                         f"({B}, {Hq}, {Sq}) float32")
    dev = q.get_device()
    if any(t.get_device() != dev for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: all tensors must be on one device")
    build.refuse_grad("flash_attention_bwd", q, k, v, o, do)
    # dO arrives strided from the transpose in layers.attn_apply
    q, k, v, o, lse, do = (_aligned(t) for t in (q, k, v, o, lse, do))
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    rc = _bwd_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                         do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         B, Hq, Hkv, Sq, Skv, D, _DTYPES[q.dtype], int(bool(causal)), scale,
                         build.stream_of(q))
    build.check("flash_attention_bwd", rc)
    build.count_launch("flash_attention_bwd")
    return dq, dk, dv
