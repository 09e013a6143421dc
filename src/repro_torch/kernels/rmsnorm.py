"""Fused RMSNorm on Hopper — Triton kernel.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (Pallas bodies
``_rmsnorm_kernel`` and ``_rmsnorm_kernel_noscale``): RMSNorm over the
last axis, f32 compute, optional scale, cast back to x.dtype.

What bounds it on the card: bytes (one read and one write of x, a few
flops per element) — and at the serving shapes (rows of 64 or 256, a few
rows per call) the launch latency.  Design: one program per row, the row
in registers, f32 sum of squares, one store: the row-reduction pattern
Triton serves as well as CUDA.

Triton is imported at the first launch, not at import: the CPU has none,
and the CPU path of ``ops`` never comes here.  ``tl`` stays ``None`` until
then; Triton reads it from this module's globals when it compiles.
"""
from __future__ import annotations

import os

import torch

from . import build

tl = None  # triton.language, bound by _jit() at the first launch
_JIT = None


def _rmsnorm_kernel(x_ptr, s_ptr, o_ptr, D, eps,
                    HAS_SCALE: tl.constexpr, BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=0) / D
    y = x / tl.sqrt(ms + eps)
    if HAS_SCALE:
        y = y * tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)


def _jit():
    global _JIT, tl
    if _JIT is None:
        # keep Triton's compile cache inside the checkout
        os.environ.setdefault("TRITON_CACHE_DIR", str(build.BUILD_DIR / "triton"))
        import triton
        import triton.language as language
        tl = language
        _JIT = triton.jit(_rmsnorm_kernel)
    return _JIT


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None = None,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16 on a CUDA device; scale: (D,) or
    None (non-parametric)."""
    if not x.is_cuda:
        raise ValueError("rmsnorm kernel: tensors must be on a CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    if scale is not None and (scale.shape != (D,) or scale.device != x.device):
        raise ValueError(f"rmsnorm: scale must be ({D},) on {x.device}")
    xr = x.reshape(-1, D).contiguous()
    out = torch.empty_like(xr)
    rows = xr.shape[0]
    if rows == 0:
        return out.reshape(x.shape)
    s = scale.contiguous() if scale is not None else xr
    block = max(16, 1 << (D - 1).bit_length())
    _jit()[(rows,)](xr, s, out, D, eps, HAS_SCALE=scale is not None, BLOCK_D=block,
                    num_warps=1 if block <= 256 else 4)
    build.count_launch("rmsnorm")
    return out.reshape(x.shape)
