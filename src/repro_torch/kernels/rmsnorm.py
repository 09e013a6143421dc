"""Fused RMSNorm on Hopper — CUDA kernel.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm`` (Pallas bodies
``_rmsnorm_kernel`` and ``_rmsnorm_kernel_noscale``): RMSNorm over the
last axis, f32 compute, optional scale, cast back to x.dtype.  The kernel
is ``csrc/rmsnorm.cu``.

What bounds it on the card: bytes (one read and one write of x, a few
flops per element) — and at the serving shapes (rows of 64 or 256, a few
rows per call) the launch path.  So the wrapper is lean: the C entry is
bound once, x and the scale are passed without a copy when they are
contiguous, the output is one ``torch.empty_like``, and the launch geometry
comes from ``launch_geometry`` (cached, pure Python): one warp per row
up to D = 1024 in bf16, one block per row above, 16-byte vectors where
the row and its bases allow them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .build import N_SM

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NVMAX = 8           # 16-byte vectors a thread keeps in registers (csrc/rmsnorm.cu)
WARP_ROW_VECS = 4   # the most 16-byte vectors a lane takes in a warp row
ROW_VECS = 4        # 16-byte vectors a thread of a block row aims at
WARP_ROW_MAX_D = 1024   # the longest scalar row a warp takes
_FN = None


@functools.lru_cache(maxsize=256)
def launch_geometry(rows: int, D: int, elt: int, vec_ok: bool, n_sm: int = N_SM
                    ) -> tuple[int, int, int]:
    """(threads, rows_per_block, vec) of one launch over ``rows`` rows of
    ``D`` elements of ``elt`` bytes on a card of ``n_sm`` SMs (the wrapper
    passes the device's count).  ``vec_ok``: every base is 16-byte
    aligned, so rows of a whole number of 16-byte vectors take the vector
    body (vec = 16 / elt), else the scalar one (vec = 1).

    Rows of at most WARP_ROW_VECS vectors a lane (D <= 1024 in bf16): a
    warp per row, 1-4 rows a block, as many as keep the grid at two or
    more waves of n_sm blocks.  Longer rows: a block per row with
    about ROW_VECS vectors a thread (64 threads at D = 2048 bf16, 192 at
    6144): each thread keeps several 16-byte loads in flight, which the
    card rewards over more threads a row with one load each."""
    vec = 16 // elt if vec_ok and (D * elt) % 16 == 0 else 1
    nvec = -(-D // vec)
    if (vec > 1 and nvec <= 32 * WARP_ROW_VECS) or (vec == 1 and D <= WARP_ROW_MAX_D):
        rpb = 1
        while rpb < 4 and -(-rows // (2 * rpb)) >= 2 * n_sm:
            rpb *= 2
        return 32 * rpb, rpb, vec
    if vec == 1:
        return 256, 1, 1
    threads = min(1024, max(64, 32 * -(-nvec // (32 * ROW_VECS))))
    if -(-nvec // threads) > NVMAX:
        return 256, 1, 1
    return threads, 1, vec


def _launcher():
    global _FN
    if _FN is None:
        fn = build.library("rmsnorm").rmsnorm_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def rmsnorm(x: torch.Tensor, scale: torch.Tensor | None = None,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D) float32 or bfloat16 on a CUDA device; scale: (D,)
    float32 or bfloat16, or None (non-parametric)."""
    if not x.is_cuda:
        raise ValueError("rmsnorm kernel: tensors must be on a CUDA device")
    x_dt = _DTYPES.get(x.dtype)
    if x_dt is None:
        raise ValueError(f"rmsnorm: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    s_dt = -1
    if scale is not None:
        s_dt = _DTYPES.get(scale.dtype)
        if s_dt is None or scale.shape != (D,) or scale.get_device() != x.get_device():
            raise ValueError(f"rmsnorm: scale must be ({D},) float32 or bfloat16 on {x.device}")
        if not scale.is_contiguous():
            scale = scale.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    rows = n // D
    xp, op = x.data_ptr(), out.data_ptr()
    sp = scale.data_ptr() if scale is not None else 0
    threads, rpb, vec = launch_geometry(rows, D, x.element_size(),
                                        (xp | op | sp) % 16 == 0, build.sm_count(x.get_device()))
    rc = _launcher()(xp, sp or None, op, rows, D, x_dt, s_dt, eps, threads, rpb, vec,
                     build.stream_of(x))
    build.check("rmsnorm", rc)
    build.count_launch("rmsnorm")
    return out
