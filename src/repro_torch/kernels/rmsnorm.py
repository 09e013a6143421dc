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

Training: ``rmsnorm_bwd`` (the same library) gives dx and dscale, held
against ``ref.rmsnorm_bwd_ref``; ``kernels.ops.rmsnorm`` joins the two in
an autograd Function.  It is one launch with or without a scale: dscale's
column sums are taken by thread-block clusters, and over the clusters'
rows, a share of the columns each, by the blocks that finish a share last
(``bwd_geometry`` has the geometry), counted on integer counters that each
stream has its own of (``build.stream_slot``).
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from . import build
from .build import N_SM

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NVMAX = 8           # 16-byte vectors a thread keeps in registers (csrc/rmsnorm.cu)
WARP_ROW_VECS = 4   # the most 16-byte vectors a lane takes in a warp row
ROW_VECS = 4        # 16-byte vectors a thread of a block row aims at
WARP_ROW_MAX_D = 1024   # the longest scalar row a warp takes
BWD_MAX_D = 256 * 32    # the longest row the backward takes (256 threads x 32 columns)
BWD_BLOCKS_PER_SM = 2   # the backward's grid: two blocks of 256 threads an SM
BWD_MAX_CLUSTER = 8     # blocks of a cluster that sums dscale's rows
COUNTERS_A_SLOT = 32    # a stream's counters (one a cluster rank) in one 128-byte line
#: the backward's C entry arguments (csrc/rmsnorm.cu BwdArgs), packed in one buffer
_BWD_PACK = struct.Struct("<11qd6q").pack
_FN = None
_BWD = None


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


@functools.lru_cache(maxsize=256)
def bwd_geometry(rows: int, D: int, elt: int, vec_ok: bool, n_sm: int = N_SM
                 ) -> tuple[int, int, int, int, int]:
    """(threads a row, units a thread, elements a unit, blocks, cluster) of
    the backward over ``rows`` rows of ``D`` elements of ``elt`` bytes on a
    card of ``n_sm`` SMs.  ``vec_ok``: every base is 16-byte aligned, so a
    row of whole 16-byte vectors takes the vector body (a unit is one
    vector, 16 / elt elements), else the scalar one (a unit is one element).

    The vector body: about two units a thread, so threads a row is the
    power of two at or above half the row's units (1 to 256), and units a
    thread the power of two that covers the row.  The scalar body: about
    D / 8 threads a row (32 to 256), a power of two of elements each.  At
    most 32 elements a thread.  256 / (threads a row) rows share a block of
    256 threads; the grid is at most BWD_BLOCKS_PER_SM blocks an SM, in
    clusters of up to BWD_MAX_CLUSTER blocks (a power of two that divides
    the blocks) for dscale's sums."""
    if D > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: rows of {D} exceed {BWD_MAX_D}")
    vec = 16 // elt if vec_ok and (D * elt) % 16 == 0 else 1
    if vec > 1:
        nu = D // vec
        tpr = 1
        while tpr < 256 and 2 * tpr < nu:
            tpr *= 2
    else:
        nu = D
        tpr = 32
        while tpr < 256 and tpr * 8 < D:
            tpr *= 2
    units = 1
    while tpr * units < nu:
        units *= 2
    blocks = max(1, min(-(-rows // (256 // tpr)), BWD_BLOCKS_PER_SM * n_sm))
    cluster = 1
    while 2 * cluster <= min(blocks, BWD_MAX_CLUSTER):
        cluster *= 2
    return tpr, units, vec, blocks // cluster * cluster, cluster


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
    build.refuse_grad("rmsnorm", x, scale)
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


def _bwd_launcher():
    global _BWD
    if _BWD is None:
        fn = build.library("rmsnorm").rmsnorm_bwd_launch
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor | None, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradients (dx, dscale) of ``rmsnorm(x, scale, eps)`` given the
    output's gradient ``dy``: dx like x, dscale like the scale (None
    without one).  One launch with or without a scale (dscale's rows
    summed in a fixed order by clusters and by the blocks that finish a
    share of the columns last: no float atomics, the same bits every
    call).  Rows up to BWD_MAX_D."""
    if not x.is_cuda:
        raise ValueError("rmsnorm_bwd kernel: tensors must be on a CUDA device")
    x_dt = _DTYPES.get(x.dtype)
    if x_dt is None or dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype} and dy {tuple(dy.shape)} "
                         f"{dy.dtype}; need float32 or bfloat16 of one shape and dtype")
    D = x.shape[-1]
    dev = x.get_device()
    s_dt = -1
    if scale is not None:
        s_dt = _DTYPES.get(scale.dtype)
        if s_dt is None or scale.shape != (D,) or scale.get_device() != dev:
            raise ValueError(f"rmsnorm_bwd: scale must be ({D},) float32 or bfloat16 on {x.device}")
        scale = scale.contiguous()
    if dy.get_device() != dev:
        raise ValueError("rmsnorm_bwd: all tensors must be on one device")
    build.refuse_grad("rmsnorm_bwd", x, scale, dy)
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, torch.zeros_like(scale) if scale is not None else None
    xp, dyp, dxp = x.data_ptr(), dy.data_ptr(), dx.data_ptr()
    sp = scale.data_ptr() if scale is not None else 0
    tpr, units, vec, blocks, cluster = bwd_geometry(rows, D, x.element_size(),
                                                    (xp | dyp | dxp | sp) % 16 == 0,
                                                    build.sm_count(dev))
    stream = build.stream_of(x)
    partial = ds = None
    counters = 0
    if scale is not None:
        partial = torch.empty((blocks // cluster, D), dtype=torch.float32, device=x.device)
        ds = torch.empty_like(scale)
        counters = build.stream_slot("rmsnorm_bwd", x, stream, COUNTERS_A_SLOT)
    rc = _bwd_launcher()(_BWD_PACK(
        xp, sp, dyp, dxp, partial.data_ptr() if partial is not None else 0,
        ds.data_ptr() if ds is not None else 0, counters,
        rows, D, x_dt, s_dt, eps, tpr, units, vec, blocks, cluster, stream))
    build.check("rmsnorm", rc)
    build.count_launch("rmsnorm_bwd")
    return dx, ds


# ---------------------------------------------------------------------------
# the abstract path (``kernels.ops`` on a FakeTensor or a meta tensor): the
# outputs' shapes and dtypes and the work of a call, with no launch, no
# build and no data read
# ---------------------------------------------------------------------------
def _abstract_check(name: str, x: torch.Tensor, scale: torch.Tensor | None) -> None:
    D = x.shape[-1]
    if x.dtype not in _DTYPES or (scale is not None and (
            scale.dtype not in _DTYPES or tuple(scale.shape) != (D,))):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, scale "
                         f"{None if scale is None else (tuple(scale.shape), scale.dtype)}; "
                         f"need float32 or bfloat16 and a ({D},) scale")


def rmsnorm_abstract(x: torch.Tensor, scale: torch.Tensor | None = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm``'s output: x's shape and dtype, on x's device."""
    _abstract_check("rmsnorm", x, scale)
    return x.new_empty(x.shape)


def rmsnorm_work(x: torch.Tensor, scale: torch.Tensor | None = None,
                 eps: float = 1e-6) -> tuple[float, int]:
    """(FLOPs, bytes) of one call.  FLOPs are the matrix products'
    2·M·N·K (what ``launch/hlo_walk.py`` counts of a dot): a norm has
    none.  Bytes: x and the scale read once, the output written once."""
    return 0.0, 2 * build.nbytes(x) + build.nbytes(scale)


def rmsnorm_bwd_abstract(x: torch.Tensor, scale: torch.Tensor | None, dy: torch.Tensor,
                         eps: float = 1e-6):
    """``rmsnorm_bwd``'s (dx, dscale): like x and like the scale (None
    without one)."""
    _abstract_check("rmsnorm_bwd", x, scale)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype or x.shape[-1] > BWD_MAX_D:
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)} {x.dtype}, dy {tuple(dy.shape)} "
                         f"{dy.dtype}; need one shape and dtype, rows up to {BWD_MAX_D}")
    return x.new_empty(x.shape), None if scale is None else scale.new_empty(scale.shape)


def rmsnorm_bwd_work(x: torch.Tensor, scale: torch.Tensor | None, dy: torch.Tensor,
                     eps: float = 1e-6) -> tuple[float, int]:
    """(FLOPs, bytes) of one call: no matrix product; x, the scale and dy
    read once, dx and dscale written once."""
    return 0.0, 2 * build.nbytes(x) + build.nbytes(dy) + 2 * build.nbytes(scale)
