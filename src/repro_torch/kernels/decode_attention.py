"""Single-token GQA decode attention on Hopper — CUDA kernel, split-KV
(FlashDecoding).

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (Pallas
body ``_decode_kernel``).  The kernel is ``csrc/decode_attention.cu``: a
split kernel where one warp owns ``chunk`` positions of one (sequence, KV
head) for the whole query-head group and writes a partial (m, l, acc),
and a combine kernel that merges the partials.  The TPU fused that
combine by revisiting VMEM scratch in grid order; Hopper's blocks run in
no order, hence the second kernel.

What bounds it on the card: bytes (K and V read once, about one flop per
byte); at serving shapes (a few hundred positions, B = 4) the launch
latency dominates.  Slices past each sequence's length do no work, so the
cost follows the live lengths, not the cache size S.

Scaling follows the TPU kernel (f32 scores times the scale), and the
plain version in ``ref.decode_attention_ref`` does the same.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: at most this many KV slices per (sequence, KV head)
MAX_SPLITS = 64


def split_plan(S: int) -> tuple[int, int]:
    """(chunk, n_split): positions per warp slice, a multiple of 32 chosen
    so that a cache of S positions has at most MAX_SPLITS slices."""
    chunk = 32 * max(1, -(-S // (32 * MAX_SPLITS)))
    return chunk, max(1, -(-S // chunk))


def _launcher():
    fn = build.library("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, sm_scale: float | None = None
                     ) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, S, D), contiguous; lengths: (B,).
    Returns (B, Hq, D) in q.dtype.  CUDA tensors only; float32 or
    bfloat16, D in HEAD_DIMS, Hq/Hkv in GROUPS, any S."""
    if not q.is_cuda:
        raise ValueError("decode_attention kernel: tensors must be on a CUDA device")
    B, Hq, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != D:
        raise ValueError(f"decode_attention: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if Hq % Hkv or Hq // Hkv not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: unsupported Hq={Hq} Hkv={Hkv} D={D}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; need one of float32, bfloat16")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: caches must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: caches must be 16-byte aligned")
    if any(t.device != q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("decode_attention: all tensors must be on one device")
    G = Hq // Hkv
    q = q.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    chunk, n_split = split_plan(S)
    n_part = B * Hkv * n_split * G
    m_scr = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    l_scr = torch.empty((n_part,), dtype=torch.float32, device=q.device)
    acc_scr = torch.empty((n_part * D,), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    if B == 0:
        return out
    rc = _launcher()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
                     out.data_ptr(), m_scr.data_ptr(), l_scr.data_ptr(), acc_scr.data_ptr(),
                     B, Hkv, G, S, D, _DTYPES[q.dtype], scale, chunk, n_split,
                     build.stream_of(q))
    build.check("decode_attention", rc)
    build.count_launch("decode_attention")
    return out
