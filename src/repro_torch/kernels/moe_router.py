"""Fused MoE router (softmax + top-k gate) on Hopper — CUDA kernel.

Replaces ``repro/kernels/moe_router.py::moe_router`` (Pallas body
``_router_kernel``).  The kernel is ``csrc/moe_router.cu``: one warp per
token, the token's E probabilities spread over the warp's registers
(ceil(E / 32) a lane), the softmax's max and sum and each of the k
selection rounds done by warp shuffles.  Ties go to the lowest expert
id, as the TPU kernel's first-match rule and ``lax.top_k`` order them:
each round is an exact arg-max on (probability, id) pairs.

What bounds it on the card: bytes (T*E*4 read, T*k*8 written), which at
every model shape is under 2 microseconds, so a launch costs its
latency.  It takes any T (the Pallas version asserted T % block_t == 0)
and f32 logits; every model path casts the router logits to f32 first.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_EXPERTS = 1024
MAX_K = 32


def _launcher():
    fn = build.library("moe_router").moe_router_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def moe_router(logits: torch.Tensor, k: int, *, renormalize: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) float32.  Returns (weights (T, k) float32, indices
    (T, k) int32).  CUDA tensors only; E <= MAX_EXPERTS, 1 <= k <=
    min(E, MAX_K)."""
    if not logits.is_cuda:
        raise ValueError("moe_router kernel: tensors must be on a CUDA device")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"moe_router: logits must be 2-D float32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    T, E = logits.shape
    if not (1 <= k <= min(E, MAX_K)) or E > MAX_EXPERTS:
        raise ValueError(f"moe_router: unsupported E={E}, k={k}")
    logits = logits.contiguous()
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return w, idx
    rc = _launcher()(logits.data_ptr(), w.data_ptr(), idx.data_ptr(), T, E, k,
                     int(renormalize), build.stream_of(logits))
    build.check("moe_router", rc)
    build.count_launch("moe_router")
    return w, idx
