"""Batched path-digest lookup (the paper's Q1/GET) on Hopper — CUDA kernel.

Replaces ``repro/kernels/path_lookup.py::path_lookup`` (Pallas body
``_lookup_kernel``).  The kernel is ``csrc/path_lookup.cu``: one warp per
query; level 0 compares the query with the pinned hot set (the staged
("/" + dimensions) keys and their sorted-table positions), level 1 finds
the query's 128-key tile by a 32-way search of the fence column (every
128th key), level 2 reads that one tile coalesced and takes the lowest
matching position with ``__ballot_sync``.

What bounds it on the card: the chain of dependent loads (a query moves
12 bytes), so the design cuts the chain to ceil(log32(N/128)) fence steps
plus one tile read; see the source for the details.

Keys are one int64 per digest, ``((hi << 32) | lo) ^ (1 << 63)`` (``key64``):
signed order equals the unsigned digest order on the CPU, where torch
orders no uint32, and in the kernel.  ``pad_keys``/``pad_pinned`` are the
numpy helpers of the JAX package, kept as they are (0xFFFFFFFF fill,
which becomes INT64_MAX after ``key64``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

TILE = 128
#: pinned sub-table allocation granule
PIN_TILE = 8
_SIGN = np.uint64(1 << 63)


def key64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """uint32 hi/lo digest halves -> int64 keys in the same order."""
    k = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    return (k ^ _SIGN).view(np.int64)


def pad_pinned(pin_hi: np.ndarray, pin_lo: np.ndarray, pin_pos: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a pinned staging triple to the PIN_TILE granule with
    0xFFFFFFFF key sentinels (position 0 — never selected)."""
    n = pin_hi.shape[0]
    pad = (-n) % PIN_TILE if n else PIN_TILE
    if pad == 0:
        return pin_hi, pin_lo, pin_pos
    fill = np.full((pad,), 0xFFFFFFFF, dtype=np.uint32)
    return (np.concatenate([pin_hi, fill]),
            np.concatenate([pin_lo, fill]),
            np.concatenate([pin_pos, np.zeros((pad,), np.int32)]))


def pad_keys(keys_hi: np.ndarray, keys_lo: np.ndarray
             ) -> tuple[np.ndarray, np.ndarray]:
    """Pad the sorted key table to a TILE multiple with 0xFFFFFFFF
    sentinels (greater than every real key, so search order is preserved;
    FNV of a non-empty path never yields 2^64-1)."""
    n = keys_hi.shape[0]
    pad = (-n) % TILE
    if pad == 0:
        return keys_hi, keys_lo
    fill = np.full((pad,), 0xFFFFFFFF, dtype=np.uint32)
    return (np.concatenate([keys_hi, fill]),
            np.concatenate([keys_lo, fill]))


def _launcher():
    fn = build.library("path_lookup").path_lookup_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check_1d(name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"path_lookup: {name} must be a contiguous 1-D {dtype} tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def path_lookup(keys: torch.Tensor, queries: torch.Tensor, *,
                pinned: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """keys: (N,) int64 sorted; queries: (Q,) int64; pinned: optional
    (pin_keys (P,) int64, pin_pos (P,) int32) where pin_pos[j] is the
    sorted-table position of pin_keys[j].  Returns (Q,) int32 positions,
    -1 on a miss.  CUDA tensors only."""
    if not keys.is_cuda:
        raise ValueError("path_lookup kernel: tensors must be on a CUDA device")
    dev = keys.device
    _check_1d("keys", keys, torch.int64, dev)
    _check_1d("queries", queries, torch.int64, dev)
    if pinned is not None:
        _check_1d("pin_keys", pinned[0], torch.int64, dev)
        _check_1d("pin_pos", pinned[1], torch.int32, dev)
        if pinned[0].shape != pinned[1].shape:
            raise ValueError("path_lookup: pin_keys and pin_pos differ in length")
        pin_keys, pin_pos, n_pin = pinned[0].data_ptr(), pinned[1].data_ptr(), pinned[0].shape[0]
    else:
        pin_keys, pin_pos, n_pin = None, None, 0
    n_q = queries.shape[0]
    out = torch.empty((n_q,), dtype=torch.int32, device=dev)
    if n_q == 0:
        return out
    rc = _launcher()(keys.data_ptr(), keys.shape[0], pin_keys, pin_pos, n_pin,
                     queries.data_ptr(), n_q, out.data_ptr(), build.stream_of(keys))
    build.check("path_lookup", rc)
    build.count_launch("path_lookup")
    return out
