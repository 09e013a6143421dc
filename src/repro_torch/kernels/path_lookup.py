"""Batched path-digest lookup (the paper's Q1/GET) on Hopper — CUDA kernel.

Replaces ``repro/kernels/path_lookup.py::path_lookup`` (Pallas body
``_lookup_kernel``).  The kernel is ``csrc/path_lookup.cu``: a block of 8
warps stages the pinned hot set (the ("/" + dimensions) keys and their
sorted-table positions) and the top level of the fence column (every
32nd fence, i.e. every 4096th key) in shared memory; each warp then takes
one query through level 0 (pinned) and the first fence steps there, and
through one 32-way fence probe and one coalesced 128-key tile read in
global memory, the lowest matching position picked by ``__ballot_sync``.

What bounds it on the card: the chain of dependent loads (a query moves
12 bytes) and, at the main path's 4096 queries, the launch path.  So the
kernel cuts the chain to two global round trips a warp, and the wrapper
is lean: the C entry is bound once and takes its arguments packed in one
buffer, the checks are one comparison of plain values, the output is one
``torch.empty_like`` and the geometry comes from ``lookup_geometry``
(cached, pure Python).

Keys are one int64 per digest, ``((hi << 32) | lo) ^ (1 << 63)`` (``key64``):
signed order equals the unsigned digest order on the CPU, where torch
orders no uint32, and in the kernel.  ``pad_keys``/``pad_pinned`` are the
numpy helpers of the JAX package, kept as they are (0xFFFFFFFF fill,
which becomes INT64_MAX after ``key64``).
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

from . import build

TILE = 128
#: pinned sub-table allocation granule
PIN_TILE = 8
_SIGN = np.uint64(1 << 63)
WARPS = 8           # warps a block, one query each (csrc/path_lookup.cu)
TOP_MAX = 2048      # the most top-level fences a block stages (16 KB)
PIN_MAX = 256       # the most pinned entries a block stages (3 KB)
#: the C entry's arguments (csrc/path_lookup.cu LookupArgs), packed in one
#: buffer: ctypes would convert each separate argument on every call
_PACK = struct.Struct("<14q").pack
_FN = None


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


@functools.lru_cache(maxsize=256)
def lookup_geometry(n_q: int, n_keys: int, n_pin: int
                    ) -> tuple[int, int, int, int, int]:
    """(blocks, top_stride, n_top, n_pin_staged, smem_bytes) of one launch
    over ``n_q`` queries, a table of ``n_keys`` keys and ``n_pin`` pinned
    entries.

    One query a warp, 8 warps a block.  The top level is every
    ``top_stride``-th fence, ``top_stride`` the least power of 32 that
    keeps it within TOP_MAX entries, and none (``n_top`` 0) when the table
    has at most 32 fences (one global step finds the tile).  The first
    PIN_MAX pinned entries are staged; the rest are read from global
    memory."""
    blocks = -(-n_q // WARPS)
    n_fences = -(-n_keys // TILE)
    top_stride, n_top = 32, 0
    if n_fences > 32:
        while -(-n_fences // top_stride) > TOP_MAX:
            top_stride *= 32
        n_top = -(-n_fences // top_stride)
    n_pin_staged = min(n_pin, PIN_MAX)
    return blocks, top_stride, n_top, n_pin_staged, 8 * n_top + 12 * n_pin_staged


def _launcher():
    global _FN
    if _FN is None:
        fn = build.library("path_lookup").path_lookup_launch
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def path_lookup(keys: torch.Tensor, queries: torch.Tensor, *,
                pinned: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """keys: (N,) int64 sorted; queries: (Q,) int64; pinned: optional
    (pin_keys (P,) int64, pin_pos (P,) int32) where pin_pos[j] is the
    sorted-table position of pin_keys[j].  Returns (Q,) int32 positions,
    -1 on a miss.  CUDA tensors only."""
    if not keys.is_cuda:
        raise ValueError("path_lookup kernel: tensors must be on a CUDA device")
    dev = keys.get_device()
    ok = (keys.dtype, keys.dim(), keys.is_contiguous(), queries.dtype, queries.dim(),
          queries.is_contiguous(), queries.get_device()) == (
              torch.int64, 1, True, torch.int64, 1, True, dev)
    if pinned is None:
        pin_keys = pin_pos = n_pin = 0
    else:
        pk, pp = pinned
        n_pin = pk.shape[0]
        ok = ok and (pk.dtype, pk.dim(), pk.is_contiguous(), pk.get_device(), pp.dtype,
                     pp.shape, pp.is_contiguous(), pp.get_device()) == (
                         torch.int64, 1, True, dev, torch.int32, (n_pin,), True, dev)
        pin_keys, pin_pos = pk.data_ptr(), pp.data_ptr()
    if not ok:
        raise ValueError(
            f"path_lookup: keys, queries and pin_keys must be contiguous 1-D int64 and "
            f"pin_pos contiguous 1-D int32 of pin_keys' length, all on {keys.device}; got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}"
                        for t in (keys, queries, *(pinned or ()))))
    out = torch.empty_like(queries, dtype=torch.int32)
    n_q, n_keys = queries.shape[0], keys.shape[0]
    if n_q == 0:
        return out
    rc = _launcher()(_PACK(keys.data_ptr(), n_keys, pin_keys, pin_pos, n_pin,
                           queries.data_ptr(), n_q, out.data_ptr(),
                           *lookup_geometry(n_q, n_keys, n_pin), build.stream_of(keys)))
    build.check("path_lookup", rc)
    build.count_launch("path_lookup")
    return out
