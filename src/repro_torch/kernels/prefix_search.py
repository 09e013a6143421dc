"""Batched segment-aware prefix search (the paper's Q4/SEARCH) on Hopper —
CUDA kernel.

Replaces ``repro/kernels/prefix_search.py::prefix_search`` (Pallas body
``_prefix_kernel``).  The kernel is ``csrc/prefix_search.cu``: one thread
per path row, the row read as L/16 16-byte loads and held in registers,
every prefix of the launch staged in shared memory and compared four
bytes at a time.

What bounds it on the card: bytes — N*L read plus N*Q written, about one
integer operation per byte.  The row is read once for all Q prefixes (the
TPU kernel's multi-query tile, kept), and the ragged tail of N is masked
in the kernel instead of padding the table with 255 rows.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: prefixes per launch: bounds the kernel's shared memory (Q*(L+8) bytes)
Q_CHUNK = 256
ROW_LENGTHS = (32, 48, 64, 96, 128)


def _launcher():
    fn = build.library("prefix_search").prefix_search_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def prefix_search(tokens: torch.Tensor, prefixes: torch.Tensor,
                  prefix_lens: torch.Tensor) -> torch.Tensor:
    """tokens: (N, L) uint8; prefixes: (Q, L) uint8; prefix_lens: (Q,)
    int32.  Returns (N, Q) bool.  CUDA tensors only; L in ROW_LENGTHS."""
    if not tokens.is_cuda:
        raise ValueError("prefix_search kernel: tensors must be on a CUDA device")
    dev = tokens.device
    if tokens.dim() != 2 or tokens.dtype != torch.uint8:
        raise ValueError(f"prefix_search: tokens must be (N, L) uint8, got "
                         f"{tuple(tokens.shape)} {tokens.dtype}")
    N, L = tokens.shape
    if L not in ROW_LENGTHS:
        raise ValueError(f"prefix_search: row length {L} not in {ROW_LENGTHS}")
    if (prefixes.dim() != 2 or prefixes.shape[1] != L or prefixes.dtype != torch.uint8
            or prefixes.device != dev):
        raise ValueError("prefix_search: prefixes must be (Q, L) uint8 on the tokens' device")
    Q = prefixes.shape[0]
    if prefix_lens.shape != (Q,) or prefix_lens.device != dev:
        raise ValueError("prefix_search: prefix_lens must be (Q,) on the tokens' device")
    tokens = tokens.contiguous()
    prefixes = prefixes.contiguous()
    lens = prefix_lens.to(torch.int32).contiguous()
    if tokens.data_ptr() % 16 or prefixes.data_ptr() % 16:
        raise ValueError("prefix_search: tokens and prefixes must be 16-byte aligned")
    out = torch.empty((N, Q), dtype=torch.bool, device=dev)
    if N == 0 or Q == 0:
        return out
    fn = _launcher()
    stream = build.stream_of(tokens)
    for q0 in range(0, Q, Q_CHUNK):
        nq = min(Q_CHUNK, Q - q0)
        rc = fn(tokens.data_ptr(), N, L, prefixes[q0].data_ptr(),
                lens[q0].data_ptr(), nq, out.data_ptr() + q0, Q, stream)
        build.check("prefix_search", rc)
        build.count_launch("prefix_search")
    return out
