"""Batched segment-aware prefix search (the paper's Q4/SEARCH) on Hopper —
CUDA kernel.

Replaces ``repro/kernels/prefix_search.py::prefix_search`` (Pallas body
``_prefix_kernel``).  The kernel is ``csrc/prefix_search.cu``: a
persistent grid of 256-thread blocks walking 256-row tiles, one row a
thread held in registers (the next tile's loads in flight during the
write-out); every prefix of the launch staged once per block in shared
memory with two heads (words 0 and 1, and words 2 and 3, under their
masks, and the masks) and a descriptor (word count, last-word mask, the
index of the byte after it, whether the boundary rule applies); each
prefix compared only as far as the rows need — words 0 and 1 without a
branch, words 2 and 3 only for the prefixes some lane still matches, the
rest word by word while a lane does; the tile's bitmap built in shared
memory and written out coalesced.

What bounds it on the card: bytes — N*L read plus N*Q written.  The row
is read once for all Q prefixes (the TPU kernel's multi-query tile, kept),
and the ragged tail of N is masked in the kernel instead of padding the
table with 255 rows.  The host path is lean: the C entry is bound once,
its arguments go packed in one buffer, the checks are one comparison and
the output is one ``torch.empty``; the geometry comes from
``search_geometry`` (cached, pure Python).
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from . import build

#: prefixes per launch: bounds the kernel's shared memory
Q_CHUNK = 256
ROW_LENGTHS = (32, 48, 64, 96, 128)
TILE = 256              # rows a tile = threads a block (csrc/prefix_search.cu)
BLOCKS_PER_SM = 4       # the kernel's __launch_bounds__ minimum
SMEM_SM = 233472        # shared memory an SM holds for its blocks (228 KB)
SMEM_MAX = 232448       # the most one block may take (227 KB)
_ROWS = {(L,) for L in ROW_LENGTHS}
#: the C entry's arguments (csrc/prefix_search.cu SearchArgs), packed in one
#: buffer: ctypes would convert each separate argument on every call
_PACK = struct.Struct("<11q").pack
_FN = None


@functools.lru_cache(maxsize=256)
def search_geometry(n_rows: int, row_len: int, n_q: int, n_sm: int = build.N_SM
                    ) -> tuple[int, int, int]:
    """(blocks, rows per tile, shared bytes) of one launch over ``n_rows``
    rows of ``row_len`` bytes and ``n_q`` <= Q_CHUNK prefixes.

    Shared memory holds the prefixes (n_q * L), two 16-byte heads and an
    8-byte descriptor a prefix (n_q rounded up to 4) and the tile's bitmap
    (TILE rows of n_q bytes rounded up to 16, plus 16 of padding that
    spreads a warp's stores over the banks).  The grid is persistent: as
    many blocks as fit on the card at once (at most BLOCKS_PER_SM an SM,
    fewer where shared memory runs out, 1 KB an SM reserved for each),
    never more than there are tiles."""
    smem = n_q * row_len + 40 * -(-n_q // 4) * 4 + TILE * (-(-n_q // 16) * 16 + 16)
    per_sm = max(1, min(BLOCKS_PER_SM, SMEM_SM // (smem + 1024)))
    tiles = -(-n_rows // TILE)
    return max(1, min(tiles, n_sm * per_sm)), TILE, smem


def _launcher():
    global _FN
    if _FN is None:
        lib = build.library("prefix_search")
        init = lib.prefix_search_init
        init.argtypes = []
        init.restype = ctypes.c_int
        build.check("prefix_search", init())
        fn = lib.prefix_search_launch
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _coerce(tokens, prefixes, prefix_lens):
    """The slow path of the checks: name what is wrong, or return
    contiguous copies and int32 lengths."""
    if tokens.dim() != 2 or tokens.dtype != torch.uint8:
        raise ValueError(f"prefix_search: tokens must be (N, L) uint8, got "
                         f"{tuple(tokens.shape)} {tokens.dtype}")
    N, L = tokens.shape
    if L not in ROW_LENGTHS:
        raise ValueError(f"prefix_search: row length {L} not in {ROW_LENGTHS}")
    if (prefixes.dim() != 2 or prefixes.shape[1] != L or prefixes.dtype != torch.uint8
            or prefixes.device != tokens.device):
        raise ValueError("prefix_search: prefixes must be (Q, L) uint8 on the tokens' device")
    if prefix_lens.shape != prefixes.shape[:1] or prefix_lens.device != tokens.device:
        raise ValueError("prefix_search: prefix_lens must be (Q,) on the tokens' device")
    return (tokens.contiguous(), prefixes.contiguous(),
            prefix_lens.to(torch.int32).contiguous())


def prefix_search(tokens: torch.Tensor, prefixes: torch.Tensor,
                  prefix_lens: torch.Tensor) -> torch.Tensor:
    """tokens: (N, L) uint8; prefixes: (Q, L) uint8; prefix_lens: (Q,)
    int32 (another integer type is converted), each >= 0.  Returns (N, Q)
    bool.  CUDA tensors only; L in ROW_LENGTHS."""
    if not tokens.is_cuda:
        raise ValueError("prefix_search kernel: tensors must be on a CUDA device")
    dev = tokens.get_device()
    if (tokens.dtype, tokens.dim(), tokens.is_contiguous(), tokens.shape[1:] in _ROWS,
            prefixes.dtype, prefixes.shape[1:], prefixes.is_contiguous(), prefixes.get_device(),
            prefix_lens.dtype, prefix_lens.shape, prefix_lens.is_contiguous(),
            prefix_lens.get_device()) != (
                torch.uint8, 2, True, True, torch.uint8, tokens.shape[1:], True, dev,
                torch.int32, prefixes.shape[:1], True, dev):
        tokens, prefixes, prefix_lens = _coerce(tokens, prefixes, prefix_lens)
    tp, pp = tokens.data_ptr(), prefixes.data_ptr()
    if (tp | pp) % 16:
        raise ValueError("prefix_search: tokens and prefixes must be 16-byte aligned")
    N, L = tokens.shape
    Q = prefixes.shape[0]
    out = torch.empty((N, Q), dtype=torch.bool, device=tokens.device)
    if N == 0 or Q == 0:
        return out
    fn, stream, n_sm = _launcher(), build.stream_of(tokens), build.sm_count(dev)
    lp, op = prefix_lens.data_ptr(), out.data_ptr()
    for q0 in range(0, Q, Q_CHUNK):
        nq = min(Q_CHUNK, Q - q0)
        blocks, _, smem = search_geometry(N, L, nq, n_sm)
        rc = fn(_PACK(tp, N, L, pp + q0 * L, lp + 4 * q0, nq, op + q0, Q, blocks, smem,
                      stream))
        build.check("prefix_search", rc)
        build.count_launch("prefix_search")
    return out
