"""Single-token GQA decode attention on Hopper — CUDA kernel, one launch
per call.

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (Pallas
body ``_decode_kernel``).  The kernel is ``csrc/decode_attention.cu``: one
block of up to 16 warps takes one (sequence, KV head) and its whole
query-head group; its warps take the live positions 32 at a time with
(m, l, acc) in registers and the block merges their partials in shared
memory.  Where B*Hkv blocks would leave SMs idle, each (sequence, KV
head) is split over several blocks, and the block that draws the last
ticket of its (sequence, KV head) merges their partials: still one
launch.  The TPU fused that merge by revisiting VMEM scratch in grid
order; Hopper's blocks run in no order, hence the ticket.

What bounds it on the card: bytes (K and V read once, about one flop per
byte); at serving shapes (a few hundred positions, B = 4) the launch path.
So the wrapper is lean: the C entry is bound once and takes its
arguments packed in one buffer, the shapes are checked against one
tuple, ``lengths`` passes without a copy when it is already contiguous
int32, the output is one ``torch.empty_like`` and the launch plan comes
from ``decode_plan`` (cached, pure Python).  Nothing is allocated per
call but the output: the split path's workspace is allocated once per
device and grows.  The wrapper never synchronises, so once a first call
at a shape has made the workspace it can be captured in a CUDA graph.
Blocks past a sequence's length do no work, so the cost follows the live
lengths, not the cache size S.

Scaling follows the TPU kernel (f32 scores times the scale), and the
plain version in ``ref.decode_attention_ref`` does the same.

There is no backward kernel: under grad mode an input that requires
grad raises (``build.refuse_grad``) instead of a detached output.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct

import torch

from . import build
from .build import N_SM

HEAD_DIMS = (16, 32, 64, 112, 128)
GROUPS = (1, 2, 4, 6, 7, 8)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WARPS = 16            # warps a block (the kernel's __launch_bounds__(512))
SMEM_MAX = 48 * 1024      # a block's dynamic shared memory without opting in
BLOCK_CHUNKS = 4          # 32-position chunks a block takes at least, split or not
MIN_WARPS = 8             # warps a block has at least: they share q's staging and the merge
#: the C entry's arguments (csrc/decode_attention.cu DecodeArgs), packed in
#: one buffer: ctypes would convert each separate argument on every call
_PACK = struct.Struct("<13qd3q").pack
_FN = None
#: the split path's workspace on each device: (tickets, partials).  The
#: tickets are int32 counters, zeroed when made or grown, that each launch
#: leaves at 0; the partials are scratch.  They are two buffers, so a
#: launch's partials never land on the tickets of a later launch with more
#: (sequence, KV head) pairs.  One launch at a time uses them, because the
#: port makes every call on the current stream of its one serving thread
#: and launches on one stream run in order: a launch writes each partial
#: before the last block reads it, and leaves every ticket 0 for the next.
#: A CUDA graph captured over the split path keeps these buffers'
#: addresses, so it is replayed before a larger shape grows them.
_WORKSPACE: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, Hkv: int, G: int, S: int, D: int, elt: int, n_sm: int = N_SM
                ) -> tuple[int, int, bool]:
    """(warps, blocks per (sequence, KV head), split) of one launch over a
    cache of S positions, head_dim D, group G, elements of ``elt`` bytes,
    on a card of ``n_sm`` SMs (the wrapper passes the device's count).

    A warp takes 32 positions (a chunk) at a time.  When B*Hkv blocks
    leave SMs idle, each (sequence, KV head) is split over up to
    n_sm // (B*Hkv) blocks (one wave) of at least BLOCK_CHUNKS chunks: a
    block's SM then pulls fewer K/V bytes.  A block has one warp a
    chunk, at least MIN_WARPS (they share q's staging and the merge) and
    at most MAX_WARPS and what fits its partials in SMEM_MAX
    (G*D + warps*G*(D+2) floats).  ``elt`` is part of the key for the
    kernel's instances; the plan is the same for both types."""
    chunks = max(1, -(-S // 32))
    w_cap = max(1, min(MAX_WARPS, (SMEM_MAX // 4 - G * D) // (G * (D + 2))))
    blocks = 1
    if B * Hkv < n_sm:
        blocks = max(1, min(n_sm // (B * Hkv), chunks // BLOCK_CHUNKS))
    per_block = -(-chunks // blocks)
    rounds = -(-per_block // w_cap)            # chunks a warp takes
    return min(w_cap, max(MIN_WARPS, -(-per_block // rounds))), blocks, blocks > 1


def _launcher():
    global _FN
    if _FN is None:
        fn = build.library("decode_attention").decode_attention_launch
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _workspace(q: torch.Tensor, pairs: int, floats: int) -> tuple[int, int]:
    """The device's split workspace: the addresses of at least ``pairs``
    zeroed tickets and of at least ``floats`` float32 partials; each
    buffer at least doubles when it grows."""
    dev = q.get_device()
    tickets, part = _WORKSPACE.get(dev, (None, None))
    if tickets is None or tickets.numel() < pairs:
        tickets = torch.zeros((max(pairs, 2 * tickets.numel() if tickets is not None else 32),),
                              dtype=torch.int32, device=q.device)
    if part is None or part.numel() < floats:
        part = torch.empty((max(floats, 2 * part.numel() if part is not None else 0),),
                           dtype=torch.float32, device=q.device)
    _WORKSPACE[dev] = (tickets, part)
    return tickets.data_ptr(), part.data_ptr()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, sm_scale: float | None = None
                     ) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, S, D), contiguous; lengths: (B,).
    Returns (B, Hq, D) in q.dtype.  CUDA tensors only; float32 or
    bfloat16, D in HEAD_DIMS, Hq/Hkv in GROUPS, any S."""
    if not q.is_cuda:
        raise ValueError("decode_attention kernel: tensors must be on a CUDA device")
    build.refuse_grad("decode_attention", q, k_cache, v_cache,
                      why="decode_attention has no backward kernel (decode is inference only)")
    dt = _DTYPES.get(q.dtype)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be 3-D and the "
                         f"caches {tuple(k_cache.shape)} 4-D")
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    dev = q.get_device()
    if (k_cache.shape[0], k_cache.shape[3], v_cache.shape, lengths.shape, k_cache.dtype,
            v_cache.dtype, k_cache.get_device(), v_cache.get_device(),
            lengths.get_device()) != (B, D, k_cache.shape, (B,), q.dtype, q.dtype, dev, dev, dev):
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)} {k_cache.dtype}, "
                         f"{tuple(v_cache.shape)} {v_cache.dtype} and lengths "
                         f"{tuple(lengths.shape)} on {lengths.device} do not fit q "
                         f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if dt is None or Hkv == 0 or Hq % Hkv or Hq // Hkv not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: unsupported Hq={Hq} Hkv={Hkv} D={D} "
                         f"dtype={q.dtype}; need float32 or bfloat16, D in {HEAD_DIMS}, "
                         f"Hq/Hkv in {GROUPS}")
    kp, vp = k_cache.data_ptr(), v_cache.data_ptr()
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) or (kp | vp) % 16:
        raise ValueError("decode_attention: caches must be contiguous and 16-byte aligned")
    G = Hq // Hkv
    if not q.is_contiguous():
        q = q.contiguous()
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    warps, blocks, _ = decode_plan(B, Hkv, G, S, D, q.element_size(), build.sm_count(dev))
    tickets, part = _workspace(q, B * Hkv, B * Hkv * blocks * G * (D + 2)) \
        if blocks > 1 else (0, 0)
    rc = _launcher()(_PACK(q.data_ptr(), kp, vp, lengths.data_ptr(), out.data_ptr(), tickets,
                           part, B, Hkv, G, S, D, dt, scale, warps, blocks, build.stream_of(q)))
    build.check("decode_attention", rc)
    build.count_launch("decode_attention")
    return out
