"""Blocked online-softmax GQA attention on Hopper — CUDA kernel.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
body ``_flash_kernel``).  The kernel is ``csrc/flash_attention.cu``: one
block per (sequence, query head, query tile) walks the key tiles in a
loop with the running (m, l, acc) in registers; the TPU carried them in
VMEM scratch across a sequential grid dimension.

Semantics are the TPU kernel's: f32 scores times the scale, the finite
-1e30 mask, causal key tiles past a query tile's last visible key skipped,
queries at the last Sq positions (``seq_off = Skv - Sq``), ``l == 0 -> 1``.
Unlike the TPU kernel, Sq and Skv need not be block multiples (ragged
tails are masked in the kernel) and the query-head group Hq / Hkv is any
integer (GQA is index math; no repeated KV).

What bounds it on the card: operations (4·D flops per visible (query,
key) pair).  float32 runs on the CUDA cores in full f32 (no TF32), 64
queries a block.  bfloat16 runs Hopper's warp-specialised body: TMA copies
into a ring of key tiles, both products on wgmma (f32 accumulate, P
rounded to bf16 in registers for the second), 128 queries a block, 192
at head_dim 64 and below (three warpgroups taking turns), or 64 where
``query_tile`` finds the grid too small for the card.  The plain
version it is held against is ``ref.attention_ref``.

Training: ``flash_attention(..., with_lse=True)`` also returns the rows'
log-sum-exp, which ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``,
held against ``ref.attention_bwd_ref``) reads to give dq, dk and dv.  Its
bfloat16 body runs on TMA and wgmma like the forward's, after a pre-pass
that writes delta = rowsum(dO * O): key-tile blocks own dK and dV,
query-tile blocks own dQ, with no float atomics (``bwd_geometry`` has the
launch geometry).  Where a wide group's key-tile blocks would run far
past an SM's share of the grid, the group's heads are split over c of
them, whose f32 partials the last to draw a ticket sums in part order;
it reads q, k, v and dO at their own strides.  float32
runs on the CUDA cores, one launch.  Both take what the forward takes:
Sq > Skv when not causal, where no mask reads the query's offset.
``kernels.ops.attention`` joins the two in an autograd Function; called
directly under grad mode with an input that requires grad, these
wrappers raise rather than return an output autograd cannot see.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple

import torch

from . import build
from .build import N_SM

HEAD_DIMS = (16, 32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64            # the smallest query tile; bounds the grid's y extent
MAX_GRID_Y = 65535
BWD_ROWS = 64           # keys or queries of a backward warpgroup, rows of a streamed tile
#: the backward's C entry arguments (csrc/flash_attention_bwd.cu BwdArgs),
#: packed in one buffer
_BWD_PACK = struct.Struct("<19qd16q").pack
#: a stream's head-split tickets (``build.stream_slot``): the most
#: (sequence, KV head, key block) pairs a split launch may have (a split
#: needs few pairs against the card: the zoo's take at most 64)
TICKETS_A_SLOT = 1024


def query_tile(B: int, Hq: int, Sq: int, n_sm: int = N_SM, *, D: int) -> int:
    """The bf16 body's queries a block at head_dim D.  At D <= 64, 192
    (three consumer warpgroups taking turns: one more warp a scheduler
    hides more of the softmax's latency; whisper-medium's encoder and
    internvl2-1b's prefill) where that grid, B * Hq * ceil(Sq / 192)
    blocks, fills the ``n_sm`` SMs and pads Sq to at most 1/16 more rows
    than tiles of 128 do (whisper's 448 decoder positions: 576 rows
    against 512 keep 128).  Else 128 (two consumer warpgroups) when that
    grid fills the card, else 64 (one warpgroup, twice the blocks: a
    chunked prefill of 128 queries over 16 heads runs 32 blocks, not
    16)."""
    if D <= 64 and B * Hq * -(-Sq // 192) >= n_sm and \
            16 * -(-Sq // 192) * 192 <= 17 * -(-Sq // 128) * 128:
        return 192
    return 128 if B * Hq * -(-Sq // 128) >= n_sm else 64


class BwdGeometry(NamedTuple):
    """The backward's launch: key-tile blocks (``rows`` keys of one KV head
    and ``head_split`` blocks of the same keys, each over its part of the
    group's heads: dK, dV) and query-tile blocks (``rows`` queries of one
    query head: dQ) in one grid, in the order ``dq_first`` says."""
    warpgroups: int          # consumer warpgroups a block (bf16); 0: the f32 body's 256 threads
    rows: int                # keys or queries a block
    key_blocks: int
    query_blocks: int
    key_block_tiles: int     # query tiles the longest key-tile block walks
    query_block_tiles: int   # key tiles the longest query-tile block walks
    dq_first: bool           # the query-tile blocks start first (bf16)
    head_split: int          # key-tile blocks a (sequence, KV head, key tile); 1: unsplit


@functools.lru_cache(maxsize=256)
def bwd_geometry(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, bf16: bool,
                 n_sm: int = N_SM, causal: bool = True) -> BwdGeometry:
    """The backward's blocks on a card of ``n_sm`` SMs.  Tiles of 64 keys
    or queries; the bf16 body puts two consumer warpgroups in a block (128
    rows, sharing the streamed tiles) when that grid fills the card, else
    one.  A key-tile block walks its heads and, for its first keys, every
    query tile (the longest, causal or not); a query-tile block walks the
    key tiles its queries see, all Skv for the last one.  A key-tile block
    costs 4 products a query tile of a head and a query-tile block 3 a key
    tile.  The bf16 body splits the group's G heads over c key-tile blocks
    of the same keys (``head_split``): the least c for which the longest,
    ceil(G / c) heads, costs no more than one SM's share of the whole grid
    (G where none does, and 1 where there are more pairs of keys and KV
    head than a stream's TICKETS_A_SLOT tickets).  Its part p walks the
    heads [p G / c, (p + 1) G / c).  Where a KV head's keys are few
    against the card (internvl2-1b: 2 KV heads, G 7; dbrx-132b: 1024
    keys, G 6) this gives c = 3; qwen3, jamba, kimi-k2 and whisper keep
    c = 1.  The role whose longest block costs more starts first, and
    each role's longest blocks lead it."""
    G = Hq // Hkv
    n_qt, n_kt = -(-Sq // BWD_ROWS), -(-Skv // BWD_ROWS)
    if not bf16:
        return BwdGeometry(0, BWD_ROWS, B * Hkv * n_kt, B * Hq * n_qt, G * n_qt, n_kt, False, 1)
    wg = 2 if B * Hkv * -(-Skv // 128) + B * Hq * -(-Sq // 128) >= n_sm else 1
    rows = wg * BWD_ROWS
    off = Skv - Sq                   # < 0 only when not causal, and then never read
    key_cost = 4 * G * sum(n_qt - (max(0, k0 - off) // BWD_ROWS if causal else 0)
                           for k0 in range(0, Skv, rows))
    query_cost = 3 * sum(-(-(min(Skv, min(Sq, q0 + rows) + off) if causal else Skv) // BWD_ROWS)
                         for q0 in range(0, Sq, rows))
    share = (B * Hkv * key_cost + B * Hq * query_cost) / n_sm
    split = next((c for c in range(1, G + 1) if 4 * -(-G // c) * n_qt <= share), G)
    if B * Hkv * -(-Skv // rows) > TICKETS_A_SLOT:     # more pairs than a stream's tickets
        split = 1
    key_tiles = -(-G // split) * n_qt
    return BwdGeometry(wg, rows, B * Hkv * -(-Skv // rows) * split, B * Hq * -(-Sq // rows),
                       key_tiles, n_kt, 3 * n_kt > 4 * key_tiles, split)


def tile_columns(D: int) -> int:
    """Columns of the bf16 bodies' tiles of rows of D (hopper.cuh
    Atoms::DP): D up to 64, else whole atoms of 64 (128 at D = 112)."""
    return D if D <= 64 else -(-D // 64) * 64


def bwd_workspace_floats(B: int, Hq: int, Sq: int, D: int, geo: BwdGeometry) -> int:
    """The f32 scratch of a bf16 backward call: lse2 and delta a query row,
    padded to whole tiles of 64, then with a head split the dK and dV
    partials of every key-tile block (its ``rows`` keys x 2 x the tile's
    columns)."""
    rows = 2 * B * Hq * -(-Sq // BWD_ROWS) * BWD_ROWS
    if geo.head_split == 1:
        return rows
    return rows + geo.key_blocks * geo.rows * 2 * tile_columns(D)


_FN = None
_BWD = None


def _launcher():
    global _FN
    if _FN is None:
        fn = build.library("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_launcher():
    global _BWD
    if _BWD is None:
        fn = build.library("flash_attention_bwd").flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tma_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(sequence, head, row) element strides of a (B, H, S, D) bf16 tensor
    that a TMA tensor map can read as it is (rows contiguous, every stride
    and the base a positive multiple of 16 bytes), else None.  A dimension
    of one element takes its contiguous stride: it is never stepped."""
    B, H, S, D = t.shape
    if t.stride(3) != 1 and D > 1:
        return None
    dense = (H * S * D, S * D, D)
    st = tuple(dense[i] if t.shape[i] == 1 else t.stride(i) for i in range(3))
    elt = t.element_size()
    if t.data_ptr() % 16 or any(x <= 0 or (x * elt) % 16 for x in st):
        return None
    return st


def _check(q, k, v, long_q: bool = False, on_card: bool = True):
    """Raise for what the kernels do not take; return (B, Hq, Hkv, Sq, Skv, D).
    Sq > Skv only where ``long_q`` allows it (the non-causal forward);
    ``on_card=False`` (the abstract path) leaves the devices unchecked."""
    if on_card and not q.is_cuda:
        raise ValueError("flash_attention kernel: tensors must be on a CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if Sq > Skv and not long_q:
        raise ValueError(f"flash_attention: Sq={Sq} > Skv={Skv}; the queries are the "
                         "last Sq positions of the context (more queries than keys: "
                         "non-causal forward only)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported head_dim {D}; need one of {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "need one of float32, bfloat16")
    if on_card and (k.get_device() != q.get_device() or v.get_device() != q.get_device()):
        raise ValueError("flash_attention: all tensors must be on one device")
    if -(-Sq // BLOCK_Q) > MAX_GRID_Y:
        raise ValueError(f"flash_attention: Sq={Sq} exceeds {BLOCK_Q * MAX_GRID_Y}")
    return B, Hq, Hkv, Sq, Skv, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    with_lse: bool = False):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0, and
    Sq <= Skv when causal (whisper's cross-attention takes more queries
    than keys, non-causal).  Returns (B, Hq, Sq, D) in q.dtype, and with
    ``with_lse`` also the rows' log-sum-exp of the scaled scores,
    (B, Hq, Sq) float32.  CUDA tensors only; float32 or bfloat16 (a
    positive sm_scale), D in HEAD_DIMS, any Sq, Skv and group."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v, long_q=not causal)
    build.refuse_grad("flash_attention", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"flash_attention: bfloat16 takes a positive sm_scale, not {scale}")
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if q.numel() == 0:
        return (out, lse) if with_lse else out
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None,
                     B, Hq, Hkv, Sq, Skv, D, _DTYPES[q.dtype], int(bool(causal)), scale,
                     query_tile(B, Hq, Sq, build.sm_count(q.get_device()), D=D),
                     build.stream_of(q))
    build.check("flash_attention", rc)
    build.count_launch("flash_attention")
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        sm_scale: float | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` given its
    output ``o``, its ``lse`` (``with_lse=True``) and the output's gradient
    ``do``, each in its input's dtype, contiguous.  bfloat16: two launches
    (the delta pre-pass and the body; q, k, v and do at their own strides
    where a tensor map can take them); float32: one.  Either way one count
    in LAUNCHES a call; the shapes the forward takes, more queries than
    keys included when not causal (whisper's cross-attention with a
    decoder longer than its frames)."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v, long_q=not causal)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must be like q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}; need "
                         f"({B}, {Hq}, {Sq}) float32")
    dev = q.get_device()
    if any(t.get_device() != dev for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: all tensors must be on one device")
    build.refuse_grad("flash_attention_bwd", q, k, v, o, do)
    bf16 = q.dtype == torch.bfloat16
    o, lse = _aligned(o), _aligned(lse)
    if bf16:
        # q, k, v and dO (which arrives transposed from layers.attn_apply)
        # are read where they lie when a tensor map can take their strides
        q, k, v, do = (t if tma_strides(t) else _aligned(t) for t in (q, k, v, do))
        strides = [x for t in (q, k, v, do) for x in tma_strides(t)]
    else:
        q, k, v, do = (_aligned(t) for t in (q, k, v, do))
        strides = [0] * 12
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Skv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    geo = bwd_geometry(B, Hq, Hkv, Sq, Skv, bf16, build.sm_count(dev), bool(causal))
    ws = (torch.empty(bwd_workspace_floats(B, Hq, Sq, D, geo), dtype=torch.float32,
                      device=q.device) if bf16 else None)
    tickets = (build.stream_slot("flash_attention_bwd", q, build.stream_of(q), TICKETS_A_SLOT)
               if geo.head_split > 1 else 0)
    rc = _bwd_launcher()(_BWD_PACK(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr() if ws is not None else 0,
        tickets, B, Hq, Hkv, Sq, Skv, D, _DTYPES[q.dtype], int(bool(causal)), scale, geo.rows,
        int(geo.dq_first), geo.head_split, *strides, build.stream_of(q)))
    build.check("flash_attention_bwd", rc)
    build.count_launch("flash_attention_bwd")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the abstract path (``kernels.ops`` on a FakeTensor or a meta tensor): the
# outputs' shapes and dtypes and the work of a call, with no launch, no
# build and no data read
# ---------------------------------------------------------------------------
def flash_attention_abstract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, sm_scale: float | None = None,
                             with_lse: bool = False):
    """``flash_attention``'s output (B, Hq, Sq, D) in q.dtype, and with
    ``with_lse`` its (B, Hq, Sq) float32 log-sum-exp."""
    B, Hq, _, Sq, _, D = _check(q, k, v, long_q=not causal, on_card=False)
    out = q.new_empty((B, Hq, Sq, D))
    return (out, q.new_empty((B, Hq, Sq), dtype=torch.float32)) if with_lse else out


def flash_attention_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, sm_scale: float | None = None,
                         with_lse: bool = False) -> tuple[float, int]:
    """(FLOPs, bytes) of one call.  FLOPs: 2·M·N·K for each of the two
    products (S = q k^T, O = P v) over the whole (Sq, Skv) rectangle of
    every query head, what ``launch/hlo_walk.py`` counts of the jnp
    reference's two dots; a causal call's skipped tiles are not taken off.
    Bytes: q, k and v read once, the output (and the lse) written once."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    lse = 4 * B * Hq * Sq if with_lse else 0
    return 2 * 2.0 * B * Hq * Sq * Skv * D, 2 * build.nbytes(q) + build.nbytes(k, v) + lse


def flash_attention_bwd_abstract(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True, sm_scale: float | None = None):
    """``flash_attention_bwd``'s (dq, dk, dv): like q, k and v."""
    B, Hq, _, Sq, _, _ = _check(q, k, v, long_q=not causal, on_card=False)
    if tuple(o.shape) != tuple(q.shape) or tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def flash_attention_bwd_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, sm_scale: float | None = None
                             ) -> tuple[float, int]:
    """(FLOPs, bytes) of one call.  FLOPs: 2·M·N·K for each of the five
    products the kernel computes (S = q k^T again, dP = dO v^T, dv = P^T
    dO, dq = dS k, dk = dS^T q) over the whole (Sq, Skv) rectangle.
    Bytes: q, k, v, o, lse and dO read once, dq, dk and dv written once."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    return (5 * 2.0 * B * Hq * Sq * Skv * D,
            build.nbytes(q, k, v, o, lse, do) + build.nbytes(q, k, v))
