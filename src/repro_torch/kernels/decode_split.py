"""Decode attention split over a slice of head_dim on Hopper — two CUDA
kernels, one launch each.

Under the reference's "head_dim" cache layout (``models.model.
decode_state_specs``: every arch whose KV heads do not divide over the
"model" ranks) each rank holds columns [r*Dl, (r+1)*Dl) of every head of
the cache, so its cache write is local and decode attention pays one
all-reduce of the partial scores instead (the reference's "(B, H, S) psum
for the Dh-partial logits").  ``decode_attention``'s fused softmax needs a
head's whole vector, so this layout splits it in two around that
all-reduce (``models.layers.attn_decode_head_dim``):

* ``decode_scores``: q (B, Hq, Dl) x K (B, Hkv, S, Dl) -> (B, Hq, S) f32,
  the slice's q . k times the whole head's ``sm_scale``, 0 at positions at
  or past the length;
* ``decode_combine``: the summed scores (B, Hq, S) and V (B, Hkv, S, Dl)
  -> (B, Hq, Dl) in V's dtype: the masked softmax times the V slice.

Both are ``csrc/decode_split.cu``; together they replace, on this layout,
``repro/kernels/decode_attention.py::decode_attention``.  Any Dl up to
128 and any group Hq/Hkv up to 16 (no table of instances), float32 or
bfloat16.  ``decode_combine`` splits a (sequence, KV head) over several
blocks where B*Hkv blocks would leave the card short (``combine_plan``),
the last block of each merging the partials by a ticket, as
``decode_attention`` does, in the same workspace (``decode_attention.
_workspace``: allocated once per device, grown, used by one launch at a
time on the serving thread's stream).  What bounds both on
the card: bytes (the live K or V rows, and the scores).

The plain versions are ``ref.decode_scores_ref`` and
``ref.decode_combine_ref``.  Decode is inference only: an input that
requires grad raises (``build.refuse_grad``).
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from . import build
from .build import N_SM
from .decode_attention import _workspace

MAX_DL = 128              # columns of a slice, at most
MAX_GROUP = 16            # query heads a KV head serves, at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPAN_MIN = 256            # positions a decode_combine block takes at least, split or not
BLOCKS_PER_SM = 4         # decode_combine blocks a SM the split plan aims at
#: the C entries' arguments (csrc/decode_split.cu ScoresArgs, CombineArgs),
#: each packed in one buffer
_PACK_SCORES = struct.Struct("<10qd2q").pack
_PACK_COMBINE = struct.Struct("<14q").pack
_FNS: dict[str, object] = {}


def scores_tile(Dl: int) -> int:
    """Positions (and threads) of a ``decode_scores`` block: its K tile of
    tile x Dl f32 in shared memory stays under 48 KB."""
    return 256 if Dl <= 32 else 128 if Dl <= 64 else 64


@functools.lru_cache(maxsize=256)
def combine_plan(B: int, Hkv: int, S: int, n_sm: int = N_SM) -> int:
    """Blocks a (sequence, KV head) of ``decode_combine`` takes: one when
    B*Hkv blocks give the card's ``n_sm`` SMs BLOCKS_PER_SM each, else up
    to BLOCKS_PER_SM * n_sm // (B*Hkv) of at least SPAN_MIN positions
    each (a block streams its span with dependent loads, so the card
    needs several a SM to cover their latency).  Blocks past a lane's
    length read nothing, so the cost follows the live lengths."""
    target = BLOCKS_PER_SM * n_sm
    if B * Hkv >= target:
        return 1
    return max(1, min(target // (B * Hkv), -(-S // SPAN_MIN)))


def _launcher(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.library("decode_split"), f"{name}_launch")
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_scores(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_scores: q {tuple(q.shape)} must be 3-D and the cache "
                         f"{tuple(k_cache.shape)} 4-D")
    B, Hq, Dl = q.shape
    Hkv = k_cache.shape[1]
    if (k_cache.shape[0], k_cache.shape[3], tuple(lengths.shape), k_cache.dtype) \
            != (B, Dl, (B,), q.dtype):
        raise ValueError(f"decode_scores: cache {tuple(k_cache.shape)} {k_cache.dtype} and "
                         f"lengths {tuple(lengths.shape)} do not fit q {tuple(q.shape)} {q.dtype}")
    if q.dtype not in _DTYPES or Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP \
            or not 1 <= Dl <= MAX_DL:
        raise ValueError(f"decode_scores: unsupported Hq={Hq} Hkv={Hkv} Dl={Dl} "
                         f"dtype={q.dtype}; need float32 or bfloat16, Dl <= {MAX_DL}, "
                         f"Hq/Hkv a whole group of at most {MAX_GROUP}")


def _check_combine(scores: torch.Tensor, v_cache: torch.Tensor, lengths: torch.Tensor) -> None:
    if scores.dim() != 3 or v_cache.dim() != 4:
        raise ValueError(f"decode_combine: scores {tuple(scores.shape)} must be 3-D and the "
                         f"cache {tuple(v_cache.shape)} 4-D")
    B, Hq, S = scores.shape
    Hkv, Dl = v_cache.shape[1], v_cache.shape[3]
    if (v_cache.shape[0], v_cache.shape[2], tuple(lengths.shape), scores.dtype) \
            != (B, S, (B,), torch.float32):
        raise ValueError(f"decode_combine: cache {tuple(v_cache.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not fit float32 scores "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if v_cache.dtype not in _DTYPES or Hkv == 0 or Hq % Hkv or Hq // Hkv > MAX_GROUP \
            or not 1 <= Dl <= MAX_DL:
        raise ValueError(f"decode_combine: unsupported Hq={Hq} Hkv={Hkv} Dl={Dl} "
                         f"dtype={v_cache.dtype}; need float32 or bfloat16, Dl <= {MAX_DL}, "
                         f"Hq/Hkv a whole group of at most {MAX_GROUP}")


def _on_card(name: str, *tensors) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} kernel: tensors must be on a CUDA device")
    if len({t.get_device() for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    build.refuse_grad(name, *tensors, why=f"{name} has no backward kernel (decode is "
                                          "inference only)")


def _lengths32(lengths: torch.Tensor) -> torch.Tensor:
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    return lengths


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor, *,
                  sm_scale: float) -> torch.Tensor:
    """q: (B, Hq, Dl); k_cache: (B, Hkv, S, Dl); lengths: (B,).  Returns
    (B, Hq, S) float32: q . k over the slice times ``sm_scale`` (the whole
    head's), 0 at positions at or past the length.  CUDA tensors only."""
    _on_card("decode_scores", q, k_cache, lengths)
    _check_scores(q, k_cache, lengths)
    B, Hq, Dl = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    q, k_cache, lengths = q.contiguous(), k_cache.contiguous(), _lengths32(lengths)
    out = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out
    rc = _launcher("decode_scores")(_PACK_SCORES(
        q.data_ptr(), k_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, Hkv,
        Hq // Hkv, S, Dl, _DTYPES[q.dtype], float(sm_scale), scores_tile(Dl),
        build.stream_of(q)))
    build.check("decode_split", rc)
    build.count_launch("decode_scores")
    return out


def decode_combine(scores: torch.Tensor, v_cache: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """scores: (B, Hq, S) float32, the slices' sums; v_cache: (B, Hkv, S,
    Dl); lengths: (B,).  Returns (B, Hq, Dl) in v_cache's dtype: the
    softmax of the scores over positions below the length times the V
    slice.  CUDA tensors only."""
    _on_card("decode_combine", scores, v_cache, lengths)
    _check_combine(scores, v_cache, lengths)
    B, Hq, S = scores.shape
    Hkv, Dl = v_cache.shape[1], v_cache.shape[3]
    scores, v_cache, lengths = scores.contiguous(), v_cache.contiguous(), _lengths32(lengths)
    out = torch.empty((B, Hq, Dl), dtype=v_cache.dtype, device=v_cache.device)
    if B == 0 or S == 0:
        return out.zero_()
    G = Hq // Hkv
    nblk = combine_plan(B, Hkv, S, build.sm_count(v_cache.get_device()))
    tickets, part = _workspace(v_cache, B * Hkv, B * Hkv * nblk * G * (Dl + 2)) \
        if nblk > 1 else (0, 0)
    rc = _launcher("decode_combine")(_PACK_COMBINE(
        scores.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), tickets, part,
        B, Hkv, G, S, Dl, _DTYPES[v_cache.dtype], nblk, build.stream_of(v_cache)))
    build.check("decode_split", rc)
    build.count_launch("decode_combine")
    return out


# ---------------------------------------------------------------------------
# the abstract path (``kernels.ops`` on a FakeTensor or a meta tensor)
# ---------------------------------------------------------------------------
def decode_scores_abstract(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor, *,
                           sm_scale: float) -> torch.Tensor:
    """``decode_scores``' output (B, Hq, S) float32."""
    _check_scores(q, k_cache, lengths)
    return q.new_empty((q.shape[0], q.shape[1], k_cache.shape[2]), dtype=torch.float32)


def decode_combine_abstract(scores: torch.Tensor, v_cache: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """``decode_combine``'s output (B, Hq, Dl) in v_cache's dtype."""
    _check_combine(scores, v_cache, lengths)
    return v_cache.new_empty((scores.shape[0], scores.shape[1], v_cache.shape[3]))


def decode_scores_work(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor, *,
                       sm_scale: float) -> tuple[float, int]:
    """(FLOPs, bytes) of one call: 2·B·Hq·S·Dl over the whole padded cache
    (as ``decode_attention_work`` counts it); q, the K slice and the
    lengths read once, the scores written once."""
    B, Hq, Dl = q.shape
    S = k_cache.shape[2]
    return 2.0 * B * Hq * S * Dl, build.nbytes(q, k_cache, lengths) + 4 * B * Hq * S


def decode_combine_work(scores: torch.Tensor, v_cache: torch.Tensor,
                        lengths: torch.Tensor) -> tuple[float, int]:
    """(FLOPs, bytes) of one call: 2·B·Hq·S·Dl for P V; the scores, the V
    slice and the lengths read once, the output written once."""
    B, Hq, S = scores.shape
    Dl = v_cache.shape[3]
    return (2.0 * B * Hq * S * Dl,
            build.nbytes(scores, v_cache, lengths) + B * Hq * Dl * v_cache.element_size())
