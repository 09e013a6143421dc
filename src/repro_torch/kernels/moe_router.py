"""Fused MoE router (softmax + top-k gate) on Hopper — CUDA kernel.

Replaces ``repro/kernels/moe_router.py::moe_router`` (Pallas body
``_router_kernel``).  The kernel is ``csrc/moe_router.cu``: a token per
32 / TPW lanes — two tokens a warp (a half-warp each) at E <= 16, the
dbrx and jamba routers, one token a warp above — the token's E
probabilities spread over its lanes' registers (V a lane), the softmax's
max and sum and each of the k selection rounds done by shuffles that stay
within the token's lanes.  Ties go to the lowest expert id, as the TPU
kernel's first-match rule and ``lax.top_k`` order them: each round is an
exact arg-max on (probability, id) pairs.

What bounds it on the card: bytes (T*E*4 read, T*k*8 written), which at
every model shape is under 2 microseconds, so a call costs its launch and
the host work around it.  So the host path is lean: the C entry is bound
once, its arguments go packed in one buffer, the checks are one
comparison, the weights and indices share one allocation, and the
geometry comes from ``router_geometry`` (cached, pure Python).  It takes
any T (the Pallas version asserted T % block_t == 0) and f32 logits;
every model path casts the router logits to f32 first.

``moe_router_bwd`` is the backward kernel (``csrc/moe_router.cu``
``moe_router_bwd_launch``; the JAX package differentiates its jnp
reference, so it replaces no Pallas kernel): one token a warp, the k
chosen (id, weight, gradient) triples on the first k lanes, their dot
product by shuffles, and the E-wide row of the logits' gradient written
coalesced.  Both wrappers refuse an input that requires grad
(``build.refuse_grad``): ``kernels.ops.moe_router`` runs them inside an
autograd Function.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from . import build

MAX_EXPERTS = 1024
MAX_K = 32
WARPS = 8                                 # warps a block (csrc/moe_router.cu)
V_INSTANCES = (1, 2, 4, 8, 12, 16, 24, 32)  # probabilities a lane, compiled
#: a C entry's arguments (csrc/moe_router.cu RouterArgs, RouterBwdArgs:
#: eleven 64-bit fields each), packed in one buffer: ctypes would convert
#: each separate argument on every call
_PACK = struct.Struct("<11q").pack
_FNS: dict = {}


@functools.lru_cache(maxsize=256)
def router_geometry(T: int, E: int) -> tuple[int, int, int]:
    """(tokens a warp, probabilities a lane V, blocks) of one launch over
    ``T`` tokens of ``E`` experts.

    Two tokens a warp (16 lanes each) when E <= 16, else one; V is the
    least compiled instance that holds E over the token's lanes; blocks of
    WARPS warps cover T.  k (<= E <= 16 at two tokens a warp) changes
    nothing here."""
    tpw = 2 if E <= 16 else 1
    need = -(-E // (32 // tpw))
    v = next(v for v in V_INSTANCES if v >= need)
    return tpw, v, -(-T // (WARPS * tpw))


def _entry(name: str):
    """The library's C entry ``name``, bound once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.library("moe_router"), name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def moe_router(logits: torch.Tensor, k: int, *, renormalize: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) float32.  Returns (weights (T, k) float32, indices
    (T, k) int32), two planes of one buffer.  CUDA tensors only;
    E <= MAX_EXPERTS, 1 <= k <= min(E, MAX_K)."""
    if not logits.is_cuda:
        raise ValueError("moe_router kernel: tensors must be on a CUDA device")
    build.refuse_grad("moe_router", logits)
    if (logits.dtype, logits.dim(), logits.is_contiguous()) != (torch.float32, 2, True):
        if logits.dtype != torch.float32 or logits.dim() != 2:
            raise ValueError(f"moe_router: logits must be 2-D float32, got "
                             f"{tuple(logits.shape)} {logits.dtype}")
        logits = logits.contiguous()
    T, E = logits.shape
    if not (1 <= k <= min(E, MAX_K)) or E > MAX_EXPERTS:
        raise ValueError(f"moe_router: unsupported E={E}, k={k}")
    buf = torch.empty((2, T, k), dtype=torch.int32, device=logits.device)
    w, idx = buf.unbind(0)
    w = w.view(torch.float32)
    if T == 0:
        return w, idx
    rc = _entry("moe_router_launch")(_PACK(
        logits.data_ptr(), w.data_ptr(), idx.data_ptr(), T, E, k, renormalize,
        *router_geometry(T, E), build.stream_of(logits)))
    build.check("moe_router", rc)
    build.count_launch("moe_router")
    return w, idx


def moe_router_bwd(logits: torch.Tensor | None, weights: torch.Tensor, idx: torch.Tensor,
                   dweights: torch.Tensor, *, renormalize: bool = True,
                   n_experts: int | None = None) -> torch.Tensor:
    """The logits' gradient (T, E) float32 of ``moe_router`` given the
    weights' gradient ``dweights`` (T, k): ``ref.moe_router_bwd_ref`` in
    one launch.  ``weights`` (T, k) float32 and ``idx`` (T, k) int32 are
    the forward's; ``logits`` (T, E) float32 is read without
    ``renormalize`` and may be None with it, ``n_experts`` then giving E.
    CUDA tensors only; 1 <= k <= min(E, MAX_K), E <= MAX_EXPERTS."""
    if not (weights.is_cuda and idx.is_cuda and dweights.is_cuda):
        raise ValueError("moe_router_bwd kernel: tensors must be on a CUDA device")
    if logits is None:
        if not renormalize or n_experts is None:
            raise ValueError("moe_router_bwd: the logits are needed without renormalize, "
                             "and E (n_experts) without the logits")
        E = n_experts
    else:
        if logits.dtype != torch.float32 or logits.dim() != 2 or not logits.is_cuda:
            raise ValueError(f"moe_router_bwd: logits must be 2-D float32 on the card, got "
                             f"{tuple(logits.shape)} {logits.dtype} on {logits.device}")
        E = logits.shape[1]
    T, k = weights.shape if weights.dim() == 2 else (-1, -1)
    if (weights.dtype, dweights.dtype, idx.dtype) != (torch.float32, torch.float32, torch.int32) \
            or tuple(idx.shape) != (T, k) or tuple(dweights.shape) != (T, k) \
            or (logits is not None and logits.shape[0] != T):
        raise ValueError(f"moe_router_bwd: weights {tuple(weights.shape)} {weights.dtype}, idx "
                         f"{tuple(idx.shape)} {idx.dtype}, dweights {tuple(dweights.shape)} "
                         f"{dweights.dtype}; need (T, k) float32, int32, float32")
    if not (1 <= k <= min(E, MAX_K)) or E > MAX_EXPERTS:
        raise ValueError(f"moe_router_bwd: unsupported E={E}, k={k}")
    build.refuse_grad("moe_router_bwd", logits, weights, dweights)
    weights, idx, dweights = weights.contiguous(), idx.contiguous(), dweights.contiguous()
    dz = torch.empty((T, E), dtype=torch.float32, device=weights.device)
    if T == 0:
        return dz
    lp = 0
    if not renormalize:
        logits = logits.contiguous()
        lp = logits.data_ptr()
    rc = _entry("moe_router_bwd_launch")(_PACK(
        lp, weights.data_ptr(), idx.data_ptr(), dweights.data_ptr(), dz.data_ptr(), T, E, k,
        renormalize, -(-T // WARPS), build.stream_of(weights)))
    build.check("moe_router", rc)
    build.count_launch("moe_router_bwd")
    return dz
