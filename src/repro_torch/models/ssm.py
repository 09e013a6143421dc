"""Selective SSM (Mamba) block, jamba's sub-quadratic layer: port of
``repro/models/ssm.py``.

The diagonal linear recurrence
  h_t = exp(Δ_t A) ⊙ h_{t−1} + Δ_t B_t x_t,   y_t = h_t · C_t + D ⊙ x_t
is computed with plain PyTorch ops on both devices, as the JAX package
computes it outside Pallas (``lax.associative_scan``).  The time axis is
cut into chunks of ``SCAN_CHUNK`` steps: a chunk's decays exp(Δ A) and
inputs Δ B x are (B, T, Din, N), and a sequential loop writes each step's
state into the chunk's buffer in place (one ``addcmul_`` a step), so no
(B, S, Din, N) tensor is ever held (2.15 GB at jamba's width and S =
4096) and no exp of a positive sum is taken (Δ > 0, A < 0).  The state
carried into a chunk is folded into its first step as the reference folds
``h0``.

Which path runs when: with grad off (inference, prefill, decode) the loop
runs as it is (``_scan``).  Under grad, with an input that requires grad,
the scan goes through ``_SelectiveScan``, an autograd Function in plain
torch ops: its forward is the same loop with grad off, keeping only its
inputs and each chunk's entry state (B, Din, N); its backward walks the
chunks in reverse, recomputes a chunk's states from its entry state and
runs the adjoint recurrence backwards in time, so training holds one
chunk's (B, T, Din, N) buffers at a time, where autograd over the loop
would keep every step's state and decay of every layer.

Decode carries O(1) state per layer: (conv window (B, d_conv−1, Din),
ssm state (B, Din, N)), both float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _dtype, dense_init

SCAN_CHUNK = 256


def _fixed_leaves(Din: int, N: int, dtype: torch.dtype, device) -> dict:
    """The leaves no generator draws, bit for bit JAX's."""
    dt_bias = np.log(np.expm1(np.linspace(1e-3, 1e-1, Din))).astype(np.float32)
    # A: negative-real diagonal (S4D-real init), stored as log(−A)
    a = np.tile(np.arange(1, N + 1, dtype=np.float32)[None, :], (Din, 1))
    return {"conv_b": torch.zeros((Din,), dtype=dtype, device=device),
            "dt_bias": torch.from_numpy(dt_bias).to(device=device, dtype=dtype),
            "A_log": torch.from_numpy(np.log(a)).to(device),
            "D_skip": torch.ones((Din,), dtype=torch.float32, device=device)}


def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's tree and dtypes: ``A_log`` and ``D_skip`` float32,
    the rest ``param_dtype``; the random leaves are drawn from ``gen``
    with the reference's scales."""
    D = cfg.d_model
    Din = cfg.ssm_expand * D
    N = cfg.d_state
    dt = _dtype(cfg.param_dtype)
    params = {"w_in": dense_init(gen, D, 2 * Din, cfg),
              "w_out": dense_init(gen, Din, D, cfg)}
    # depthwise causal conv over the inner channels
    conv = torch.randn((cfg.d_conv, Din), generator=gen, dtype=torch.float32, device=gen.device)
    params["conv_w"] = (conv / np.sqrt(cfg.d_conv)).to(dt)
    # data-dependent Δ, B, C projections
    params["w_bc"] = dense_init(gen, Din, 2 * N, cfg)
    params["w_dt"] = dense_init(gen, Din, Din, cfg, scale=0.01)
    params.update(_fixed_leaves(Din, N, dt, gen.device))
    return params


def _chunk_states(u, dt, B, A, h, sl):
    """One chunk's decays exp(Δ A) and states (B, T, Din, N) from the
    state ``h`` carried into it (None: the zero state, nothing folded)."""
    dA = torch.exp(dt[:, sl, :, None] * A)                 # (B, T, Din, N)
    # Δ B x, overwritten step by step with the states
    hs = (dt[:, sl] * u[:, sl])[..., None] * B[:, sl, None, :]
    for h_t, dA_t in zip(hs.unbind(1), dA.unbind(1)):
        if h is not None:
            h_t.addcmul_(dA_t, h)
        h = h_t
    return dA, hs


def _scan(u, dt, B, C, A, h0, chunk, entries=None):
    """The chunk loop: (Σ_n h_t C_t (B, S, Din), h_last (B, Din, N)); the
    state entering each chunk is appended to ``entries`` when given."""
    S = u.shape[1]
    h = h0
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        if entries is not None:
            entries.append(h)
        hs = _chunk_states(u, dt, B, A, h, sl)[1]
        ys.append(torch.einsum("btdn,btn->btd", hs, C[:, sl]))
        h = hs[:, -1].clone()                              # let the chunk's buffer go
        del hs
    return (torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]), h


class _SelectiveScan(torch.autograd.Function):
    """The scan under grad: ``(u, dt, B, C, A, h0, chunk) -> (Σ_n h C,
    h_last)``, A = −exp(A_log) (Din, N) taken outside."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, h0, chunk):
        entries = []
        y, h_last = _scan(u, dt, B, C, A, h0, chunk, entries)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.save_for_backward(u, dt, B, C, A, *[e for e in entries if e is not None])
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        u, dt, B, C, A, *entries = ctx.saved_tensors
        if not ctx.has_h0:
            entries = [None] + entries
        S, chunk = u.shape[1], ctx.chunk
        d_dtu, d_logdA, dB, dC = (torch.empty_like(t) for t in (u, u, B, C))
        dA = torch.zeros_like(A)
        carry = dh_last         # dL/dh at a chunk's last step from what follows it
        for j in reversed(range(len(entries))):
            sl = slice(j * chunk, min((j + 1) * chunk, S))
            h_in = entries[j]
            decay, hs = _chunk_states(u, dt, B, A, h_in, sl)
            dC[:, sl] = torch.einsum("btdn,btd->btn", hs, dy[:, sl])
            # dh_t = dy_t C_t + exp(Δ_{t+1} A) dh_{t+1}, backwards in time
            g = dy[:, sl, :, None] * C[:, sl, None, :]
            g[:, -1] += carry
            for t in range(g.shape[1] - 2, -1, -1):
                g[:, t].addcmul_(decay[:, t + 1], g[:, t + 1])
            carry = decay[:, 0] * g[:, 0] if h_in is not None else None
            # dL/d(Δ_t A) = dh_t ⊙ h_{t−1} ⊙ exp(Δ_t A), h_{−1} the entry state
            decay.mul_(g)
            decay[:, 1:].mul_(hs[:, :-1])
            if h_in is not None:
                decay[:, 0].mul_(h_in)
            else:
                decay[:, 0].zero_()
            dA += torch.einsum("btdn,btd->dn", decay, dt[:, sl])
            d_logdA[:, sl] = torch.einsum("btdn,dn->btd", decay, A)
            del decay, hs
            # d(Δ_t B_t x_t) = dh_t
            d_dtu[:, sl] = torch.einsum("btdn,btn->btd", g, B[:, sl])
            dB[:, sl] = torch.einsum("btdn,btd->btn", g, dt[:, sl] * u[:, sl])
            del g
        du = d_dtu * dt
        ddt = d_logdA + d_dtu * u
        dh0 = carry if ctx.has_h0 else None
        return du, ddt, dB, dC, dA, dh0, None


def _ssm_core(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
              A_log: torch.Tensor, D_skip: torch.Tensor, h0: torch.Tensor | None = None,
              chunk: int = SCAN_CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (B, S, Din); B, C: (B, S, N); all float32.
    Returns (y (B, S, Din), h_last (B, Din, N))."""
    A = -torch.exp(A_log)                                  # (Din, N)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (u, dt, B, C, A, h0)):
        y, h = _SelectiveScan.apply(u, dt, B, C, A, h0, chunk)
    else:
        y, h = _scan(u, dt, B, C, A, h0, chunk)
    return y + u * D_skip, h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def ssm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              conv_state: torch.Tensor | None = None,
              ssm_state: torch.Tensor | None = None,
              return_state: bool = False):
    """Full-sequence apply.  x: (B, S, D)."""
    Bsz, S, D = x.shape
    Din = cfg.ssm_expand * D
    xz = x @ params["w_in"]
    u, z = xz.chunk(2, dim=-1)                             # (B, S, Din) each
    # causal depthwise conv (width d_conv)
    pad = cfg.d_conv - 1
    if conv_state is not None:
        u_pad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    else:
        u_pad = F.pad(u, (0, 0, pad, 0))
    windows = torch.stack([u_pad[:, i:i + S, :] for i in range(cfg.d_conv)], dim=2)
    u_conv = torch.einsum("bskd,kd->bsd", windows, params["conv_w"]) + params["conv_b"]
    del windows
    u_conv = F.silu(u_conv.float()).to(x.dtype)
    # data-dependent SSM parameters
    Bm, Cm = (u_conv @ params["w_bc"]).float().chunk(2, dim=-1)     # (B, S, N)
    dt = _softplus((u_conv @ params["w_dt"]).float() + params["dt_bias"].float())
    y, h_last = _ssm_core(u_conv.float(), dt, Bm, Cm, params["A_log"], params["D_skip"],
                          h0=ssm_state)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["w_out"]
    if return_state:
        new_conv = (u_pad[:, -pad:, :] if pad > 0
                    else torch.zeros((Bsz, 0, Din), dtype=x.dtype, device=x.device))
        return out, (new_conv.float(), h_last)
    return out


def ssm_state_init(cfg: ModelConfig, batch: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    Din = cfg.ssm_expand * cfg.d_model
    return (torch.zeros((batch, cfg.d_conv - 1, Din), dtype=torch.float32, device=device),
            torch.zeros((batch, Din, cfg.d_state), dtype=torch.float32, device=device))


def ssm_decode(params: dict, x: torch.Tensor, state, cfg: ModelConfig):
    """One-token decode: x (B, 1, D); state = (conv (B, d_conv-1, Din),
    h (B, Din, N)).  Returns (out, new state); O(1) work per step."""
    return ssm_apply(params, x, cfg, conv_state=state[0], ssm_state=state[1],
                     return_state=True)
