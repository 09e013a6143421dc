"""xLSTM blocks (mLSTM and sLSTM, arXiv:2405.04517): port of
``repro/models/xlstm.py``.

* **mLSTM** (matrix memory, exponential gating): the chunkwise stabilised
  form over the full sequence, with the reference's chunk
  (``_pick_chunk``): a decay-masked (c × c) product within a chunk and
  the (C, n, m) recurrence across chunks, a Python loop where the
  reference runs ``lax.scan``.  One token with a state (decode) takes
  the recurrent form.  C is stored stabilised (C_true = C·e^m); m starts
  at 0.
* **sLSTM** (scalar memory, normaliser and stabiliser state): a serial
  loop over time, one step at a time (the reference's time blocking
  changes no number).  m starts at ``NEG_INF``, so the first step's
  forget weight exp(−1e30 − i) is 0.

The recurrences run in plain PyTorch ops on both devices, as the JAX
package runs them outside Pallas.  Each block carries its own up and down
projections (the configs' ``d_ff = 0``): the mLSTM a 2× pre-up-projection,
the sLSTM a gated FFN of factor 4/3 after the cell.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _dtype, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    Dp = 2 * D                      # paper: expansion 2 before qkv
    H = cfg.xlstm_heads
    dev = gen.device
    return {
        "w_up": dense_init(gen, D, 2 * Dp, cfg),
        "w_q": dense_init(gen, Dp, Dp, cfg),
        "w_k": dense_init(gen, Dp, Dp, cfg),
        "w_v": dense_init(gen, Dp, Dp, cfg),
        "w_if": dense_init(gen, Dp, 2 * H, cfg, scale=0.02),
        # input gate bias 0, forget gate bias high (3 .. 6); torch's linspace
        # gives jnp.linspace's bits at the configs' 2 and 4 heads, not at
        # every count (8 differs in one element's last bit)
        "if_bias": torch.cat([torch.zeros((H,), dtype=torch.float32, device=dev),
                              torch.linspace(3.0, 6.0, H, dtype=torch.float32, device=dev)]),
        "w_down": dense_init(gen, Dp, D, cfg),
        "skip_scale": torch.ones((Dp,), dtype=_dtype(cfg.param_dtype), device=dev),
    }


def mlstm_chunkwise(q, k, v, log_i, log_f, state, chunk: int = 256):
    """Chunkwise-parallel stabilised mLSTM.

    q/k/v: (B, H, S, Dh) float32; log_i/log_f: (B, H, S); state = (C, n,
    m).  Quadratic work only within a chunk ((B, H, c, c) scores), the
    recurrence across chunks.  Returns (h (B, H, S, Dh), final state)."""
    B, H, S, Dh = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"mlstm_chunkwise: S={S} is not a multiple of the chunk {c}")
    scale = 1.0 / np.sqrt(Dh)
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    C0, n0, m0 = state
    hs = []
    for j in range(0, S, c):
        qk = q[:, :, j:j + c] * scale
        kk, vk = k[:, :, j:j + c], v[:, :, j:j + c]
        li, lf = log_i[..., j:j + c], log_f[..., j:j + c]
        Fc = torch.cumsum(lf, dim=-1)                          # (B, H, c)
        # intra-chunk log decay w_ts = F_t − F_s + li_s, s ≤ t
        logD = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
        logD = torch.where(causal, logD, NEG_INF)
        m_intra = logD.amax(dim=-1)
        m_inter = m0[..., None] + Fc
        m_t = torch.maximum(m_intra, m_inter)
        Dmat = torch.exp(logD - m_t[..., None])                # (B, H, c, c)
        inter_w = torch.exp(m_inter - m_t)                     # (B, H, c)
        sd = (qk @ kk.transpose(-1, -2)) * Dmat
        num = sd @ vk + inter_w[..., None] * (qk @ C0)
        den_vec = sd.sum(dim=-1) + inter_w * (qk @ n0[..., None])[..., 0]
        den = torch.maximum(den_vec.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])
        # carry at the chunk's end (t = c − 1 of the recurrence)
        F_end = Fc[..., -1]
        w = F_end[..., None] - Fc + li
        m_new = torch.maximum(m0 + F_end, w.amax(dim=-1))
        carry_w = torch.exp(w - m_new[..., None])              # (B, H, c)
        decay = torch.exp(m0 + F_end - m_new)
        ck = carry_w[..., None] * kk
        C0 = decay[..., None, None] * C0 + ck.transpose(-1, -2) @ vk
        n0 = decay[..., None] * n0 + ck.sum(dim=-2)
        m0 = m_new
    h = torch.cat(hs, dim=2) if len(hs) > 1 else hs[0]
    return h, (C0, n0, m0)


def _mlstm_recurrent(q, k, v, log_i, log_f, state):
    """Step the matrix memory for S (usually 1) tokens.
    state = (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H))."""
    C, n, m = state
    Dh = q.shape[-1]
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]       # (B, H, Dh)
        li, lf = log_i[:, :, t], log_f[:, :, t]
        m_new = torch.maximum(lf + m, li)
        f_ = torch.exp(lf + m - m_new)[..., None]
        i_ = torch.exp(li - m_new)[..., None]
        kt_s = kt / np.sqrt(Dh)
        C = f_[..., None] * C + i_[..., None] * (kt_s[..., :, None] * vt[..., None, :])
        n = f_ * n + i_ * kt_s
        num = (qt[..., None, :] @ C)[..., 0, :]
        den = torch.maximum((qt * n).sum(dim=-1).abs(), torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def _pick_chunk(S: int) -> int:
    for c in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if S % c == 0:
            return c
    return 1


def mlstm_state_init_raw(B: int, H: int, Dh: int, device):
    return (torch.zeros((B, H, Dh, Dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, Dh), dtype=torch.float32, device=device),
            torch.zeros((B, H), dtype=torch.float32, device=device))


def mlstm_state_init(cfg: ModelConfig, batch: int, device):
    Dp = 2 * cfg.d_model
    return mlstm_state_init_raw(batch, cfg.xlstm_heads, Dp // cfg.xlstm_heads, device)


def mlstm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                state=None, return_state: bool = False):
    B, S, D = x.shape
    H = cfg.xlstm_heads
    xin, z = (x @ params["w_up"]).chunk(2, dim=-1)           # (B, S, Dp)
    Dp = xin.shape[-1]
    Dh = Dp // H

    def heads(w):
        return (xin @ w).reshape(B, S, H, Dh).transpose(1, 2).float()
    q, k, v = heads(params["w_q"]), heads(params["w_k"]), heads(params["w_v"])
    gates = (xin @ params["w_if"]).float() + params["if_bias"]
    log_i = gates[..., :H].transpose(1, 2)                    # (B, H, S), log-space
    log_f = F.logsigmoid(gates[..., H:]).transpose(1, 2)
    if S == 1 and state is not None:
        h, h_last = _mlstm_recurrent(q, k, v, log_i, log_f, state)
    else:
        st = state if state is not None else mlstm_state_init_raw(B, H, Dh, x.device)
        h, h_last = mlstm_chunkwise(q, k, v, log_i, log_f, st, chunk=_pick_chunk(S))
    h = h.transpose(1, 2).reshape(B, S, Dp).to(x.dtype)
    h = h + params["skip_scale"] * xin                        # learnable skip
    out = (h * F.silu(z.float()).to(x.dtype)) @ params["w_down"]
    if return_state:
        return out, h_last
    return out


def mlstm_decode(params, x, state, cfg):
    return mlstm_apply(params, x, cfg, state=state, return_state=True)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_ffn_width(d_model: int) -> int:
    """The post-block FFN's width: 4/3 · D rounded up to a multiple of 128."""
    return -(-int(d_model * 4 / 3) // 128) * 128


def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D = cfg.d_model
    H = cfg.xlstm_heads
    Dh = D // H
    dev = gen.device
    f = slstm_ffn_width(D)
    params = {"w_x": dense_init(gen, D, 4 * D, cfg)}      # fused (z, i, f, o) input projection
    # recurrent weights, block-diagonal over heads: (H, Dh, 4·Dh)
    w_h = torch.randn((H, Dh, 4 * Dh), generator=gen, dtype=torch.float32, device=dev)
    params["w_h"] = (w_h * 0.02).to(_dtype(cfg.param_dtype))
    params["bias"] = torch.cat([torch.zeros((2 * D,), dtype=torch.float32, device=dev),
                                torch.full((D,), 3.0, dtype=torch.float32, device=dev),  # forget
                                torch.zeros((D,), dtype=torch.float32, device=dev)])
    params["w_ff_up"] = dense_init(gen, D, 2 * f, cfg)
    params["w_ff_down"] = dense_init(gen, f, D, cfg)
    return params


def _slstm_scan(xin: torch.Tensor, w_h: torch.Tensor, bias: torch.Tensor, state,
                dtype: torch.dtype):
    """The cell over time.  xin: (B, S, 4D) float32, the input
    projection; the recurrent product runs in ``dtype``.  Returns
    (h over time (B, S, D) float32, final (h, c, n, m))."""
    B, S, D4 = xin.shape
    H, Dh = w_h.shape[0], w_h.shape[1]
    h, c, n, m = state
    hs = []
    for x_t in xin.unbind(1):
        # block-diagonal recurrence: per head (B, Dh) @ (Dh, 4Dh)
        rec = torch.bmm(h.to(dtype).reshape(B, H, Dh).transpose(0, 1), w_h)  # (H, B, 4Dh)
        rec = rec.reshape(H, B, 4, Dh).permute(1, 2, 0, 3).reshape(B, D4)
        pre = x_t + rec.float() + bias
        z, i, f, o = pre.chunk(4, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        lfm = F.logsigmoid(f) + m
        m_new = torch.maximum(lfm, i)
        i_ = torch.exp(i - m_new)
        f_ = torch.exp(lfm - m_new)
        c = f_ * c + i_ * z
        n = f_ * n + i_
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c, n, m)


def slstm_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
                state=None, return_state: bool = False):
    """x: (B, S, D).  A serial loop over time: the normaliser and
    stabiliser recurrence is data-dependent."""
    B, S, D = x.shape
    xin = (x @ params["w_x"]).float()                          # (B, S, 4D)
    if state is None:
        state = slstm_state_init(cfg, B, x.device)
    hs, new_state = _slstm_scan(xin, params["w_h"], params["bias"], state, x.dtype)
    y = hs.to(x.dtype)
    # gated FFN
    a, b = (y @ params["w_ff_up"]).chunk(2, dim=-1)
    y = (F.gelu(a.float(), approximate="tanh") * b.float()).to(x.dtype) @ params["w_ff_down"]
    if return_state:
        return y, new_state
    return y


def slstm_state_init(cfg: ModelConfig, batch: int, device):
    D = cfg.d_model

    def z():
        return torch.zeros((batch, D), dtype=torch.float32, device=device)
    return (z(), z(), z(), torch.full((batch, D), NEG_INF, dtype=torch.float32, device=device))


def slstm_decode(params, x, state, cfg):
    return slstm_apply(params, x, cfg, state=state, return_state=True)
