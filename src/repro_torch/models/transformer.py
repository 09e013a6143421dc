"""LM assembly (port of ``repro/models/transformer.py``): the full-sequence
forward (``hidden_states``, ``forward``, ``loss_fn``) and the decode step.

The port runs the ``"attn"`` block kind (GQA, optional qk-norm, RMSNorm
or OLMo's non-parametric LN) with a dense gated-MLP or a MoE FFN per
slot (``_slot_is_moe``), and the unrolled dense prefix layers of kimi:
wikikv-router, qwen3, olmo, granite, codeqwen, dbrx and kimi-k2.
Parameters keep the JAX tree: per-slot leaves are stacked over periods on
axis 0 (``params["body"]["slot{i}"]``) and the dense prefix is the list
``params["prefix"]``, so the JAX parameter pytree moves over leaf by leaf
(``repro_torch.bridge``).  A plain loop over periods takes the place of
``lax.scan``; there is no remat, because the forward runs for inference
(callers wrap it in ``torch.inference_mode()``) and the backward comes
with the training slice.  Decode state is stacked the same way (the
prefix's as a list) and updated in place.

Other families wait for later slices: SSM and xLSTM blocks, the
encoder-decoder and the vision stub raise ``NotImplementedError`` naming
their slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from . import moe as MoE
from .config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    bad = sorted({k for k in cfg.block_pattern if k != "attn"})
    if {"mlstm", "slstm"} & set(bad):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} come with the xLSTM families slice of the port")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} come with the SSM (mamba) families slice of "
            "the port")
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision/audio stubs come with the "
            "enc-dec and vision slice of the port")


def _slot_is_moe(cfg: ModelConfig, slot: int) -> bool:
    if cfg.moe is None or cfg.moe_every <= 0:
        return False
    return slot % cfg.moe_every == (cfg.moe_every - 1) % cfg.moe_every


def _slot_init(gen: torch.Generator, cfg: ModelConfig, is_moe: bool) -> dict:
    params = {"norm1": L.norm_init(gen, cfg), "attn": L.attn_init(gen, cfg),
              "norm2": L.norm_init(gen, cfg)}
    if is_moe:
        params["moe"] = MoE.moe_init(gen, cfg)
    else:
        params["mlp"] = L.mlp_init(gen, cfg)
    return params


def _stacked(make, n: int) -> dict:
    """``make()`` called ``n`` times, the leaves stacked on a leading axis.
    Each tree is written into its row as soon as it is made, so the stack
    is never held twice (dbrx's 8 layers are 52 GB)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i] = src
    stacked = None
    for i in range(n):
        tree = make()
        if stacked is None:
            stacked = alloc(tree)
        put(stacked, tree, i)
        del tree
    return stacked


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters from ``gen``, every leaf drawn on the generator's
    device: a CPU generator gives the same numbers on every device, a CUDA
    one draws a model too large for the host on the card.  The numbers
    differ from JAX's for the same seed; tests that compare the packages
    bridge the JAX parameters instead."""
    check_supported(cfg)
    dt = getattr(torch, cfg.param_dtype)
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, dtype=torch.float32,
                      device=gen.device)
    params: dict = {"embed": emb.mul_(0.02).to(dt)}
    del emb
    prefix = [_slot_init(gen, cfg, False) for _ in range(cfg.n_dense_prefix)]
    if prefix:
        params["prefix"] = prefix
    params["body"] = {
        f"slot{s_idx}": _stacked(lambda: _slot_init(gen, cfg, _slot_is_moe(cfg, s_idx)),
                                 cfg.n_periods)
        for s_idx, _kind in enumerate(cfg.block_pattern)}
    params["final_norm"] = L.norm_init(gen, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg)
    return params


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums each token's rows in a
    # fixed order on both devices, where indexing's accumulates in any
    # order on the CPU, and a resumed run must repeat an uninterrupted one
    return F.embedding(tokens, params["embed"]).to(getattr(torch, cfg.dtype))


# ---------------------------------------------------------------------------
# forward (prefill / evaluation)
# ---------------------------------------------------------------------------
def _ffn(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "moe" in params:
        return MoE.moe_apply(params["moe"], h, cfg)
    return L.mlp_apply(params["mlp"], h)


def _slot_apply(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence apply of one block."""
    h = L.norm_apply(params["norm1"], x, cfg)
    x = x + L.attn_apply(params["attn"], h, cfg)
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg)


def hidden_states(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Forward up to (but not including) the LM head: (B, S, D)."""
    check_supported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    for p in params.get("prefix", []):
        x = _slot_apply(p, x, cfg)
    for p in range(cfg.n_periods):
        for s_idx, _kind in enumerate(cfg.block_pattern):
            x = _slot_apply(_index(params["body"][f"slot{s_idx}"], p), x, cfg)
    return L.norm_apply(params["final_norm"], x, cfg)


def _head(params: dict, cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(dtype)


def forward(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, V_pad) for ``batch["tokens"]`` (B, S) int."""
    x = hidden_states(params, batch, cfg)
    return x @ _head(params, cfg, x.dtype)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            loss_chunks: int = 8) -> torch.Tensor:
    """Mean next-token cross entropy (0-d f32); labels < 0 are masked.

    The LM head and the CE run in ``loss_chunks`` token chunks (one chunk
    when B * S does not divide), so only one chunk of f32 logits is live
    at a time: qwen3's vocabulary is 151,936."""
    x = hidden_states(params, batch, cfg)
    labels = batch["labels"]
    head = _head(params, cfg, x.dtype)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    lt = labels.reshape(B * S).to(torch.int64)
    n_chunks = loss_chunks if (B * S) % loss_chunks == 0 else 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for x_c, l_c in zip(xt.reshape(n_chunks, -1, D), lt.reshape(n_chunks, -1)):
        logits = (x_c @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, l_c.clamp(min=0)[:, None])[:, 0]
        mask = (l_c >= 0).float()
        total = total + ((lse - ll) * mask).sum()
        count = count + mask.sum()
    return total / count.clamp(min=1.0)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked per-slot KV caches mirroring the body layout:
    ``state["slot{i}"]["k"|"v"]`` is (n_periods, B, KV, max_len, Dh); the
    dense prefix's caches are the list ``state["prefix"]``."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    state = {}
    for s_idx, _kind in enumerate(cfg.block_pattern):
        state[f"slot{s_idx}"] = _stacked(
            lambda: L.attn_cache_init(cfg, batch, max_len, dt, device), cfg.n_periods)
    prefix = [L.attn_cache_init(cfg, batch, max_len, dt, device)
              for _ in range(cfg.n_dense_prefix)]
    if prefix:
        state["prefix"] = prefix
    return state


def _slot_decode(params: dict, x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    h = L.norm_apply(params["norm1"], x, cfg)
    o, _ = L.attn_decode(params["attn"], h, cache, lengths, cfg)
    x = x + o
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg)


def decode_step(params: dict, state: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B,) int — the freshly sampled token;
    lengths: (B,) current context lengths.  Returns (logits (B, V), state);
    the caches in ``state`` are written in place at ``lengths``."""
    x = embed_tokens(params, tokens[:, None], cfg)      # (B, 1, D)
    for p, cache in zip(params.get("prefix", []), state.get("prefix", [])):
        x = _slot_decode(p, x, cache, lengths, cfg)
    for p in range(cfg.n_periods):
        for s_idx, _kind in enumerate(cfg.block_pattern):
            slot = f"slot{s_idx}"
            x = _slot_decode(_index(params["body"][slot], p), x,
                             _index(state[slot], p), lengths, cfg)
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = (x @ _head(params, cfg, x.dtype))[:, 0, :]
    return logits, state
