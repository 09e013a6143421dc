"""LM assembly for the decode path (port of ``repro/models/transformer.py``).

This slice runs the ``"attn"`` block kind with a dense gated-MLP FFN —
the wikikv-router family (dense GQA, optional qk-norm, RMSNorm or OLMo's
non-parametric LN).  Parameters keep the JAX tree: per-slot leaves are
stacked over periods on axis 0 (``params["body"]["slot{i}"]``), so the
JAX parameter pytree moves over leaf by leaf (``repro_torch.bridge``).
Decode state is stacked the same way and updated in place.

Other families wait for later slices: MoE (``moe_router``), SSM and
xLSTM blocks, the encoder-decoder and the vision stub raise
``NotImplementedError`` naming their slice.  ``forward``/``loss_fn``
need the flash-attention kernel and come with that slice.
"""
from __future__ import annotations

import torch

from . import layers as L
from .config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    if cfg.moe is not None or cfg.moe_every:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks come with the moe_router slice of the port")
    bad = [k for k in cfg.block_pattern if k != "attn"]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(set(bad))} come with the "
            "MoE/SSM/xLSTM families slice of the port")
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision/audio stubs come with the "
            "enc-dec and vision slice of the port")
    if cfg.n_dense_prefix:
        raise NotImplementedError(
            f"{cfg.name}: dense prefix layers come with the moe_router slice of the port")


def _slot_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"norm1": L.norm_init(cfg), "attn": L.attn_init(gen, cfg),
            "norm2": L.norm_init(cfg), "mlp": L.mlp_init(gen, cfg)}


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters from a CPU ``torch.Generator`` (same numbers on
    every device).  The numbers differ from JAX's for the same seed; tests
    that compare the packages bridge the JAX parameters instead."""
    check_supported(cfg)
    dt = getattr(torch, cfg.param_dtype)
    params: dict = {
        "embed": (torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen)
                  * 0.02).to(dt)}
    body = {}
    for s_idx, _kind in enumerate(cfg.block_pattern):
        body[f"slot{s_idx}"] = _stack([_slot_init(gen, cfg)
                                       for _ in range(cfg.n_periods)])
    params["body"] = body
    params["final_norm"] = L.norm_init(cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg)
    return params


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked per-slot KV caches mirroring the body layout:
    ``state["slot{i}"]["k"|"v"]`` is (n_periods, B, KV, max_len, Dh)."""
    check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    state = {}
    for s_idx, _kind in enumerate(cfg.block_pattern):
        per = [L.attn_cache_init(cfg, batch, max_len, dt, device)
               for _ in range(cfg.n_periods)]
        state[f"slot{s_idx}"] = _stack(per)
    return state


def _slot_decode(params: dict, x: torch.Tensor, cache: dict, lengths: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    h = L.norm_apply(params["norm1"], x, cfg)
    o, _ = L.attn_decode(params["attn"], h, cache, lengths, cfg)
    x = x + o
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + L.mlp_apply(params["mlp"], h2)


def decode_step(params: dict, state: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B,) int — the freshly sampled token;
    lengths: (B,) current context lengths.  Returns (logits (B, V), state);
    the caches in ``state`` are written in place at ``lengths``."""
    x = embed_tokens(params, tokens[:, None], cfg)      # (B, 1, D)
    for p in range(cfg.n_periods):
        for s_idx, _kind in enumerate(cfg.block_pattern):
            slot = f"slot{s_idx}"
            x = _slot_decode(_index(params["body"][slot], p), x,
                             _index(state[slot], p), lengths, cfg)
    x = L.norm_apply(params["final_norm"], x, cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(x.dtype))[:, 0, :]
    return logits, state
