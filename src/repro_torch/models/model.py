"""Public model facade for the serving path (port of the serving half of
``repro/models/model.py``): ``init_params`` and ``make_serve_step``.

Training, prefill and the sharding helpers need the flash-attention
kernel or the distribution slice and come later.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``torch.Generator`` seed ``seed``, drawn on
    the CPU and moved to ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    L.set_fp32_matmul()
    gen = torch.Generator().manual_seed(seed)
    return _to(T.init_params(gen, cfg), dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def make_serve_step(cfg: ModelConfig):
    """One-token decode over the cache: ``serve_step(params, state, batch)
    -> (next_tok (B,) int32, logits (B, V_pad), state)``, greedy over the
    real vocabulary (the padded ids are masked to -inf)."""
    T.check_supported(cfg)
    L.set_fp32_matmul()

    def serve_step(params, state, batch):
        logits, state = T.decode_step(params, state, batch["tokens"],
                                      batch["lengths"], cfg)
        # mask vocab-padding ids (embed table is padded to a 256 multiple)
        if cfg.padded_vocab != cfg.vocab:
            valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
            logits = logits.masked_fill(~valid[None, :], float("-inf"))
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, state
    return serve_step
