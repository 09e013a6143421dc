"""Public model facade (port of ``repro/models/model.py``): ``init_params``,
``make_eval_step``, ``make_prefill_step`` and ``make_serve_step``.

The eval and prefill steps run the full-sequence forward (flash-attention
kernel on the card) under ``torch.inference_mode()``.  Training and the
sharding helpers come with the training and distribution slices.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from ``torch.Generator`` seed ``seed``, drawn on
    the CPU and moved to ``device`` (``cuda`` unless given).  A model too
    large for the host is drawn on the card by ``transformer.init_params``
    with a CUDA generator."""
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


def make_eval_step(cfg: ModelConfig):
    """``eval_step(params, batch) -> loss`` (0-d f32): the masked mean
    next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 masked)."""
    T.check_supported(cfg)
    L.set_fp32_matmul()

    def eval_step(params, batch):
        with torch.inference_mode():
            return T.loss_fn(params, batch, cfg)
    return eval_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits`` (B, S, V_pad) over
    ``batch["tokens"]``."""
    T.check_supported(cfg)
    L.set_fp32_matmul()

    def prefill_step(params, batch):
        with torch.inference_mode():
            return T.forward(params, batch, cfg)
    return prefill_step


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
