"""Public model facade (port of ``repro/models/model.py``): ``init_params``,
``make_train_step``, ``make_eval_step``, ``make_prefill_step`` and
``make_serve_step``.

The eval and prefill steps run the full-sequence forward (flash-attention
kernel on the card) under ``torch.inference_mode()``, for every family
``transformer`` runs; the serve step passes ``batch["enc_out"]`` to an
encoder-decoder's decode step.  The train step runs it under grad mode, so
on the card the attention, the norms and the MoE router go through their
autograd Functions and their backward kernels (``kernels.ops``), and the
selective scan through its own Function (``ssm._SelectiveScan``): every
family of the zoo trains, as every family of the JAX package does — the
attention families dense and MoE, jamba (mamba, attention and MoE),
xlstm, whisper's encoder-decoder (``batch["frames"]``) and internvl2's
vision stub (``batch["prefix_embeds"]``, its positions' labels masked).
The sharding helpers and ``mesh`` come with the distribution slice.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..optim.adamw import AdamWConfig, adamw_update
from ..optim.schedule import cosine_schedule
from ..tree import leaves, map_like, unflatten
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


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig):
    """``(loss, grads)``: the 0-d f32 loss of ``transformer.loss_fn`` and
    its gradient for every leaf of ``params`` (the same tree, each grad in
    its parameter's dtype), as ``jax.value_and_grad(T.loss_fn)`` gives
    them, for every family: ``batch`` carries ``frames`` for an
    encoder-decoder and ``prefix_embeds`` for the vision stub, as
    ``transformer.loss_fn`` reads them, and a mamba layer's selective scan
    goes through its autograd Function.  ``params`` are left as they are:
    the gradients are taken through detached leaves, each per-period
    stack of ``params["body"]`` cut into its periods (views), so a
    period's gradient is its own tensor and the stack's is assembled once
    at the end."""

    def leaf(p):
        return p.detach().requires_grad_(True)

    work = map_like(leaf, {k: v for k, v in params.items() if k != "body"})
    work["body"] = map_like(lambda t: [leaf(t[i]) for i in range(t.shape[0])], params["body"])
    flat = leaves(work)
    with torch.enable_grad():
        loss = T.loss_fn(work, batch, cfg)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = unflatten(work, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(flat, grads)])
    grads["body"] = map_like(lambda _, parts: torch.stack(parts), params["body"], grads["body"])
    return loss.detach(), {k: grads[k] for k in params}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, total_steps: int = 10000,
                    warmup: int | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr_scale"})``: the loss and its gradient, the cosine
    schedule's scale at ``opt_state["step"]`` and one AdamW update, with
    the reference's warmup rule.  It returns new trees and leaves its
    arguments as they were.  No remat: the activations of qwen3-1.7B at
    B = 1, S = 4096 fit one card (the JAX body's ``jax.checkpoint``
    changes no number)."""
    L.set_fp32_matmul()
    wu = warmup if warmup is not None else max(1, min(200, total_steps // 20))

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg)
        lr_scale = cosine_schedule(opt_state["step"], warmup=wu, total=total_steps)
        new_params, new_opt = adamw_update(params, grads, opt_state, opt_cfg,
                                           lr_scale=lr_scale)
        return new_params, new_opt, {"loss": loss, "lr_scale": lr_scale}
    return train_step


def make_eval_step(cfg: ModelConfig):
    """``eval_step(params, batch) -> loss`` (0-d f32): the masked mean
    next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 masked); with ``prefix_embeds`` or
    ``frames`` for the vision and audio stubs."""
    L.set_fp32_matmul()

    def eval_step(params, batch):
        with torch.inference_mode():
            return T.loss_fn(params, batch, cfg)
    return eval_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> logits`` (B, S_total, V_pad) over
    ``batch["tokens"]`` (after ``prefix_embeds`` for the vision stub; the
    encoder reads ``frames``)."""
    L.set_fp32_matmul()

    def prefill_step(params, batch):
        with torch.inference_mode():
            return T.forward(params, batch, cfg)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode over the cache: ``serve_step(params, state, batch)
    -> (next_tok (B,) int32, logits (B, V_pad), state)``, greedy over the
    real vocabulary (the padded ids are masked to -inf).  An
    encoder-decoder reads the encoder's output from ``batch["enc_out"]``;
    ``batch["write"]`` (B,) bool, where given, is the lanes whose
    recurrent states take the step (``transformer.decode_step``)."""
    L.set_fp32_matmul()

    def serve_step(params, state, batch):
        logits, state = T.decode_step(params, state, batch["tokens"],
                                      batch["lengths"], cfg, enc_out=batch.get("enc_out"),
                                      write=batch.get("write"))
        # mask vocab-padding ids (embed table is padded to a 256 multiple)
        if cfg.padded_vocab != cfg.vocab:
            valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
            logits = logits.masked_fill(~valid[None, :], float("-inf"))
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, state
    return serve_step
