"""LM assembly (port of ``repro/models/transformer.py``): the full-sequence
forward (``hidden_states``, ``forward``, ``loss_fn``) and the decode step.

The port runs every decoder-only family of the zoo: the ``"attn"`` block
kind (GQA, optional qk-norm, RMSNorm or OLMo's non-parametric LN), the
selective SSM (``"mamba"``, ``models/ssm.py``) and the xLSTM blocks
(``"mlstm"``, ``"slstm"``, ``models/xlstm.py``).  ``"attn"`` and
``"mamba"`` slots carry a dense gated-MLP or a MoE FFN (``_slot_is_moe``);
the xLSTM blocks carry their own.  Kimi's dense prefix layers are
unrolled.  So wikikv-router, qwen3, olmo, granite, codeqwen, dbrx,
kimi-k2, jamba (mamba, attention and MoE) and xlstm run.
Parameters keep the JAX tree: per-slot leaves are stacked over periods on
axis 0 (``params["body"]["slot{i}"]``) and the dense prefix is the list
``params["prefix"]``, so the JAX parameter pytree moves over leaf by leaf
(``repro_torch.bridge``).  A plain loop over periods takes the place of
``lax.scan``; there is no remat, because the forward runs for inference
(callers wrap it in ``torch.inference_mode()``) and the backward of the
attention families lives in ``models/model.py``.  Decode state is stacked
the same way (the prefix's as a list): a KV cache ``{"k", "v"}`` for an
attention slot, a tuple of recurrent tensors for the others, each written
in place in its period's row.

The encoder-decoder and the vision/audio stubs wait for the enc-dec and
vision slice and raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from . import moe as MoE
from . import ssm as SSM
from . import xlstm as X
from .config import ModelConfig

RECURRENT_KINDS = ("mamba", "mlstm", "slstm")


def recurrent_kinds(cfg: ModelConfig) -> list[str]:
    """The block kinds of ``cfg`` that carry a recurrent state."""
    return sorted(set(cfg.block_pattern) & set(RECURRENT_KINDS))


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and vision/audio stubs come with the "
            "enc-dec and vision slice of the port")


def _slot_is_moe(cfg: ModelConfig, slot: int) -> bool:
    if cfg.moe is None or cfg.moe_every <= 0:
        return False
    return slot % cfg.moe_every == (cfg.moe_every - 1) % cfg.moe_every


# block kind -> (its params' key in a slot, init, full-sequence apply,
# one-token decode of a recurrent block, decode state init
# (cfg, batch, max_len, device))
_BLOCKS = {"attn": ("attn", L.attn_init, L.attn_apply, None,
                    lambda cfg, b, n, dev: L.attn_cache_init(cfg, b, n, getattr(torch, cfg.dtype),
                                                             dev)),
           "mamba": ("ssm", SSM.ssm_init, SSM.ssm_apply, SSM.ssm_decode,
                     lambda cfg, b, n, dev: SSM.ssm_state_init(cfg, b, dev)),
           "mlstm": ("mlstm", X.mlstm_init, X.mlstm_apply, X.mlstm_decode,
                     lambda cfg, b, n, dev: X.mlstm_state_init(cfg, b, dev)),
           "slstm": ("slstm", X.slstm_init, X.slstm_apply, X.slstm_decode,
                     lambda cfg, b, n, dev: X.slstm_state_init(cfg, b, dev))}


def _slot_init(gen: torch.Generator, cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    name, init = _BLOCKS[kind][:2]
    params = {"norm1": L.norm_init(gen, cfg), name: init(gen, cfg)}
    if kind in ("attn", "mamba"):        # the xLSTM blocks carry their own FFN
        params["norm2"] = L.norm_init(gen, cfg)
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
        if isinstance(t, tuple):
            return tuple(alloc(v) for v in t)
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        elif isinstance(src, tuple):
            for d, s_ in zip(dst, src):
                put(d, s_, i)
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
    prefix = [_slot_init(gen, cfg, "attn", False) for _ in range(cfg.n_dense_prefix)]
    if prefix:
        params["prefix"] = prefix
    params["body"] = {
        f"slot{s_idx}": _stacked(lambda: _slot_init(gen, cfg, kind, _slot_is_moe(cfg, s_idx)),
                                 cfg.n_periods)
        for s_idx, kind in enumerate(cfg.block_pattern)}
    params["final_norm"] = L.norm_init(gen, cfg)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab, cfg)
    return params


def _index(tree, i: int):
    """Row ``i`` of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
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


def _slot_apply(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence apply of one block."""
    name, _, apply = _BLOCKS[kind][:3]
    h = L.norm_apply(params["norm1"], x, cfg)
    x = x + apply(params[name], h, cfg)
    if "norm2" not in params:
        return x
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg)


def hidden_states(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Forward up to (but not including) the LM head: (B, S, D)."""
    check_supported(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    for p in params.get("prefix", []):
        x = _slot_apply("attn", p, x, cfg)
    for p in range(cfg.n_periods):
        for s_idx, kind in enumerate(cfg.block_pattern):
            x = _slot_apply(kind, _index(params["body"][f"slot{s_idx}"], p), x, cfg)
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
def _state_init(kind: str, cfg: ModelConfig, batch: int, max_len: int, device):
    return _BLOCKS[kind][4](cfg, batch, max_len, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Stacked per-slot decode states mirroring the body layout, each
    leaf with a leading period axis: an attention slot's KV cache
    ``{"k", "v"}`` (n_periods, B, KV, max_len, Dh) in ``cfg.dtype``; a
    mamba slot's ``(conv (P, B, d_conv-1, Din), h (P, B, Din, N))``, an
    mLSTM's ``(C, n, m)`` and an sLSTM's ``(h, c, n, m)``, all float32.
    The dense prefix's caches are the list ``state["prefix"]``."""
    check_supported(cfg)
    state = {f"slot{s_idx}": _stacked(lambda: _state_init(kind, cfg, batch, max_len, device),
                                      cfg.n_periods)
             for s_idx, kind in enumerate(cfg.block_pattern)}
    prefix = [_state_init("attn", cfg, batch, max_len, device)
              for _ in range(cfg.n_dense_prefix)]
    if prefix:
        state["prefix"] = prefix
    return state


def _slot_decode(kind: str, params: dict, x: torch.Tensor, state, lengths: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One token through one block; ``state`` (a KV cache, or the views
    of a recurrent state's period row) is written in place."""
    h = L.norm_apply(params["norm1"], x, cfg)
    if kind == "attn":
        o, _ = L.attn_decode(params["attn"], h, state, lengths, cfg)
    else:
        name, _, _, decode = _BLOCKS[kind][:4]
        o, new = decode(params[name], h, state, cfg)
        for dst, src in zip(state, new):
            dst.copy_(src)
    x = x + o
    if "norm2" not in params:
        return x
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg)


def decode_step(params: dict, state: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B,) int — the freshly sampled token;
    lengths: (B,) current context lengths.  Returns (logits (B, V), state);
    the caches in ``state`` are written in place at ``lengths``, the
    recurrent states in place in their period's row."""
    x = embed_tokens(params, tokens[:, None], cfg)      # (B, 1, D)
    for p, cache in zip(params.get("prefix", []), state.get("prefix", [])):
        x = _slot_decode("attn", p, x, cache, lengths, cfg)
    for p in range(cfg.n_periods):
        for s_idx, kind in enumerate(cfg.block_pattern):
            slot = f"slot{s_idx}"
            x = _slot_decode(kind, _index(params["body"][slot], p), x,
                             _index(state[slot], p), lengths, cfg)
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = (x @ _head(params, cfg, x.dtype))[:, 0, :]
    return logits, state
