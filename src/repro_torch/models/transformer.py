"""LM assembly (port of ``repro/models/transformer.py``): the full-sequence
forward (``hidden_states``, ``forward``, ``loss_fn``) and the decode step.

The port runs every family of the zoo: the ``"attn"`` block
kind (GQA, optional qk-norm, RMSNorm or OLMo's non-parametric LN), the
selective SSM (``"mamba"``, ``models/ssm.py``) and the xLSTM blocks
(``"mlstm"``, ``"slstm"``, ``models/xlstm.py``).  ``"attn"`` and
``"mamba"`` slots carry a dense gated-MLP or a MoE FFN (``_slot_is_moe``);
the xLSTM blocks carry their own.  Kimi's dense prefix layers are
unrolled.  whisper's encoder-decoder runs its frames through a stack of
non-causal attention blocks (``params["enc_body"]``), normed by the
shared final norm, and its decoder blocks add a cross-attention over
that output after the mixer (``norm_x``, ``cross``); internvl2's patch
embeddings are prepended to the text.  So wikikv-router and the ten
configs of the zoo run: qwen3, olmo, granite, codeqwen, dbrx, kimi-k2,
jamba (mamba, attention and MoE), xlstm, whisper and internvl2.
Parameters keep the JAX tree: per-slot leaves are stacked over periods on
axis 0 (``params["body"]["slot{i}"]``) and the dense prefix is the list
``params["prefix"]``, so the JAX parameter pytree moves over leaf by leaf
(``repro_torch.bridge``).  A plain loop over periods takes the place of
``lax.scan``; there is no remat, because the forward runs for inference
(callers wrap it in ``torch.inference_mode()``) and the backward of the
attention families lives in ``models/model.py``.  Decode state is stacked
the same way (the prefix's as a list): a KV cache ``{"k", "v"}`` for an
attention slot, a tuple of recurrent tensors for the others, each written
in place in its period's row.  A decode step takes the encoder's output
(``enc_out``) and recomputes the cross-attention's keys and values from
it, as the reference does; it has no input for the vision prefix, as the
reference's has none.
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


def _slot_init(gen: torch.Generator, cfg: ModelConfig, kind: str, is_moe: bool,
               with_cross: bool = False) -> dict:
    name, init = _BLOCKS[kind][:2]
    params = {"norm1": L.norm_init(gen, cfg), name: init(gen, cfg)}
    if with_cross:                       # a decoder block of an encoder-decoder
        params["norm_x"] = L.norm_init(gen, cfg)
        params["cross"] = L.cross_attn_init(gen, cfg)
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
    is never held twice (dbrx's 8 layers are 52 GB); one period's leaves
    are viewed with a leading axis of 1, not copied (kimi-k2's one MoE
    layer holds 33.8 GB of experts)."""
    if n == 1:
        def view(t):
            if isinstance(t, dict):
                return {k: view(v) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(view(v) for v in t)
            return t.unsqueeze(0)
        return view(make())

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
    bridge the JAX parameters instead.  An encoder-decoder adds
    ``enc_body = {"slot0": ...}``, one attention slot stacked
    ``n_enc_layers`` times, and its decoder slots carry the cross-attention."""
    dt = getattr(torch, cfg.param_dtype)
    emb = torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen, dtype=torch.float32,
                      device=gen.device)
    params: dict = {"embed": emb.mul_(0.02).to(dt)}
    del emb
    prefix = [_slot_init(gen, cfg, "attn", False) for _ in range(cfg.n_dense_prefix)]
    if prefix:
        params["prefix"] = prefix
    params["body"] = {
        f"slot{s_idx}": _stacked(lambda: _slot_init(gen, cfg, kind, _slot_is_moe(cfg, s_idx),
                                                    with_cross=cfg.is_encdec),
                                 cfg.n_periods)
        for s_idx, kind in enumerate(cfg.block_pattern)}
    if cfg.is_encdec:
        params["enc_body"] = {"slot0": _stacked(lambda: _slot_init(gen, cfg, "attn", False),
                                                cfg.n_enc_layers)}
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
def _ffn(params: dict, h: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    if "moe" in params:
        return MoE.moe_apply(params["moe"], h, cfg, mesh=mesh)
    return L.mlp_apply(params["mlp"], h)


def _cross(params: dict, x: torch.Tensor, enc_out, cfg: ModelConfig) -> torch.Tensor:
    """A decoder block's cross-attention branch, after the mixer."""
    if "cross" not in params or enc_out is None:
        return x
    hx = L.norm_apply(params["norm_x"], x, cfg)
    return x + L.cross_attn_apply(params["cross"], hx, enc_out, cfg)


def _slot_apply(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                enc_out=None, mesh=None) -> torch.Tensor:
    """Full-sequence apply of one block.  An attention block of an
    encoder-decoder is causal exactly when it is given the encoder's
    output: the encoder's own blocks run non-causal."""
    name, _, apply = _BLOCKS[kind][:3]
    h = L.norm_apply(params["norm1"], x, cfg)
    kw = {"causal": not cfg.is_encdec or enc_out is not None} if kind == "attn" else {}
    x = _cross(params, x + apply(params[name], h, cfg, **kw), enc_out, cfg)
    if "norm2" not in params:
        return x
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg, mesh)


def _encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's output (B, Se, D): ``frames`` (B, Se, D) through the
    non-causal ``enc_body``, normed by the shared ``final_norm``.  A decode
    step takes it as ``enc_out``."""
    e = frames.to(getattr(torch, cfg.dtype))
    for p in range(cfg.n_enc_layers):
        e = _slot_apply("attn", _index(params["enc_body"]["slot0"], p), e, cfg)
    return L.norm_apply(params["final_norm"], e, cfg)


def hidden_states(params: dict, batch: dict, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Forward up to (but not including) the LM head: (B, S_total, D).

    ``batch`` holds ``tokens`` (B, S) int; for the vision stub also
    ``prefix_embeds`` (B, Np, D), prepended (S_total = Np + S); for an
    encoder-decoder ``frames`` (B, Se, D), the encoder's input.  On a
    ``mesh`` the batch is this rank's (``split_batch``) and the MoE layers
    run expert-parallel (``moe.moe_apply``)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend == "vision_stub":
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    enc_out = _encode(params, batch["frames"], cfg) if cfg.is_encdec else None
    for p in params.get("prefix", []):
        x = _slot_apply("attn", p, x, cfg, mesh=mesh)
    for p in range(cfg.n_periods):
        for s_idx, kind in enumerate(cfg.block_pattern):
            x = _slot_apply(kind, _index(params["body"][f"slot{s_idx}"], p), x, cfg,
                            enc_out=enc_out, mesh=mesh)
    return L.norm_apply(params["final_norm"], x, cfg)


def _head(params: dict, cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(dtype)


def forward(params: dict, batch: dict, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Logits (B, S, V_pad) for ``batch["tokens"]`` (B, S) int."""
    x = hidden_states(params, batch, cfg, mesh)
    return x @ _head(params, cfg, x.dtype)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            loss_chunks: int = 8) -> torch.Tensor:
    """Mean next-token cross entropy (0-d f32); labels < 0 are masked, and
    so is the vision stub's prefix (labels of -1 prepended over it)."""
    total, count = nll_terms(params, batch, cfg, loss_chunks)
    return total / count.clamp(min=1.0)


def nll_terms(params: dict, batch: dict, cfg: ModelConfig, loss_chunks: int = 8,
              mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the unmasked tokens' cross entropy, their count), both 0-d
    f32: ``loss_fn`` divides them; a meshed step sums both over the data
    ranks first, so its loss is the global batch's masked mean.

    The LM head and the CE run in ``loss_chunks`` token chunks (one chunk
    when B * S does not divide), so only one chunk of f32 logits is live
    at a time: qwen3's vocabulary is 151,936."""
    x = hidden_states(params, batch, cfg, mesh)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        pad = labels.new_full((labels.shape[0], batch["prefix_embeds"].shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
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
    return total, count


def split_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every batch entry: the batch split over the
    mesh's data axes (every axis but "model", row-major) when it divides
    into them, and whole otherwise (the reference's ``shard_act`` and
    MoE ``x_spec`` rule: a batch too small to split stays replicated)."""
    from ..distributed.sharding import axis_coord
    from ..launch.mesh import dp_axes
    n, idx = 1, 0
    for a in dp_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        n, idx = n * size, idx * size + axis_coord(mesh, a)
    B = next(iter(batch.values())).shape[0]
    if n == 1 or B % n or B < n:
        return batch
    rows = B // n
    return {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}


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
    state = {f"slot{s_idx}": _stacked(lambda: _state_init(kind, cfg, batch, max_len, device),
                                      cfg.n_periods)
             for s_idx, kind in enumerate(cfg.block_pattern)}
    prefix = [_state_init("attn", cfg, batch, max_len, device)
              for _ in range(cfg.n_dense_prefix)]
    if prefix:
        state["prefix"] = prefix
    return state


def _fill_lanes(dst, init, lanes, stacked: bool) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _fill_lanes(dst[k], init[k], lanes, stacked)
    elif isinstance(dst, tuple):
        for d, i in zip(dst, init):
            _fill_lanes(d, i, lanes, stacked)
    elif stacked:                        # (n_periods, B, ...) <- (1, ...)
        dst[:, lanes] = init
    else:
        dst[lanes] = init


def _lane_init(kind: str, cfg: ModelConfig, st):
    """One lane's initial state of a block kind, on ``st``'s device (a KV
    cache as long as ``st``'s)."""
    first = st["k"] if kind == "attn" else st[0]
    return _state_init(kind, cfg, 1, first.shape[-2], first.device)


def reset_lanes(state: dict, cfg: ModelConfig, lanes: list[int]) -> dict:
    """Write each block kind's initial decode state (``_BLOCKS[kind][4]``:
    zeros, and the sLSTM's ``NEG_INF`` stabiliser) into the rows of
    ``lanes`` of every period, in place; the other lanes keep theirs.  A
    KV cache's rows are zeroed too (its length masks them anyway)."""
    for s_idx, kind in enumerate(cfg.block_pattern):
        st = state[f"slot{s_idx}"]
        _fill_lanes(st, _lane_init(kind, cfg, st), lanes, True)
    for cache in state.get("prefix", []):
        _fill_lanes(cache, _lane_init("attn", cfg, cache), lanes, False)
    return state


def _slot_decode(kind: str, params: dict, x: torch.Tensor, state, lengths: torch.Tensor,
                 cfg: ModelConfig, enc_out=None, write=None, mesh=None) -> torch.Tensor:
    """One token through one block; ``state`` (a KV cache, or the views
    of a recurrent state's period row) is written in place.  ``write``
    (B,) bool: the lanes whose recurrent state takes the step (all when
    None); a KV cache is written in every lane, at its length."""
    h = L.norm_apply(params["norm1"], x, cfg)
    if kind == "attn":
        o, _ = L.attn_decode(params["attn"], h, state, lengths, cfg)
    else:
        name, _, _, decode = _BLOCKS[kind][:4]
        o, new = decode(params[name], h, state, cfg)
        for dst, src in zip(state, new):
            if write is None:
                dst.copy_(src)
            else:
                dst.copy_(torch.where(write.view((-1,) + (1,) * (src.dim() - 1)), src, dst))
    x = _cross(params, x + o, enc_out, cfg)
    if "norm2" not in params:
        return x
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg, mesh)


def decode_step(params: dict, state: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig, enc_out: torch.Tensor | None = None,
                write: torch.Tensor | None = None, mesh=None) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B,) int — the freshly sampled token;
    lengths: (B,) current context lengths; ``enc_out`` (B, Se, D): the
    encoder's output (``_encode``) for an encoder-decoder, whose blocks
    skip their cross-attention without it, as the reference's do.  Returns
    (logits (B, V), state); the caches in ``state`` are written in place at
    ``lengths``, the recurrent states in place in their period's row.

    ``write`` (B,) bool, on the state's device: where given, a recurrent
    state keeps its old value in every lane outside it (``torch.where``,
    no host read), so a lane that is idle, or another lane's prefill
    step, leaves it as it was.  A KV cache is written in every lane at its
    own length, as without a mask: a lane's next real step rewrites that
    position, and its length masks it until then."""
    x = embed_tokens(params, tokens[:, None], cfg)      # (B, 1, D)
    for p, cache in zip(params.get("prefix", []), state.get("prefix", [])):
        x = _slot_decode("attn", p, x, cache, lengths, cfg, enc_out=enc_out, mesh=mesh)
    for p in range(cfg.n_periods):
        for s_idx, kind in enumerate(cfg.block_pattern):
            slot = f"slot{s_idx}"
            x = _slot_decode(kind, _index(params["body"][slot], p), x,
                             _index(state[slot], p), lengths, cfg, enc_out=enc_out,
                             write=write, mesh=mesh)
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = (x @ _head(params, cfg, x.dtype))[:, 0, :]
    return logits, state
