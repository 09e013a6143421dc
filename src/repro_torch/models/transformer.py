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
``lax.scan``.  Decode state is stacked
the same way (the prefix's as a list): a KV cache ``{"k", "v"}`` for an
attention slot, a tuple of recurrent tensors for the others, each written
in place in its period's row.  A decode step takes the encoder's output
(``enc_out``) and recomputes the cross-attention's keys and values from
it, as the reference does; it has no input for the vision prefix, as the
reference's has none.

On a mesh every function takes ``part`` (``distributed.sharding.Partition``,
made by ``partition``): ``params`` are this rank's shards and each layer
gathers its leaves on use (``_take``: over the data axes, and over
"model" where the layer runs whole there), so no more than one layer's
leaves are gathered at once.  ``embed`` and the head stay cut over the
vocabulary on "model": the lookup is vocab-parallel (``embed_tokens``),
each rank computes the logits of its vocabulary columns and the cross
entropy is vocab-parallel (``nll_terms``).  Between blocks
the activations are split over the sequence on "model" when it divides
(the reference's ``shard_act(seq_dim=1)``); attention and the MLP are
tensor-parallel (``layers``), a MoE layer expert-parallel (``moe``), the
recurrent blocks tensor-parallel as the reference's specs cut them
(mamba channel-parallel, ``ssm``; the mLSTM and sLSTM projections and the
sLSTM's state cut, ``xlstm``), and attention whose heads do not divide
runs whole on every "model" rank.  Under grad each
period runs under ``torch.utils.checkpoint`` (the reference's remat, its
policy read from ``REPRO_REMAT_POLICY``: ``remat_policy``), so the
backward gathers the period's leaves again.  Decode attends over the
rank's own KV heads (the kv_head cache layout) or its head_dim columns of
every head (the head_dim layout), and a recurrent block steps the rank's
block of its state in place.  An axis of one rank moves nothing and
computes as the unmeshed step; the unmeshed path (``part=None``) is
unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig, part=None,
                 prefix: torch.Tensor | None = None) -> torch.Tensor:
    """The tokens' rows of ``embed`` in ``cfg.dtype``, after ``prefix``
    (the vision stub's patch embeddings) when given.

    With ``part`` the result is this rank's shard of the sequence when
    ``part.seq`` splits it, else the whole.  Over "model" the table stays
    cut (``embed``'s spec cuts its rows, the vocabulary): each rank looks
    its tokens up in its own rows, a token outside them reads zeros, and
    the partial rows are reduce-scattered into the sequence split or
    all-reduced (``SeqScatter``, ``SumOverGroup``), whose backward hands
    each rank the gradient of every position, so each rank's rows get
    their whole gradient."""
    dt = getattr(torch, cfg.dtype)
    if part is None or part.tp == 1:
        # F.embedding, not indexing: its backward sums each token's rows in a
        # fixed order on both devices, where indexing's accumulates in any
        # order on the CPU, and a resumed run must repeat an uninterrupted one
        table = params["embed"] if part is None else _take_whole(part, params["embed"], "embed")
        x = F.embedding(tokens, table).to(dt)
        if prefix is not None:
            x = torch.cat([prefix.to(dt), x], dim=1)
        return x if part is None else part.local_seq(x)
    from ..distributed.sharding import TP, SeqScatter, SumOverGroup
    table = part.take(params["embed"], part.specs["embed"], False, False)
    rows = table.shape[0]
    ids = tokens.to(torch.int64) - part.rank * rows
    mine = (ids >= 0) & (ids < rows)
    x = F.embedding(ids.clamp(0, rows - 1), table).to(dt)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dt, device=x.device))
    if prefix is not None:                   # rank 0 adds the prefix to the sum
        x = torch.cat([prefix.to(dt) * float(part.rank == 0), x], dim=1)
    if part.seq:
        return SeqScatter.apply(x, part.mesh, TP, 1)
    return SumOverGroup.apply(x, part.mesh, TP)


# ---------------------------------------------------------------------------
# the partitioned step: each layer's leaves gathered on use
# ---------------------------------------------------------------------------
def partition(mesh, rows: int, specs: dict):
    """The ``Partition`` of a meshed step over a global batch of ``rows``:
    the data axes split the batch when it divides into them
    (``split_batch``); ``specs`` is the params' ``model.spec_tree``."""
    from ..distributed.sharding import Partition
    from ..launch.mesh import dp_axes, dp_size
    n = dp_size(mesh)
    return Partition(mesh, dp_axes(mesh), split=n > 1 and rows % n == 0 and rows >= n,
                     specs=specs)


def _heads(cfg: ModelConfig, part, decode: bool = False):
    """This rank's ``layers.Heads`` of an attention layer, or None when the
    layer runs whole on every "model" rank (its heads do not split; in
    decode also when the kernel lacks the local group size)."""
    from ..kernels.decode_attention import GROUPS
    return L.head_split(cfg, part.tp, part.rank, GROUPS if decode else None)


#: a recurrent block's leaves read whole on every "model" rank: the ones
#: the reference's specs leave uncut (``w_bc``, ``w_if``, ``if_bias``,
#: ``bias``) and the sLSTM's small ``w_h``, of which each rank reads its
#: heads' rows
_RECURRENT_WHOLE = {"ssm": ("w_bc",), "mlstm": ("w_if", "if_bias"), "slstm": ("w_h", "bias")}
#: the column-cut leaves made of equal parts, by their number of parts:
#: each rank takes its channel block of every part (``Partition.take_channels``)
_CHANNEL_PARTS = {("ssm", "w_in"): 2, ("mlstm", "w_up"): 2, ("slstm", "w_x"): 4,
                  ("slstm", "w_ff_up"): 2}


def _leaf_use(path: tuple, cfg: ModelConfig, part, heads, whole_kv: bool) -> tuple[bool, bool]:
    """How a layer uses its leaf at ``path`` (names within the layer):
    (gathered whole over "model", its gradient summed over "model").

    A tensor-parallel block's column and row blocks keep their "model"
    cut and are each rank's alone; ``wk``/``wv`` read whole (their KV
    heads do not split, or a gathered decode cache takes every head) and
    the qk-norm scales serve the rank's heads only, so their gradients
    are partial over "model".  The recurrent blocks are tensor-parallel
    too: their cut leaves are each rank's alone, and the leaves they read
    whole (``_RECURRENT_WHOLE``) serve the rank's channels only, so their
    gradients are summed.  A MoE layer's experts keep their cut, and
    its router's gradient is summed inside the body.  Whatever runs whole
    on every "model" rank (norms, embed and head, attention whose heads
    do not split, a MoE layer without expert parallelism) is summed over
    "model" exactly when the sequence is split there, as each rank then
    computes its own positions."""
    group, name = path[0], path[-1]
    if group in _RECURRENT_WHOLE:
        return (True, True) if name in _RECURRENT_WHOLE[group] else (False, False)
    if group in ("attn", "cross") and heads is not None:
        if name in ("wq", "wo"):
            return False, False
        if name in ("wk", "wv") and not whole_kv:
            return False, False
        return True, True
    if group == "mlp":
        return False, False
    if group == "moe" and MoE.ep_size(cfg, part.mesh):
        if name == "router":
            return True, False
        return False, False                     # the expert stacks and the shared expert
    return True, part.seq


def _take_whole(part, local: torch.Tensor, name: str, spec=None) -> torch.Tensor:
    """A leaf outside the layers (``final_norm``; ``embed`` and ``lm_head``
    at one "model" rank) on use: whole on every "model" rank, as
    ``_leaf_use`` takes what runs whole there."""
    return part.take(local, part.specs[name] if spec is None else spec, True, part.seq)


def _take(part, local: dict, specs: dict, cfg: ModelConfig, heads=None, whole_kv=False,
          path: tuple = ()) -> dict:
    """One layer's leaves on use (``Partition.take`` by ``_leaf_use``, or
    ``Partition.take_channels`` for a leaf of ``_CHANNEL_PARTS``):
    ``local`` holds this rank's blocks, ``specs`` their specs."""
    if isinstance(local, dict):
        return {k: _take(part, v, specs[k], cfg, heads, whole_kv, path + (k,))
                for k, v in local.items()}
    k = _CHANNEL_PARTS.get((path[0], path[-1]))
    if k:
        return part.take_channels(local, specs, k)
    return part.take(local, specs, *_leaf_use(path, cfg, part, heads, whole_kv))


def _layer_specs(specs: dict, stacked: bool) -> dict:
    """A layer's leaf specs: a period stack's without its leading axis."""
    if isinstance(specs, dict):
        return {k: _layer_specs(v, stacked) for k, v in specs.items()}
    return specs[1:] if stacked else specs


def _split(part, fn, h: torch.Tensor, heads, *args, **kw) -> torch.Tensor:
    """A block's branch on ``h``: unmeshed, tensor-parallel over ``heads``
    (``fn`` enters and exits), or whole on every "model" rank."""
    if part is None:
        return fn(h, *args, **kw)
    if heads is not None:
        return fn(h, *args, part=part, heads=heads, **kw)
    return part.rep_exit(fn(part.rep_enter(h), *args, **kw))


# ---------------------------------------------------------------------------
# forward (prefill / evaluation)
# ---------------------------------------------------------------------------
def _ffn(params: dict, h: torch.Tensor, cfg: ModelConfig, part=None) -> torch.Tensor:
    if "moe" in params:
        return MoE.moe_apply(params["moe"], h, cfg, part=part)
    return L.mlp_apply(params["mlp"], h, part)


def _cross(params: dict, x: torch.Tensor, enc_out, cfg: ModelConfig, part=None,
           heads=None) -> torch.Tensor:
    """A decoder block's cross-attention branch, after the mixer; on a mesh
    ``enc_out`` is whole (``_enter_encoder``)."""
    if "cross" not in params or enc_out is None:
        return x
    hx = L.norm_apply(params["norm_x"], x, cfg)
    return x + _split(part, lambda h, **kw: L.cross_attn_apply(params["cross"], h, enc_out, cfg,
                                                               **kw), hx, heads)


def _slot_apply(kind: str, params: dict, x: torch.Tensor, cfg: ModelConfig,
                enc_out=None, part=None, heads=None) -> torch.Tensor:
    """Full-sequence apply of one block.  An attention block of an
    encoder-decoder is causal exactly when it is given the encoder's
    output: the encoder's own blocks run non-causal.  With ``part``,
    ``params`` are the layer's leaves on use (``_take``), ``x`` this
    rank's activations and ``heads`` its attention heads (None: whole)."""
    name, _, apply = _BLOCKS[kind][:3]
    h = L.norm_apply(params["norm1"], x, cfg)
    kw = {"causal": not cfg.is_encdec or enc_out is not None} if kind == "attn" else {}
    if part is not None and kind in RECURRENT_KINDS:     # tensor-parallel: enters and exits
        y = apply(params[name], h, cfg, part=part)
    else:
        y = _split(part, lambda h_, **k: apply(params[name], h_, cfg, **kw, **k), h,
                   heads if kind == "attn" else None)
    x = _cross(params, x + y, enc_out, cfg, part, heads)
    if "norm2" not in params:
        return x
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg, part)


def _layer(kind: str, local: dict, specs: dict, x: torch.Tensor, cfg: ModelConfig, part,
           enc_out=None) -> torch.Tensor:
    """One layer from this rank's blocks ``local``: its leaves gathered on
    use, then ``_slot_apply``; the gathered leaves are dropped after it."""
    heads = _heads(cfg, part)
    params = _take(part, local, specs, cfg, heads, whole_kv=heads is not None and
                   cfg.n_kv_heads % part.tp != 0)
    return _slot_apply(kind, params, x, cfg, enc_out=enc_out, part=part, heads=heads)


#: the products whose outputs the "dots" remat policy saves: those with no
#: batch dimensions (a ``torch.matmul`` of activations by a weight lowers
#: to one of these), as ``jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable`` saves ``dot_general``s without them
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy() -> str:
    """``REPRO_REMAT_POLICY``, read as the reference's ``_body_scan`` reads
    it on every call: "dots" saves the outputs of products with no batch
    dimensions and recomputes the rest of a period (its attention
    kernels, batched products and gathers); anything else (the default
    "nothing") saves only the period's input."""
    import os
    return "dots" if os.environ.get("REPRO_REMAT_POLICY", "nothing") == "dots" else "nothing"


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _run_period(fn, x: torch.Tensor, part) -> torch.Tensor:
    """``fn(x)``: under grad on a mesh through ``torch.utils.checkpoint``
    (non-reentrant; the reference's ``jax.checkpoint`` of a period), by
    ``remat_policy()``: "nothing" keeps only the period's input and the
    backward runs the period again, its gathers too; "dots" also keeps
    the outputs of its products with no batch dimensions, which the
    recompute then takes instead of running them
    (``create_selective_checkpoint_contexts``)."""
    if part is None or not torch.is_grad_enabled():
        return fn(x)
    kw = {}
    if remat_policy() == "dots":
        import functools

        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False, **kw)


def _body(params: dict, key: str, x: torch.Tensor, cfg: ModelConfig, pattern, n: int,
          part, enc_out=None) -> torch.Tensor:
    """The periods of ``params[key]`` (stacked slots) over ``x``."""
    if part is not None:                 # each slot's specs, the same every period
        specs = {slot: _layer_specs(s, True) for slot, s in part.specs[key].items()}
    for p in range(n):
        if part is None:
            for s_idx, kind in enumerate(pattern):
                x = _slot_apply(kind, _index(params[key][f"slot{s_idx}"], p), x, cfg,
                                enc_out=enc_out)
            continue

        def period(x, p=p):
            for s_idx, kind in enumerate(pattern):
                slot = f"slot{s_idx}"
                x = _layer(kind, _index(params[key][slot], p), specs[slot], x, cfg, part,
                           enc_out)
            return x
        x = _run_period(period, x, part)
    return x


def _final_norm(params: dict, x: torch.Tensor, cfg: ModelConfig, part) -> torch.Tensor:
    norm = params["final_norm"] if part is None else {
        k: _take_whole(part, v, "final_norm", part.specs["final_norm"][k])
        for k, v in params["final_norm"].items()}
    return L.norm_apply(norm, x, cfg)


def _encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, part=None):
    """The encoder's output (B, Se, D): ``frames`` (B, Se, D) through the
    non-causal ``enc_body``, normed by the shared ``final_norm``.  A decode
    step takes it as ``enc_out``.  With ``part``, (this rank's shard of
    the output, the encoder's ``Partition``: its sequence split over
    "model" when Se divides)."""
    e = frames.to(getattr(torch, cfg.dtype))
    if part is not None:
        part = part.with_seq(e.shape[1])
        e = part.local_seq(e)
    e = _body(params, "enc_body", e, cfg, ("attn",), cfg.n_enc_layers, part)
    e = _final_norm(params, e, cfg, part)
    return e if part is None else (e, part)


def _seq_part(part, batch: dict, cfg: ModelConfig):
    """``part`` for the decoder's sequence (the prefix's positions too)."""
    n = batch["tokens"].shape[1]
    if cfg.frontend == "vision_stub":
        n += batch["prefix_embeds"].shape[1]
    return part.with_seq(n)


def hidden_states(params: dict, batch: dict, cfg: ModelConfig, part=None) -> torch.Tensor:
    """Forward up to (but not including) the LM head: (B, S_total, D).

    ``batch`` holds ``tokens`` (B, S) int; for the vision stub also
    ``prefix_embeds`` (B, Np, D), prepended (S_total = Np + S); for an
    encoder-decoder ``frames`` (B, Se, D), the encoder's input.  With
    ``part`` (``partition``) ``params`` are this rank's shards, the batch
    is this rank's (``split_batch``) and the result this rank's shard of
    the sequence when ``_seq_part`` splits it."""
    if part is not None:
        part = _seq_part(part, batch, cfg)
    x = embed_tokens(params, batch["tokens"], cfg, part,
                     prefix=batch["prefix_embeds"] if cfg.frontend == "vision_stub" else None)
    enc_out = None
    if cfg.is_encdec:
        enc_out = _encode(params, batch["frames"], cfg, part)
        if part is not None:
            enc_out = _enter_encoder(*enc_out, cfg)
    if part is None:
        for p in params.get("prefix", []):
            x = _slot_apply("attn", p, x, cfg)
    else:
        for p, specs in zip(params.get("prefix", []), part.specs.get("prefix", [])):
            x = _layer("attn", p, specs, x, cfg, part)
    x = _body(params, "body", x, cfg, cfg.block_pattern, cfg.n_periods, part, enc_out)
    return _final_norm(params, x, cfg, part)


def _enter_encoder(enc_out: torch.Tensor, enc_part, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's output whole on every rank, for every decoder layer's
    cross-attention: its gradient, partial over "model" (the ranks' heads,
    or their query positions), is summed once."""
    if _heads(cfg, enc_part) is not None:
        return enc_part.tp_enter(enc_out)
    return enc_part.rep_enter(enc_out)


def _head(params: dict, cfg: ModelConfig, dtype: torch.dtype, part=None,
          whole: bool = False) -> torch.Tensor:
    """The LM head (D, V_pad) in ``dtype``; with ``part`` over "model" this
    rank's columns (D, V_pad / tp), the vocabulary kept cut as ``embed``'s
    and ``lm_head``'s specs cut it (``_vocab_parallel``), unless
    ``whole``."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    if part is None:
        w = params[name]
    elif _vocab_parallel(part) and not whole:
        w = part.take(params[name], part.specs[name], False, False)
    else:
        w = _take_whole(part, params[name], name)
    return (w.T if cfg.tie_embeddings else w).to(dtype)


def _vocab_parallel(part) -> bool:
    """The head and the cross entropy over each "model" rank's columns of
    the vocabulary; an axis of one rank keeps the unmeshed code."""
    return part is not None and part.tp > 1


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig, part) -> torch.Tensor:
    """``x @ head`` over the whole vocabulary, for every row of ``x``.
    Over "model" the cheaper of two all-gathers: with fewer rows than
    d_model (a decode step) the logits of the rank's head columns,
    computed vocabulary-major (Vl, N), gathered into (V, N) and returned
    as a transposed view (..., V); with more (a prefill), the head whole,
    as its V x D elements are then fewer than the logits' V x N."""
    n = x.numel() // x.shape[-1]
    if not _vocab_parallel(part) or n >= cfg.d_model:
        return x @ _head(params, cfg, x.dtype, part, whole=True)
    from ..distributed.sharding import TP, _all_gather
    local = _head(params, cfg, x.dtype, part).T @ x.reshape(n, -1).T
    return _all_gather(local, 0, part.mesh.get_group(TP), part.tp).T.unflatten(0, x.shape[:-1])


def forward(params: dict, batch: dict, cfg: ModelConfig, part=None) -> torch.Tensor:
    """Logits (B, S, V_pad) for ``batch["tokens"]`` (B, S) int; with
    ``part``, this rank's rows, the sequence and the vocabulary whole
    (``_logits``)."""
    x = hidden_states(params, batch, cfg, part)
    if part is not None:
        p = _seq_part(part, batch, cfg)
        if p.seq:
            from ..distributed.sharding import TP, _all_gather
            x = _all_gather(x, 1, p.mesh.get_group(TP), p.tp)
    return _logits(params, x, cfg, part)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            loss_chunks: int = 8) -> torch.Tensor:
    """Mean next-token cross entropy (0-d f32); labels < 0 are masked, and
    so is the vision stub's prefix (labels of -1 prepended over it)."""
    total, count = nll_terms(params, batch, cfg, loss_chunks)
    return total / count.clamp(min=1.0)


def nll_terms(params: dict, batch: dict, cfg: ModelConfig, loss_chunks: int = 8,
              part=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the unmasked tokens' cross entropy, their count), both 0-d
    f32: ``loss_fn`` divides them; a meshed step sums both over the ranks
    that split the batch first (``nll_sum_axes``), so its loss is the
    global batch's masked mean.  With ``part`` they are this rank's rows'.

    The LM head and the CE run in ``loss_chunks`` token chunks (one chunk
    when B * S does not divide), so only one chunk of f32 logits is live
    at a time: qwen3's vocabulary is 151,936.  Over "model" the sequence
    is gathered before the head (``Partition.tp_enter``), each rank
    computes the logits of its vocabulary columns and the cross entropy
    is vocab-parallel (``sharding.VocabParallelNLL``), so every "model"
    rank holds the whole sequence's complete terms; the padded columns
    stay in the logsumexp, as the reference keeps them."""
    x = hidden_states(params, batch, cfg, part)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub":
        pad = labels.new_full((labels.shape[0], batch["prefix_embeds"].shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
    vocab = _vocab_parallel(part)
    if vocab:
        from ..distributed.sharding import TP, VocabParallelNLL
        x = _seq_part(part, batch, cfg).tp_enter(x)
    head = _head(params, cfg, x.dtype, part)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    lt = labels.reshape(B * S).to(torch.int64)
    n_chunks = loss_chunks if (B * S) % loss_chunks == 0 else 1
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for x_c, l_c in zip(xt.reshape(n_chunks, -1, D), lt.reshape(n_chunks, -1)):
        logits = (x_c @ head).float()
        mask = (l_c >= 0).float()
        if vocab:
            nll = VocabParallelNLL.apply(logits, l_c, part.rank * head.shape[1], part.mesh, TP)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            nll = lse - logits.gather(-1, l_c.clamp(min=0)[:, None])[:, 0]
        total = total + (nll * mask).sum()
        count = count + mask.sum()
    return total, count


def nll_sum_axes(part) -> tuple:
    """The mesh axes ``nll_terms``' terms are summed over: the data axes
    when they split the batch.  Never "model": there every rank holds the
    whole sequence's terms (the vocab-parallel head), and a sum would
    count each token tp times."""
    return part.sum_axes(model=False)


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
                 cfg: ModelConfig, enc_out=None, write=None, part=None,
                 heads=None, head_dim: bool = False) -> torch.Tensor:
    """One token through one block; ``state`` (a KV cache, or the views
    of a recurrent state's period row) is written in place.  ``write``
    (B,) bool: the lanes whose recurrent state takes the step (all when
    None); a KV cache is written in every lane, at its length.  With
    ``part``, the rank's attention ``heads`` (None: the block whole),
    with ``head_dim`` a cache holding the rank's head_dim columns
    (``layers.attn_decode_head_dim``), and a recurrent block
    tensor-parallel on the rank's block of its state."""
    h = L.norm_apply(params["norm1"], x, cfg)
    if kind == "attn" and head_dim:
        o, _ = L.attn_decode_head_dim(params["attn"], h, state, lengths, cfg, part, heads)
    elif kind == "attn":
        o, _ = L.attn_decode(params["attn"], h, state, lengths, cfg,
                             **({"part": part, "heads": heads} if heads is not None else {}))
    else:
        name, _, _, decode = _BLOCKS[kind][:4]
        o, new = decode(params[name], h, state, cfg, part=part)
        for dst, src in zip(state, new):
            if write is None:
                dst.copy_(src)
            else:
                dst.copy_(torch.where(write.view((-1,) + (1,) * (src.dim() - 1)), src, dst))
    x = _cross(params, x + o, enc_out, cfg, part, heads)
    if "norm2" not in params:
        return x
    h2 = L.norm_apply(params["norm2"], x, cfg)
    return x + _ffn(params, h2, cfg, part)


def _period_spec(spec):
    """A stacked state's specs without the leading period axis."""
    if isinstance(spec, dict):
        return {k: v[1:] for k, v in spec.items()}
    return tuple(v[1:] for v in spec)


def _state_axes(spec: tuple, mesh) -> list:
    """The mesh axes that cut a period's attention cache (its spec
    ``spec``, batch first) off its batch dimension: KV heads, head_dim or
    sequence over "model", the sequence over the data axes when the batch
    is too small to split."""
    from ..distributed.sharding import axes_of
    return [a for e in spec[1:] for a in axes_of(e) if a in mesh.mesh_dim_names]


def _kv_heads_local(spec: dict, part) -> bool:
    """An attention cache laid out with its KV heads on "model" (the
    kv_head layout): each rank holds, writes and reads its own heads."""
    from ..distributed.sharding import TP, axes_of
    return part.tp > 1 and TP in axes_of(spec["k"][1])


def _head_dim_local(spec: dict, part) -> bool:
    """An attention cache laid out with its head_dim on "model" (the
    head_dim layout): each rank holds, writes and reads its columns of
    every head (``layers.attn_decode_head_dim``)."""
    from ..distributed.sharding import TP, axes_of
    return part.tp > 1 and TP in axes_of(spec["k"][-1])


def _decode_block(kind: str, local: dict, specs: dict, x: torch.Tensor, state,
                  lengths: torch.Tensor, cfg: ModelConfig, spec, part, **kw) -> torch.Tensor:
    """One layer's decode step on a mesh: its leaves gathered on use from
    this rank's blocks ``local`` (specs ``specs``) and ``state`` this
    rank's block of the layer's decode state (specs ``spec``, batch first).
    A recurrent block steps the rank's block in place, tensor-parallel:
    ``decode_state_specs`` cuts its features over "model" (the mLSTM's
    not at all) and, over the data axes, only its batch, as the batch
    rows are cut (or not, when the batch is too small to split): nothing
    of it is gathered.  Under the kv_head layout the rank writes and
    attends over its own KV heads (unless its heads do not split: then
    as the seq layout), and under the head_dim layout over its head_dim
    columns of every head: nothing of the cache moves over "model".
    Otherwise each cache tensor is gathered over the axes that cut it
    off the batch (``_state_axes``), the block decodes on the whole (its
    KV for every head, its queries the rank's heads), and the rank keeps
    its block of what it wrote; under the head_dim layout that is only
    the sequence over the data axes (a batch too small to split)."""
    from ..distributed.sharding import TP
    if kind in RECURRENT_KINDS:
        return _slot_decode(kind, _take(part, local, specs, cfg), x, state, lengths, cfg,
                            part=part, **kw)
    split = kind == "attn" and _head_dim_local(spec, part)
    heads = None
    if kind == "attn":        # the split kernels take any group; the fused one its GROUPS
        heads = _heads(cfg, part) if split else _heads(cfg, part, decode=True)
    own = heads is not None and _kv_heads_local(spec, part)
    params = _take(part, local, specs, cfg, heads, whole_kv=not own)
    if own:
        return _slot_decode(kind, params, x, state, lengths, cfg, part=part, heads=heads, **kw)
    from ..distributed.sharding import gather, shard_slices
    names = ("k", "v")
    axes = {n: [a for a in _state_axes(spec[n], part.mesh) if not (split and a == TP)]
            for n in names}
    whole = {n: gather(state[n], spec[n], part.mesh, axes=axes[n]) for n in names}
    x = _slot_decode(kind, params, x, whole, lengths, cfg, part=part, heads=heads,
                     head_dim=split, **kw)
    for n in names:
        if axes[n] and whole[n] is not state[n]:
            state[n].copy_(whole[n][shard_slices(whole[n].shape, spec[n], part.mesh,
                                                 axes=axes[n])])
    return x


def decode_step(params: dict, state: dict, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig, enc_out: torch.Tensor | None = None,
                write: torch.Tensor | None = None, part=None,
                state_specs: dict | None = None) -> tuple[torch.Tensor, dict]:
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
    position, and its length masks it until then.

    With ``part`` (``partition``) and ``state_specs``
    (``model.decode_state_specs``), ``params`` are this rank's shards,
    ``state`` holds this rank's block of every leaf and the rows of
    ``tokens`` are this rank's (``_decode_block``)."""
    x = embed_tokens(params, tokens[:, None], cfg, part)      # (B, 1, D)
    if part is None:
        for p, cache in zip(params.get("prefix", []), state.get("prefix", [])):
            x = _slot_decode("attn", p, x, cache, lengths, cfg, enc_out=enc_out)
    else:
        for p, specs, cache, spec in zip(params.get("prefix", []), part.specs.get("prefix", []),
                                         state.get("prefix", []), state_specs.get("prefix", [])):
            x = _decode_block("attn", p, specs, x, cache, lengths, cfg, spec, part,
                              enc_out=enc_out)
    slots = {f"slot{s_idx}": kind for s_idx, kind in enumerate(cfg.block_pattern)}
    if part is not None:                 # each slot's specs, the same every period
        specs = {slot: (_layer_specs(part.specs["body"][slot], True),
                        _period_spec(state_specs[slot])) for slot in slots}
    for p in range(cfg.n_periods):
        for slot, kind in slots.items():
            local, st = _index(params["body"][slot], p), _index(state[slot], p)
            if part is None:
                x = _slot_decode(kind, local, x, st, lengths, cfg, enc_out=enc_out, write=write)
            else:
                x = _decode_block(kind, local, specs[slot][0], x, st, lengths, cfg,
                                  specs[slot][1], part, enc_out=enc_out, write=write)
    x = _final_norm(params, x, cfg, part)
    logits = _logits(params, x, cfg, part)[:, 0, :]
    return logits, state
