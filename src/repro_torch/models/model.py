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

The shape and FLOP helpers (``SHAPES``, ``abstract_params``,
``input_specs``, ``abstract_decode_state``, ``model_flops``) build
``meta`` tensors and allocate nothing: kimi-k2's 1.03 T parameters come
back in a fraction of a second.  The sharding helpers give each leaf the
reference's ``PartitionSpec`` as a tuple of mesh axis names
(``spec_tree``, ``opt_spec_tree``, ``decode_state_specs``) and turn it
into placements on a ``DeviceMesh`` (``param_shardings``); each
``make_*_step(..., mesh=...)`` runs its sharded step over
``torch.distributed`` (``distributed/sharding.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..optim.adamw import AdamWConfig, _leaf_quantized, adamw_update
from ..optim.schedule import cosine_schedule
from ..tree import leaves, map_like, unflatten
from . import layers as L
from . import transformer as T
from .config import ModelConfig

# the reference's mesh axes: "data" shards parameters (FSDP, all-gathered
# where they are used) and the batch, "model" is the tensor/expert axis
FSDP = "data"
TP = "model"


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


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


def _work_leaves(params: dict) -> dict:
    """Detached leaves that require grad, each per-period stack of
    ``params["body"]`` cut into its periods (views)."""

    def leaf(p):
        return p.detach().requires_grad_(True)

    work = map_like(leaf, {k: v for k, v in params.items() if k != "body"})
    work["body"] = map_like(lambda t: [leaf(t[i]) for i in range(t.shape[0])], params["body"])
    return work


def _grads(params: dict, work: dict, loss: torch.Tensor) -> dict:
    """The gradient of ``loss`` for every leaf of ``work``, as ``params``'
    tree (a period stack's assembled once)."""
    flat = leaves(work)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = unflatten(work, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(flat, grads)])
    grads["body"] = map_like(lambda _, parts: torch.stack(parts), params["body"], grads["body"])
    return {k: grads[k] for k in params}


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig, mesh=None):
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
    at the end.

    On a ``mesh`` (``_sharded_loss_and_grads``) ``params`` and the
    returned grads are this rank's shards, ``batch`` the global batch."""
    if mesh is not None:
        return _sharded_loss_and_grads(params, batch, cfg, mesh)
    work = _work_leaves(params)
    with torch.enable_grad():
        loss = T.loss_fn(work, batch, cfg)
        grads = _grads(params, work, loss)
    return loss.detach(), grads


def shard_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's block of every leaf of a whole tree (``params`` or
    like it, e.g. its gradients) by ``spec_tree``: what a rank of a meshed
    step stores."""
    from ..distributed.sharding import shard
    return map_like(lambda t, s: shard(t, s, mesh), params, spec_tree(cfg))


def _local_batch(batch: dict, cfg: ModelConfig, mesh):
    """(this rank's rows of ``batch`` (``transformer.split_batch``; a batch
    too small to split is the same on every rank), the step's
    ``transformer.partition``)."""
    from ..distributed.sharding import require_process_group
    require_process_group()
    part = T.partition(mesh, next(iter(batch.values())).shape[0], spec_tree(cfg))
    return T.split_batch(batch, mesh), part


def _sharded_loss_and_grads(params: dict, batch: dict, cfg: ModelConfig, mesh):
    """The meshed ``loss_and_grads`` on this rank's shards: this rank's
    rows of the batch (``transformer.split_batch``), each layer's leaves
    gathered on use and its periods checkpointed (``transformer``'s
    partitioned forward), and each gradient arriving as this rank's
    shard (``sharding.GatherOnUse``'s backward: summed over the ranks that
    computed parts of it, cut alike on the others).  The loss is the
    global batch's masked mean: the count of unmasked labels is summed over
    the ranks that split the batch before the division
    (``transformer.nll_sum_axes``; never over "model", whose ranks each
    hold the whole sequence's terms from the vocab-parallel head), and so
    is the reported sum of their cross entropy."""
    from ..distributed.sharding import all_reduce
    local, part = _local_batch(batch, cfg, mesh)
    sum_axes = T.nll_sum_axes(part)
    work = _work_leaves(params)
    with torch.enable_grad():
        total, count = T.nll_terms(work, local, cfg, part=part)
        count = all_reduce(count.detach().clone(), sum_axes, mesh).clamp(min=1.0)
        grads = _grads(params, work, total / count)
    del work
    return all_reduce(total.detach().clone(), sum_axes, mesh) / count, grads


def _row_max(cfg: ModelConfig, mesh) -> dict:
    """Per leaf, the all-reduce (max) over the mesh axes that cut its last
    dimension, or None: an int8 moment's per-row scale is the whole row's
    absmax, as the reference's GSPMD reduction gives it."""
    import torch.distributed as dist

    from ..distributed.sharding import all_reduce, axes_of

    def fn(_, spec):
        axes = [a for a in axes_of(spec[-1]) if a in mesh.mesh_dim_names] if spec else []
        if not axes:
            return None
        return lambda amax: all_reduce(amax, axes, mesh, op=dist.ReduceOp.MAX)
    return map_like(fn, abstract_params(cfg), spec_tree(cfg))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, total_steps: int = 10000,
                    warmup: int | None = None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr_scale"})``: the loss and its gradient, the cosine
    schedule's scale at ``opt_state["step"]`` and one AdamW update, with
    the reference's warmup rule.  It returns new trees and leaves its
    arguments as they were.  Unmeshed there is no remat: the activations
    of qwen3-1.7B at B = 1, S = 4096 fit one card (the JAX body's
    ``jax.checkpoint`` changes no number).

    With a ``mesh`` (a ``DeviceMesh`` with "data" and "model" axes, and
    "pod" where it has one) the step is the reference's sharded step over
    ``torch.distributed``: ``params`` and ``opt_state`` are this rank's
    shards (``shard_params``; ``adamw_init(shards, opt_cfg,
    full=abstract_params(cfg))``, so that int8 moments follow the whole
    leaves), ``batch`` the global batch, which every rank passes whole;
    each layer's leaves are gathered on use, attention and the MLP run
    tensor-parallel over "model" with the activations split over the
    sequence, each period is checkpointed (``_sharded_loss_and_grads``),
    and AdamW updates the shards (an int8 moment's row scale taken over
    the whole row).  Its numbers are the unmeshed step's on the whole
    batch, up to the order of the sums over the ranks."""
    L.set_fp32_matmul()
    wu = warmup if warmup is not None else max(1, min(200, total_steps // 20))
    row_max = _row_max(cfg, mesh) if mesh is not None else None

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch, cfg, mesh)
        lr_scale = cosine_schedule(opt_state["step"], warmup=wu, total=total_steps)
        new_params, new_opt = adamw_update(params, grads, opt_state, opt_cfg,
                                           lr_scale=lr_scale, row_max=row_max)
        return new_params, new_opt, {"loss": loss, "lr_scale": lr_scale}
    return train_step


def make_eval_step(cfg: ModelConfig, mesh=None):
    """``eval_step(params, batch) -> loss`` (0-d f32): the masked mean
    next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (labels < 0 masked); with ``prefix_embeds`` or
    ``frames`` for the vision and audio stubs.

    With a ``mesh``, as ``make_train_step``'s forward: ``params`` are this
    rank's shards (``shard_params``), each layer's gathered on use,
    ``batch`` the global batch, of which the rank takes its rows
    (``transformer.split_batch``) and its shard of the sequence; the sum
    of the cross entropy and the count of unmasked labels are all-reduced
    over the ranks that split the tokens before the division, so every
    rank returns the global batch's loss."""
    L.set_fp32_matmul()

    def eval_step(params, batch):
        with torch.inference_mode():
            if mesh is None:
                return T.loss_fn(params, batch, cfg)
            from ..distributed.sharding import all_reduce
            local, part = _local_batch(batch, cfg, mesh)
            sum_axes = T.nll_sum_axes(part)
            total, count = T.nll_terms(params, local, cfg, part=part)
            total, count = (all_reduce(t.clone(), sum_axes, mesh) for t in (total, count))
            return total / count.clamp(min=1.0)
    return eval_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch) -> logits`` (B, S_total, V_pad) over
    ``batch["tokens"]`` (after ``prefix_embeds`` for the vision stub; the
    encoder reads ``frames``).

    With a ``mesh``, ``params`` are this rank's shards and ``batch`` the
    global batch, as for ``make_eval_step``, and the step returns this
    rank's rows of the logits (``transformer.split_batch``; all of them
    when the batch is too small to split): the reference's output stays
    sharded too, and a whole ``prefill_32k`` logits tensor (32 x 32768 x
    V_pad f32) would be ~0.6 TB."""
    L.set_fp32_matmul()

    def prefill_step(params, batch):
        with torch.inference_mode():
            if mesh is None:
                return T.forward(params, batch, cfg)
            local, part = _local_batch(batch, cfg, mesh)
            return T.forward(params, local, cfg, part)
    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, cache_layout: str = "auto"):
    """One-token decode over the cache: ``serve_step(params, state, batch)
    -> (next_tok (B,) int32, logits (B, V_pad), state)``, greedy over the
    real vocabulary (the padded ids are masked to -inf).  An
    encoder-decoder reads the encoder's output from ``batch["enc_out"]``;
    ``batch["write"]`` (B,) bool, where given, is the lanes whose
    recurrent states take the step (``transformer.decode_step``).

    With a ``mesh``, ``params`` are this rank's shards (each layer's
    gathered on use, attention and the MLP tensor-parallel over "model"),
    ``batch`` the global batch, and ``state`` this rank's block of the
    decode state, cut by ``decode_state_specs(cfg, B, dp=dp_axes(mesh),
    dp_size=dp_size(mesh), cache_layout=cache_layout, tp_size=...)``.
    Under the kv_head layout (an arch whose KV heads divide over "model")
    each rank writes and attends over its own KV heads through
    ``decode_attention``; under the head_dim layout (the others, under
    "auto") over its head_dim columns of every head, through
    ``decode_scores``, an all-reduce of the partial scores and
    ``decode_combine``: in both no cache byte moves over "model".  Under
    the seq layout each layer's cache is gathered over the axes that cut
    it off the batch before its attention, as is the sequence over the
    data axes when B < dp_size, and the rank keeps its block of what the
    step writes (``transformer._decode_block``).  A recurrent block is
    tensor-parallel and steps the rank's block of its state in place
    (mamba's and the sLSTM's features cut over "model", the mLSTM's
    whole): no recurrent state moves.  The step returns this rank's rows
    of ``next_tok`` and of the logits, whole over the vocabulary (the
    head's columns are the rank's, then gathered), and its block of the
    state."""
    L.set_fp32_matmul()

    def serve_step(params, state, batch):
        specs = part = None
        if mesh is not None:
            from ..launch.mesh import dp_axes, dp_size
            tp = mesh.size(mesh.mesh_dim_names.index(TP)) if TP in mesh.mesh_dim_names else 1
            specs = decode_state_specs(cfg, batch["tokens"].shape[0], dp=dp_axes(mesh),
                                       dp_size=dp_size(mesh), cache_layout=cache_layout,
                                       tp_size=tp)
            batch, part = _local_batch(batch, cfg, mesh)
        logits, state = T.decode_step(params, state, batch["tokens"], batch["lengths"], cfg,
                                      enc_out=batch.get("enc_out"), write=batch.get("write"),
                                      part=part, state_specs=specs)
        # mask vocab-padding ids (embed table is padded to a 256 multiple)
        if cfg.padded_vocab != cfg.vocab:
            valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
            logits = logits.masked_fill(~valid[None, :], float("-inf"))
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, state
    return serve_step


# ---------------------------------------------------------------------------
# shapes and FLOPs, on the meta device (nothing is allocated)
# ---------------------------------------------------------------------------
class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: the initializers draw
    on ``gen.device``, so they build every leaf's shape and dtype and
    allocate nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors: shapes and dtypes
    without storage (the reference's ``jax.eval_shape`` over the init)."""
    return T.init_params(_MetaGenerator(), cfg)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every model input of an (arch, shape) cell:
    tokens and labels (train), tokens (prefill), or one token and the
    lengths (decode); ``prefix_embeds`` for the vision stub (train and
    prefill), ``frames`` (train and prefill) or ``enc_out`` (decode) for
    an encoder-decoder, in ``cfg.dtype``."""
    B, S = shape.global_batch, shape.seq_len
    f = getattr(torch, cfg.dtype)

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": spec((B, S))}
        if shape.kind == "train":
            batch["labels"] = spec((B, S))
        if cfg.frontend == "vision_stub":
            batch["prefix_embeds"] = spec((B, cfg.n_prefix_embeds, cfg.d_model), f)
        if cfg.is_encdec:
            batch["frames"] = spec((B, S, cfg.d_model), f)
        return batch
    # decode: one new token against a cache of size S
    batch = {"tokens": spec((B,)), "lengths": spec((B,))}
    if cfg.is_encdec:
        batch["enc_out"] = spec((B, S, cfg.d_model), f)
    return batch


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``transformer.init_decode_state`` as ``meta`` tensors."""
    return T.init_decode_state(cfg, batch, max_len, torch.device("meta"))


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train), 2·N_active·tokens (prefill,
    or one token a sequence in decode): the 'useful compute' of a step,
    without attention's score products."""
    n_active = _active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token: every leaf, with each MoE layer's
    routed expert stacks (``moe/w_gate``, ``moe/w_up``, ``moe/w_down``)
    counted at top_k / n_experts.  The shared expert (``moe/shared``) runs
    on every token and counts in full, as the reference's docstring says
    ("top_k + shared experts"); the reference's code scales it by
    top_k / n_experts too, so this count is higher by the shared expert's
    parameters times (1 - top_k / n_experts)."""
    tree = abstract_params(cfg)
    total = float(sum(t.numel() for t in leaves(tree)))
    if cfg.moe is not None:
        frac = 1.0 - cfg.moe.top_k / cfg.moe.n_experts
        for slot in tree["body"].values():
            if "moe" in slot:
                total -= frac * sum(float(slot["moe"][w].numel())
                                    for w in ("w_gate", "w_up", "w_down"))
    return total


# ---------------------------------------------------------------------------
# sharding specs: the reference's PartitionSpec of every leaf, as a tuple
# of mesh axis names (or None) per tensor dimension
# ---------------------------------------------------------------------------
#: each leaf's spec by its name (``layers.dense_init(..., (FSDP, TP))`` and
#: the other initializers of the reference); a per-period stack adds a
#: leading None
_LEAF_SPECS = {
    "embed": (TP, None), "lm_head": (None, TP), "scale": (None,),
    # attention (self and cross), the dense MLP and a MoE's shared expert
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP), "wo": (TP, FSDP),
    "q_norm": (None,), "k_norm": (None,),
    "w_gate": (FSDP, TP), "w_up": (FSDP, TP), "w_down": (TP, FSDP),
    "router": (None, None),
    # mamba
    "w_in": (FSDP, TP), "w_out": (TP, FSDP), "conv_w": (None, TP), "conv_b": (TP,),
    "w_bc": (FSDP, None), "w_dt": (FSDP, TP), "dt_bias": (TP,), "A_log": (TP, None),
    "D_skip": (TP,),
    # mLSTM and sLSTM
    "w_q": (FSDP, TP), "w_k": (FSDP, TP), "w_v": (FSDP, TP), "w_if": (FSDP, None),
    "if_bias": (None,), "skip_scale": (TP,), "w_x": (FSDP, TP), "w_h": (None, FSDP, TP),
    "bias": (None,), "w_ff_up": (FSDP, TP), "w_ff_down": (TP, FSDP),
}
#: a MoE layer's routed experts, stacked on a leading expert axis that the
#: TP/EP axis shards
_EXPERT_SPEC = (TP, FSDP, None)
_STACKED = ("body", "enc_body")


def _spec_walk(tree, path: tuple):
    if isinstance(tree, dict):
        return {k: _spec_walk(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_walk(v, path) for v in tree]
    name = path[-1]
    spec = (_EXPERT_SPEC if len(path) > 1 and path[-2] == "moe"
            and name in ("w_gate", "w_up", "w_down") else _LEAF_SPECS[name])
    if len(spec) + (path[0] in _STACKED) != tree.dim():
        raise ValueError(f"spec_tree: leaf {'/'.join(path)} {tuple(tree.shape)} has no "
                         f"spec of its rank (got {spec})")
    return (None,) + spec if path[0] in _STACKED else spec


@functools.lru_cache(maxsize=64)
def spec_tree(cfg: ModelConfig) -> dict:
    """The params' tree with each leaf's spec: a tuple with one entry per
    tensor dimension, the mesh axis that shards it or None (the
    reference's ``PartitionSpec``, leaf for leaf).  Built once per config
    (as the reference caches it); callers do not change it."""
    return _spec_walk(abstract_params(cfg), ())


def opt_spec_tree(params_specs: dict, opt_cfg: AdamWConfig, cfg: ModelConfig,
                  abstract=None) -> dict:
    """The AdamW state's specs: f32/bf16 moments mirror the params; an
    int8 moment of a quantized leaf (``adamw._leaf_quantized``) shards its
    ``q`` as the param and its per-row ``scale`` without the last (row)
    dimension, as the reference's ``qspec``; ``step`` is replicated."""
    if opt_cfg.state_dtype == "int8":
        if abstract is None:
            abstract = abstract_params(cfg)

        def qspec(a, s):
            if _leaf_quantized(a):
                full = tuple(s) + (None,) * (a.dim() - len(s))
                return {"q": full, "scale": full[:-1]}
            return s
        m = map_like(qspec, abstract, params_specs)
        return {"m": m, "v": m, "step": ()}
    return {"m": params_specs, "v": params_specs, "step": ()}


def param_shardings(cfg: ModelConfig, mesh) -> dict:
    """The params' tree with each leaf's placements on ``mesh`` (a
    ``DeviceMesh``): one ``Shard(dim)`` or ``Replicate()`` per mesh axis."""
    from ..distributed.sharding import placements
    return map_like(lambda _, s: placements(s, mesh), abstract_params(cfg), spec_tree(cfg))


def decode_state_specs(cfg: ModelConfig, batch: int, dp="data", dp_size: int = 16,
                       cache_layout: str = "auto", tp_size: int = 16) -> dict:
    """Specs of the decode state (the reference's, layout for layout).

    ``cache_layout``: "seq" puts the cache's sequence over TP; "head_dim"
    its head_dim; "kv_head" its KV heads (when n_kv_heads divides by
    ``tp_size``); "auto" takes kv_head when it divides, else head_dim.  A
    batch too small for ``dp_size`` puts the cache's sequence over ``dp``
    instead.  Recurrent states shard the batch over data and features
    over TP."""
    b = dp if (batch % max(dp_size, 1) == 0 and batch >= dp_size) else None
    seq_axis = None if b is not None else dp
    if cache_layout in ("auto", "head_dim", "kv_head"):
        use_kv = (cfg.n_kv_heads % max(tp_size, 1) == 0
                  if cache_layout == "auto" else cache_layout == "kv_head")
    else:
        use_kv = False
    if cache_layout == "seq":
        attn_spec, prefix_spec = (None, b, None, TP, None), (b, None, TP, None)
    elif use_kv:
        attn_spec, prefix_spec = (None, b, TP, seq_axis, None), (b, TP, seq_axis, None)
    else:
        attn_spec, prefix_spec = (None, b, None, seq_axis, TP), (b, None, seq_axis, TP)

    def per_slot(kind):
        if kind == "attn":
            return {"k": attn_spec, "v": attn_spec}
        if kind == "mamba":
            return ((None, b, None, TP), (None, b, TP, None))   # conv, h
        if kind == "mlstm":
            return ((None, b, None, None, None), (None, b, None, None), (None, b, None))
        if kind == "slstm":
            return ((None, b, TP),) * 4
        raise ValueError(kind)

    specs: dict = {f"slot{s_idx}": per_slot(kind) for s_idx, kind in enumerate(cfg.block_pattern)}
    if cfg.n_dense_prefix:
        specs["prefix"] = [{"k": prefix_spec, "v": prefix_spec}
                           for _ in range(cfg.n_dense_prefix)]
    return specs
