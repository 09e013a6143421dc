"""Model configuration schema shared by all 10 assigned architectures.

One dataclass covers dense / MoE / SSM / hybrid / enc-dec families via a
per-period ``block_pattern`` (the scan unit): e.g. jamba's 1:7
attention:mamba interleave is ``["mamba"]*3 + ["attn"] + ["mamba"]*4``
with MoE on every second layer, scanned over 4 periods.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

BlockKind = Literal["attn", "mamba", "mlstm", "slstm"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared (always-on) experts, kimi-style
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 → d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False       # qwen3
    nonparam_ln: bool = False   # olmo: layernorm without learned affine
    tie_embeddings: bool = True
    norm_eps: float = 1e-6

    # block layout: pattern repeated n_layers/len(pattern) times by scan;
    # first ``n_dense_prefix`` layers are unrolled with dense FFN even in a
    # MoE model (kimi convention).
    block_pattern: tuple[BlockKind, ...] = ("attn",)
    moe_every: int = 0          # 0 = no MoE; else MoE FFN on layers i%moe_every==0
    n_dense_prefix: int = 0
    moe: MoEConfig | None = None

    # SSM (mamba) block parameters
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2

    # xLSTM block parameters
    xlstm_heads: int = 4

    # encoder-decoder (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: inputs are precomputed embeddings
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    n_prefix_embeds: int = 0    # vlm: patch embeddings prepended to text

    # attention structure flags
    sub_quadratic: bool = False  # supports long_500k (ssm / hybrid)

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded to a 256 multiple so the vocab dim
        shards evenly over any TP axis ≤ 256 (whisper's 51865 and
        internvl's 151655 are not 16-divisible).  Logits are emitted at
        this width; serve_step masks the pad ids."""
        return -(-self.vocab // 256) * 256

    @property
    def n_periods(self) -> int:
        body = self.n_layers - self.n_dense_prefix
        assert body % len(self.block_pattern) == 0, \
            (self.n_layers, self.n_dense_prefix, self.block_pattern)
        return body // len(self.block_pattern)

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None or layer_idx < self.n_dense_prefix:
            return False
        if self.moe_every <= 0:
            return False
        return (layer_idx - self.n_dense_prefix) % self.moe_every == 0

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small: dict = dict(
            n_layers=len(self.block_pattern) * (2 if self.n_dense_prefix == 0 else 1)
            + self.n_dense_prefix,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            d_head=16,
            vocab=256,
            d_state=8,
            xlstm_heads=2,
            n_enc_layers=2 if self.is_encdec else 0,
            n_prefix_embeds=8 if self.n_prefix_embeds else 0,
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe is not None:
            small["moe"] = replace(self.moe, n_experts=4,
                                   top_k=min(self.moe.top_k, 2), d_ff_expert=64)
        small.update(overrides)
        return replace(self, **small)
