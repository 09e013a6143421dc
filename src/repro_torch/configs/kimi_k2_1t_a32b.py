"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840; MoE 384 experts top-8 + 1 shared, first layer dense
(arXiv:2501.kimi2, paper-table config).

Trillion-parameter: the config that stresses EP×TP×FSDP sharding and the
int8-quantized optimizer states (runtime/train default for this arch —
f32 moments alone would be 8 TB; see EXPERIMENTS.md §Dry-run memory).
Dense prefix FFN width = top_k × d_ff_expert (activated-width-matched).
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=16384,           # dense prefix layer (top_k × d_ff_expert)
        vocab=163840,
        d_head=112,
        block_pattern=("attn",),
        moe_every=1,
        n_dense_prefix=1,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
        tie_embeddings=False,
    )
