"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; MoE 16 experts top-4, fine-grained
(hf:databricks/dbrx-base)."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab=100352,
        block_pattern=("attn",),
        moe_every=1,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
        tie_embeddings=False,
    )
