"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba+attention 1:7 interleave, MoE 16 experts top-2 on
every second layer (arXiv:2403.19887).

Period of 8: [mamba, moe-mamba, mamba, attn(moe), mamba, moe-mamba,
mamba, moe-mamba] — attention at slot 3, MoE at odd slots; 4 periods.
Sub-quadratic: only 4/32 layers carry a KV cache, Mamba state is O(1)
⇒ runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        block_pattern=("mamba", "mamba", "mamba", "attn",
                       "mamba", "mamba", "mamba", "mamba"),
        moe_every=2,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
        d_state=16,
        d_conv=4,
        ssm_expand=2,
        sub_quadratic=True,
        tie_embeddings=False,
    )
