"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm (hf:Qwen/Qwen3-8B family conventions)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        vocab=151936,
        d_head=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
