"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32 = MHA)
d_ff=13440 vocab=92416 (hf:Qwen/CodeQwen1.5-7B)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab=92416,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )
