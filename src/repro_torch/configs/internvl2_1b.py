"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 (arXiv:2404.16821).

The InternViT frontend is a STUB: input_specs() provides precomputed
patch embeddings (B, 256, d_model) prepended to the text sequence; loss
masks the image prefix.  The backbone (Qwen2-0.5B-shape) is fully real.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151655,
        d_head=64,
        frontend="vision_stub",
        n_prefix_embeds=256,
        tie_embeddings=True,
    )
