"""wikikv-router — the paper's own LM: the distilled CLASSIFY/NEEDSDEEPER
router of §V-B plus the navigation summarizer.  Small enough to train in
examples/train_router.py on CPU and to serve as the ModelOracle."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="wikikv-router",
        family="dense",
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=768,
        vocab=8192,
        d_head=64,
        qk_norm=True,
        tie_embeddings=True,
        dtype="float32",
        param_dtype="float32",
    )
