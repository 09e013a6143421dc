"""whisper-medium [audio] — enc-dec 24L d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 (arXiv:2212.04356).

The conv frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model) as encoder input.  24 encoder + 24 decoder
layers; decoder blocks add cross-attention over the encoder output.
Decoder is full attention ⇒ long_500k SKIPPED; decode_32k runs with a
32k encoder context (out-of-spec for real Whisper's 1.5k frames but
exercised as assigned).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51865,
        is_encdec=True,
        n_enc_layers=24,
        frontend="audio_stub",
        tie_embeddings=True,
    )
