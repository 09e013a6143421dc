"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks (arXiv:2405.04517): periods of 7 mLSTM + 1 sLSTM
(the paper's sparse-sLSTM placement), 3 periods = 24 layers.  d_ff=0 —
blocks carry their own up/down projections.  Recurrent decode state ⇒
sub-quadratic, runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        xlstm_heads=4,
        block_pattern=("mlstm",) * 7 + ("slstm",),
        sub_quadratic=True,
        tie_embeddings=True,
    )
