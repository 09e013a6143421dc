"""The train step of the encoder-decoder and vision families against the
JAX package's (``torch_train_common.train_step_matches_jax``): reduced
whisper-medium (16 and 40 frames under 24 tokens) and internvl2-1b (8
prefix embeddings, their labels -1) in f32, parameters bridged from JAX
``init_params``."""
import pytest

from torch_train_common import train_step_matches_jax  # noqa: E402


@pytest.mark.parametrize("arch,overrides,cf,frames", [
    ("whisper-medium", {}, None, 16),               # frames fewer than the 24 tokens
    ("whisper-medium", {}, None, 40),               # and more
    ("internvl2-1b", {}, None, None),               # 8 prefix embeddings, their labels -1
], ids=["whisper-16-frames", "whisper-40-frames", "internvl2"])
def test_train_step_matches_jax(arch, overrides, cf, frames):
    train_step_matches_jax(arch, overrides, cf, frames)
