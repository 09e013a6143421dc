"""The train step of the SSM family against the JAX package's
(``torch_train_common.train_step_matches_jax``): reduced jamba-v0.1-52b —
mamba through the selective scan's autograd Function, attention and MoE —
in f32, parameters bridged from JAX ``init_params``."""
import pytest

from torch_train_common import train_step_matches_jax  # noqa: E402


@pytest.mark.parametrize("arch,overrides,cf,frames", [
    ("jamba-v0.1-52b", {}, None, None),             # mamba (the scan's Function), attn, MoE
], ids=["jamba"])
def test_train_step_matches_jax(arch, overrides, cf, frames):
    train_step_matches_jax(arch, overrides, cf, frames)
