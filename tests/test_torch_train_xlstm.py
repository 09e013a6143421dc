"""The train step of the xLSTM family against the JAX package's
(``torch_train_common.train_step_matches_jax``): reduced xlstm-350m
(mLSTM chunks of 8 and the sLSTM) in f32, parameters bridged from JAX
``init_params``, held to twice the port's own witness because its random
layers amplify rounding (``torch_train_common``'s docstring)."""
import pytest

from torch_train_common import train_step_matches_jax  # noqa: E402


@pytest.mark.parametrize("arch,overrides,cf,frames", [
    ("xlstm-350m", {}, None, None),                 # mLSTM chunks of 8 and sLSTM: the witness
], ids=["xlstm"])
def test_train_step_matches_jax(arch, overrides, cf, frames):
    train_step_matches_jax(arch, overrides, cf, frames)
