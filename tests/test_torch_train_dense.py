"""The train step of the dense and MoE families against the JAX package's
(``torch_train_common.train_step_matches_jax``): reduced wikikv-router and
reduced qwen3 (qk-norm), reduced dbrx-132b and kimi-k2 (MoE; kimi with a
dense prefix layer and a shared expert, at its own head_dim 112 too), dbrx
at a capacity that drops assignments, in f32, parameters bridged from JAX
``init_params``; and a bf16 step of reduced qwen3 (bf16 parameters and
activations) within the bf16 tolerance (the tolerances are
``torch_train_common``'s)."""
import pytest
import math

import jax
import numpy as np

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from torch_train_common import LR, _batch, _jflat  # noqa: E402
from torch_train_common import train_step_matches_jax  # noqa: E402


@pytest.mark.parametrize("arch,overrides,cf,frames", [
    ("wikikv-router", {}, None, None),
    ("qwen3-1.7b", dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, n_layers=2), None, None),
    ("dbrx-132b", {}, None, None),
    ("kimi-k2-1t-a32b", {}, None, None),            # a dense prefix layer and a shared expert
    ("kimi-k2-1t-a32b", {"d_head": 112}, None, None),  # kimi's own head_dim
    ("dbrx-132b", {}, 0.25, None),                  # capacity 6 of ~24 a expert: drops
], ids=["router", "qwen3", "dbrx", "kimi-k2", "kimi-k2-d112", "dbrx-drops"])
def test_train_step_matches_jax(arch, overrides, cf, frames):
    train_step_matches_jax(arch, overrides, cf, frames)


def test_bf16_train_step_within_bf16_tolerance():
    over = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, n_layers=2,
                dtype="bfloat16", param_dtype="bfloat16")
    cfg_j = jget_config("qwen3-1.7b").reduced(**over)
    cfg = get_config("qwen3-1.7b").reduced(**over)
    jparams = JM.init_params(cfg_j, seed=4)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in leaves(params))
    jb, tb = _batch(cfg, 2, 32, seed=5)
    jloss, jgrads = jax.value_and_grad(lambda p: JT.loss_fn(p, jb, cfg_j))(jparams)
    loss, grads = M.loss_and_grads(params, tb, cfg)
    assert math.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    for g, w in zip(leaves(grads), _jflat(jgrads)):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).mean()
        assert err <= 0.05 * np.abs(w).mean() + 1e-6
    tp, ts, aux = M.make_train_step(cfg, AdamWConfig(lr=LR), total_steps=10)(
        params, adamw_init(params, AdamWConfig(lr=LR)), tb)
    assert ts["m"]["embed"].dtype == torch.float32
    for new, old in zip(leaves(tp), leaves(params)):
        assert new.dtype == torch.bfloat16
        # one step moves a weight by at most ~lr (plus one bf16 rounding)
        assert float((new.float() - old.float()).abs().max()) <= 2 * LR + 2 ** -7 * float(
            old.float().abs().max())
