"""The port's serving LM against the JAX package's: parameters bridged
from JAX ``init_params``, then the same serve steps on both — logits
within the f32 tolerance of tests/test_kernels.py (sums in another order)
and greedy tokens equal."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ALIASES, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)


def _bridge(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _run_both(cfg_j, cfg, n_steps, batch=3, max_len=32, seed=0):
    jparams = JM.init_params(cfg_j, seed=seed)
    params = _bridge(jparams)
    jserve = jax.jit(JM.make_serve_step(cfg_j))
    serve = M.make_serve_step(cfg)
    jstate = JT.init_decode_state(cfg_j, batch, max_len)
    state = T.init_decode_state(cfg, batch, max_len, "cpu")
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=batch).astype(np.int32)
    lens = np.array([0, 3, 7][:batch], np.int32)
    for _ in range(n_steps):
        jn, jl, jstate = jserve(jparams, jstate, {"tokens": toks, "lengths": lens})
        tn, tl, state = serve(params, state, {"tokens": torch.from_numpy(toks),
                                              "lengths": torch.from_numpy(lens)})
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy()[:, :cfg.vocab], jl[:, :cfg.vocab], **TOL)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        toks = np.asarray(jn).astype(np.int32)
        lens = lens + 1
    return tl


def test_bridge_keeps_the_parameter_tree():
    cfg_j = jget_config("wikikv-router").reduced()
    jparams = JM.init_params(cfg_j, seed=1)
    params = _bridge(jparams)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) > 10
    for path, leaf in jflat:
        node = params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.numpy(), np.asarray(leaf))
    # the port's own initializer builds the same tree shape
    own = M.init_params(get_config("wikikv-router").reduced(), seed=1, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jparams)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), own))


def test_serve_steps_match_reduced():
    cfg_j = jget_config("wikikv-router").reduced()
    cfg = get_config("wikikv-router").reduced()
    _run_both(cfg_j, cfg, n_steps=8)


def test_serve_steps_match_full_width_router():
    cfg_j = jget_config("wikikv-router")
    cfg = get_config("wikikv-router")
    assert (cfg.d_model, cfg.n_layers, cfg.vocab, cfg.head_dim) == (256, 4, 8192, 64)
    _run_both(cfg_j, cfg, n_steps=2, batch=2, max_len=16)


def test_pad_vocab_is_masked():
    cfg_j = jget_config("wikikv-router").reduced(vocab=300)
    cfg = get_config("wikikv-router").reduced(vocab=300)
    assert cfg.padded_vocab == 512
    logits = _run_both(cfg_j, cfg, n_steps=3)
    assert torch.all(torch.isneginf(logits[:, cfg.vocab:]))
    assert torch.all(torch.isfinite(logits[:, :cfg.vocab]))


def test_olmo_nonparametric_norm_matches():
    cfg_j = jget_config("olmo-1b").reduced()
    cfg = get_config("olmo-1b").reduced()
    assert cfg.nonparam_ln
    _run_both(cfg_j, cfg, n_steps=3)


def test_configs_are_copied_and_every_family_inits():
    from repro.configs import ALIASES as JALIASES
    assert ALIASES == JALIASES
    for arch in ALIASES:
        assert repr(get_config(arch)).replace("repro_torch", "repro") == \
            repr(jget_config(arch)).replace("repro_torch", "repro")
    # no family refuses any more: MoE since its slice, the SSM and xLSTM
    # families since theirs, enc-dec and vision since theirs, training too
    for arch in ("dbrx-132b", "kimi-k2-1t-a32b", "xlstm-350m", "jamba-v0.1-52b",
                 "whisper-medium", "internvl2-1b"):
        M.init_params(get_config(arch).reduced(), device="cpu")
    assert not hasattr(M, "check_trainable")
