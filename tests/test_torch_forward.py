"""The port's full-sequence forward against the JAX package's: parameters
bridged from JAX ``init_params``, then ``forward``/``loss_fn`` and the
``make_prefill_step``/``make_eval_step`` facades on the same numpy tokens
in both.  Logits and losses within the f32 tolerance of
tests/test_kernels.py (sums in another order).  Also the bfloat16 bridge:
a bf16 parameter tree crosses bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)


def _bridge(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _batch(cfg, B, S, seed, n_masked=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    if n_masked:
        labels[:, :n_masked] = -1                 # a masked prompt prefix
        labels[0, rs.randint(0, S, size=3)] = -1  # and scattered pads
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})


def _check(arch, overrides, B, S, seed=0, n_masked=0, full=False):
    cfg_j = jget_config(arch) if full else jget_config(arch).reduced(**overrides)
    cfg = get_config(arch) if full else get_config(arch).reduced(**overrides)
    jparams = JM.init_params(cfg_j, seed=seed)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, B, S, seed, n_masked)
    want_logits = np.asarray(jax.jit(JM.make_prefill_step(cfg_j))(jparams, jb))
    want_loss = float(jax.jit(JM.make_eval_step(cfg_j))(jparams, jb))
    logits = M.make_prefill_step(cfg)(params, tb)
    loss = M.make_eval_step(cfg)(params, tb)
    assert logits.shape == want_logits.shape == (B, S, cfg.padded_vocab)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    # the module functions under the facades give the same numbers
    with torch.inference_mode():
        assert torch.equal(T.forward(params, tb, cfg), logits)
        np.testing.assert_allclose(
            T.hidden_states(params, tb, cfg).numpy(),
            np.asarray(JT.hidden_states(jparams, jb, cfg_j)), **TOL)
        assert float(T.loss_fn(params, tb, cfg)) == float(loss)
    return cfg, params, tb, float(loss)


def test_forward_and_loss_match_router_reduced():
    _check("wikikv-router", {}, B=2, S=24)


def test_forward_and_loss_match_router_full_width():
    cfg, *_ = _check("wikikv-router", {}, B=1, S=48, full=True)
    assert (cfg.d_model, cfg.n_layers, cfg.vocab, cfg.head_dim) == (256, 4, 8192, 64)


def test_forward_and_loss_match_olmo_nonparametric_norm():
    cfg, *_ = _check("olmo-1b", {}, B=2, S=16, seed=3)
    assert cfg.nonparam_ln


def test_forward_and_loss_match_qwen3_qk_norm():
    cfg, *_ = _check("qwen3-1.7b", {}, B=2, S=20, seed=5)
    assert cfg.qk_norm and cfg.rope_theta == 1e6


def test_loss_masks_negative_labels():
    cfg, params, tb, loss = _check("wikikv-router", {"vocab": 300}, B=2, S=16, seed=2,
                                   n_masked=5)
    # a loss over the unmasked labels only: every label masked but one
    one = {"tokens": tb["tokens"], "labels": torch.full_like(tb["labels"], -1)}
    one["labels"][1, 7] = tb["labels"][1, 7]
    with torch.inference_mode():
        logits = T.forward(params, tb, cfg)[1, 7].float()
    nll = torch.logsumexp(logits, -1) - logits[tb["labels"][1, 7].long()]
    np.testing.assert_allclose(float(M.make_eval_step(cfg)(params, one)), float(nll), **TOL)
    # all masked: 0 / max(0, 1) = 0
    none = {"tokens": tb["tokens"], "labels": torch.full_like(tb["labels"], -1)}
    assert float(M.make_eval_step(cfg)(params, none)) == 0.0


def test_loss_chunking_is_the_same_loss():
    """8 token chunks (B * S divisible) and one chunk (odd B * S) give the
    reference's numbers; the chunked CE equals the unchunked one."""
    cfg, params, tb, loss = _check("wikikv-router", {}, B=1, S=17, seed=4)
    with torch.inference_mode():
        assert float(T.loss_fn(params, tb, cfg, loss_chunks=1)) == loss
    cfg, params, tb, loss = _check("wikikv-router", {}, B=2, S=16, seed=4)
    with torch.inference_mode():
        np.testing.assert_allclose(float(T.loss_fn(params, tb, cfg, loss_chunks=1)), loss,
                                   **TOL)


def test_forward_at_2048_takes_the_chunked_attention():
    ops.reset_launches()
    _check("wikikv-router", {"d_model": 32, "vocab": 256, "d_ff": 64}, B=1, S=2048, seed=6)
    assert ops.LAUNCHES["flash_attention"] == 0          # CPU: plain versions only


def test_bf16_bridge_is_bit_exact():
    cfg_j = jget_config("qwen3-1.7b").reduced(dtype="bfloat16", param_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JM.init_params(cfg_j, seed=9))
    params = params_from_jax(jparams, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) > 10
    for path, leaf in jflat:
        node = params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert leaf.dtype.name == "bfloat16" and node.dtype == torch.bfloat16
        assert tuple(node.shape) == leaf.shape
        assert np.array_equal(node.view(torch.int16).numpy(), leaf.view(np.int16))


def test_bf16_forward_matches_reference():
    """A bf16 model end to end: the same bridged weights in both packages;
    logits within the bf16 tolerance (each package rounds every matmul and
    norm output to bf16, in its own order)."""
    arch = "qwen3-1.7b"
    over = dict(dtype="bfloat16", param_dtype="bfloat16")
    cfg_j, cfg = jget_config(arch).reduced(**over), get_config(arch).reduced(**over)
    jparams = JM.init_params(cfg_j, seed=1)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 1, 32, 1)
    want = np.asarray(jax.jit(JM.make_prefill_step(cfg_j))(jparams, jb), np.float32)
    got = M.make_prefill_step(cfg)(params, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(float(M.make_eval_step(cfg)(params, tb)),
                               float(jax.jit(JM.make_eval_step(cfg_j))(jparams, jb)),
                               atol=2e-2, rtol=2e-2)


def test_forward_runs_every_family():
    """No family is refused any more: MoE (dbrx, kimi) runs since the
    moe_router slice, the SSM and xLSTM families (jamba, xlstm) since
    theirs, enc-dec and vision (whisper, internvl2) since theirs: a finite
    prefill each (their training: tests/test_torch_train_*.py)."""
    for arch in ("dbrx-132b", "kimi-k2-1t-a32b", "jamba-v0.1-52b", "xlstm-350m",
                 "whisper-medium", "internvl2-1b"):
        cfg = get_config(arch).reduced()
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
        if cfg.is_encdec:
            batch["frames"] = torch.ones((1, 6, cfg.d_model))
        n_pfx = cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else 0
        if n_pfx:
            batch["prefix_embeds"] = torch.ones((1, n_pfx, cfg.d_model))
        logits = M.make_prefill_step(cfg)(M.init_params(cfg, device="cpu"), batch)
        assert logits.shape == (1, 4 + n_pfx, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
