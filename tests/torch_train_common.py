"""Shared by the port's training tests (``tests/test_torch_train_*.py``),
which compare its training path with the JAX package's: the batches,
the gradient comparison and xlstm's witness, and the f32 train step of a
reduced family against JAX's (``train_step_matches_jax``, run by each
family's file).

Tolerances: f32 losses and gradients agree to 3e-5 (tests/test_kernels.py's
f32 tolerance; the sums run in another order) — gradients with an
absolute floor of 3e-5 times the leaf's largest gradient.  After 3 AdamW
steps of lr 1e-3 the parameters agree to 3 lr: AdamW's first step moves a
weight by about lr * sign(g), and a gradient within rounding of zero may
take either sign in the two packages.  xlstm's random layers amplify
rounding (each block alone holds 3e-5, tests/test_torch_ssm.py): its
gradients, losses and parameters are held to twice the port's own
witness, the largest change of each under two 1e-7 perturbations of the
embedding table.  bf16: the packages round matmul
and norm outputs to bf16 at different places, so a bf16 loss agrees to
2e-2 relative (tests/test_kernels.py's bf16 tolerance) and a bf16
gradient is held, in the mean, to 5% of the leaf's mean gradient."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
LR = 1e-3
WITNESS_DRAWS = 2         # perturbations of xlstm's embeddings behind its witness
XLSTM_WITNESS_MAX = 1e-2  # a witness past this would make its tolerance vacuous


def _batch(cfg, B, S, seed, n_frames=None):
    """Tokens and next-token labels (some masked), as (jax, torch) dicts;
    with the family's stub input: ``frames`` (B, n_frames, D) for an
    encoder-decoder, ``prefix_embeds`` (B, Np, D) for the vision stub."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    labels[0, :3] = -1
    arrays = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        arrays["frames"] = rs.randn(B, n_frames, cfg.d_model).astype(np.float32)
    if cfg.frontend == "vision_stub":
        arrays["prefix_embeds"] = rs.randn(B, cfg.n_prefix_embeds, cfg.d_model).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _jflat(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _grads_close(got, want, rel):
    """Each leaf within TOL, with an absolute floor of ``rel`` times the
    leaf's largest gradient."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"],
                                   atol=max(TOL["atol"], rel * float(np.abs(w).max())))


def _with_cf(cfg, cf):
    return cfg if cf is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _adamw_losses(params, cfg, frames, steps=3):
    """The port's losses over ``steps`` AdamW steps (lr LR) on the test's
    batches, and the parameters after them."""
    tcfg = AdamWConfig(lr=LR)
    step, opt, losses = M.make_train_step(cfg, tcfg, total_steps=20), adamw_init(params, tcfg), []
    for i in range(steps):
        params, opt, aux = step(params, opt, _batch(cfg, 2, 24, seed=10 + i, n_frames=frames)[1])
        losses.append(float(aux["loss"]))
    return losses, params


def _witness(params, batch, cfg, grads, losses, after):
    """The port's own sensitivity: with the embedding table perturbed by
    1e-7 (relative; WITNESS_DRAWS seeded normal draws), the largest
    change of its f32 gradients, relative to each leaf's largest, and of
    each of its losses over the AdamW steps (AdamW moves a weight by ~lr
    whatever the size of its gradient, so a gradient within rounding of
    zero may step either way), and of each parameter leaf after them."""
    g_worst, l_worst, p_worst = 0.0, [0.0] * len(losses), [0.0] * len(leaves(after))
    for i in range(WITNESS_DRAWS):
        noise = np.random.RandomState(100 + i).randn(*params["embed"].shape).astype(np.float32)
        moved = dict(params, embed=params["embed"] * (1 + 1e-7 * torch.from_numpy(noise)))
        _, g = M.loss_and_grads(moved, batch, cfg)
        g_worst = max(g_worst, max(float((a - b).abs().max() / b.abs().max())
                                   for a, b in zip(leaves(g), leaves(grads))))
        m_losses, m_after = _adamw_losses(moved, cfg, None)
        l_worst = [max(w, abs(a - b)) for w, a, b in zip(l_worst, m_losses, losses)]
        p_worst = [max(w, float((a - b).abs().max()))
                   for w, a, b in zip(p_worst, leaves(m_after), leaves(after))]
    return g_worst, l_worst, p_worst


def train_step_matches_jax(arch, overrides, cf, frames):
    """The reduced family's f32 train step against JAX's: the loss and
    every gradient leaf, then the losses of and parameters after 3 AdamW
    steps (the tolerances of this module's docstring)."""
    cfg_j = _with_cf(jget_config(arch).reduced(**overrides), cf)
    cfg = _with_cf(get_config(arch).reduced(**overrides), cf)
    assert (cfg.qk_norm or cfg.moe is not None or T.recurrent_kinds(cfg) or cfg.is_encdec
            or cfg.frontend != "none")              # the dense cases run qk-norm
    jparams = JM.init_params(cfg_j, seed=1)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jb, tb = _batch(cfg, 2, 24, seed=2, n_frames=frames)

    # the loss and every gradient leaf
    jloss, jgrads = jax.value_and_grad(lambda p: JT.loss_fn(p, jb, cfg_j))(jparams)
    loss, grads = M.loss_and_grads(params, tb, cfg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    tg = [g.numpy() for g in leaves(grads)]
    assert len(tg) == len(jax.tree.leaves(jgrads))
    assert all(g.requires_grad is False for g in leaves(params))

    # three AdamW steps in both packages
    jcfg, tcfg = JAdamWConfig(lr=LR), AdamWConfig(lr=LR)
    jstep = jax.jit(JM.make_train_step(cfg_j, jcfg, total_steps=20))
    tstep = M.make_train_step(cfg, tcfg, total_steps=20)
    jp, js = jparams, j_adamw_init(jparams, jcfg)
    tp, ts = params, adamw_init(params, tcfg)
    jlosses, tlosses = [], []
    for i in range(3):
        jb_i, tb_i = _batch(cfg, 2, 24, seed=10 + i, n_frames=frames)
        jp, js, jaux = jstep(jp, js, jb_i)
        tp, ts, taux = tstep(tp, ts, tb_i)
        jlosses.append(float(jaux["loss"]))
        tlosses.append(float(taux["loss"]))
        assert float(taux["lr_scale"]) == pytest.approx(float(jaux["lr_scale"]), rel=1e-6)
    assert int(ts["step"]) == 3

    # xlstm's random layers amplify rounding (a 1e-7 perturbation of the
    # embeddings moves its gradients by up to ~3e-3 of a leaf's largest,
    # where each block alone holds 3e-5: tests/test_torch_ssm.py), so it
    # is held to twice the port's own witness (within the 3x bound), and
    # the witness itself must stay small
    rel, loss_tol = 3e-5, [1e-4 * abs(x) for x in jlosses]
    param_tol = [3 * LR] * len(leaves(tp))
    if arch == "xlstm-350m":
        g_witness, l_witness, p_witness = _witness(params, tb, cfg, grads, tlosses, tp)
        assert 3e-5 < g_witness <= XLSTM_WITNESS_MAX
        assert max(l_witness) <= XLSTM_WITNESS_MAX * tlosses[0]
        rel = 2 * g_witness
        loss_tol = [max(a, 2 * b) for a, b in zip(loss_tol, l_witness)]
        param_tol = [max(a, 2 * b) for a, b in zip(param_tol, p_witness)]
    _grads_close(tg, _jflat(jgrads), rel)
    for a, b, tol in zip(tlosses, jlosses, loss_tol):
        assert abs(a - b) <= tol, (tlosses, jlosses, loss_tol)
    for got, want, tol in zip(leaves(tp), _jflat(jp), param_tol):
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    # the step returned new trees: the bridged parameters are untouched
    for got, want in zip(leaves(params), _jflat(jparams)):
        np.testing.assert_array_equal(got.numpy(), want)


def _router_logits(T, E, ties, seed):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((T, E)).astype(np.float32) * 2
    if ties:                    # a grid of 0.5, and one row all equal
        x = np.round(x * 2) / 2
        x[0] = 0.25
    return x
