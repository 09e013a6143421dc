"""The port's training path against the JAX package's.

* ``make_train_step`` on reduced wikikv-router and reduced qwen3 (qk-norm),
  reduced dbrx-132b and kimi-k2 (MoE; kimi with a dense prefix layer and
  a shared expert), dbrx at a capacity that drops assignments, reduced
  jamba (mamba through the scan's autograd Function, attention, MoE),
  xlstm, whisper (16 and 40 frames under 24 tokens) and internvl2 (8
  prefix embeddings), in f32, parameters bridged from JAX
  ``init_params``: the loss and every gradient leaf (the router's
  included) against ``jax.value_and_grad(T.loss_fn)``, and the losses of
  and parameters after 3 steps against JAX's ``make_train_step``;
* a bf16 step (bf16 parameters and activations);
* the plain backward versions (``ref.attention_bwd_ref``,
  ``ref.rmsnorm_bwd_ref``, ``ref.moe_router_bwd_ref`` at both
  ``renormalize`` settings and with ties) against torch autograd of the
  plain forwards and against ``jax.vjp`` of ``repro.kernels.ref``; a
  dropped assignment's gate gets a gradient of 0 in both packages;
* the autograd Functions of ``kernels.ops`` with their kernel entry
  points pointed at the plain versions (the CUDA kernels have no CPU
  mode), through ``torch.autograd.gradcheck`` in f64 (the attention at
  non-causal Sq > Skv too), and dbrx's, jamba's, xlstm's, whisper's and
  internvl2's losses through them against the CPU path, with one
  backward a forward call of each kernel;
* the crash-restart of ``tests/test_checkpoint_runtime.py``, and
  ``launch.train --device cpu --reduced`` (the router, jamba and xlstm).

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
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_cuda import train_launches  # noqa: E402

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


@pytest.mark.parametrize("arch,overrides,cf,frames", [
    ("wikikv-router", {}, None, None),
    ("qwen3-1.7b", dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, n_layers=2), None, None),
    ("dbrx-132b", {}, None, None),
    ("kimi-k2-1t-a32b", {}, None, None),            # a dense prefix layer and a shared expert
    ("kimi-k2-1t-a32b", {"d_head": 112}, None, None),  # kimi's own head_dim
    ("dbrx-132b", {}, 0.25, None),                  # capacity 6 of ~24 a expert: drops
    ("jamba-v0.1-52b", {}, None, None),             # mamba (the scan's Function), attn, MoE
    ("xlstm-350m", {}, None, None),                 # mLSTM chunks of 8 and sLSTM: the witness
    ("whisper-medium", {}, None, 16),               # frames fewer than the 24 tokens
    ("whisper-medium", {}, None, 40),               # and more
    ("internvl2-1b", {}, None, None),               # 8 prefix embeddings, their labels -1
], ids=["router", "qwen3", "dbrx", "kimi-k2", "kimi-k2-d112", "dbrx-drops", "jamba", "xlstm", "whisper-16-frames",
        "whisper-40-frames", "internvl2"])
def test_train_step_matches_jax(arch, overrides, cf, frames):
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


# ---------------------------------------------------------------------------
# the plain backward versions
# ---------------------------------------------------------------------------
ATTN_CASES = [  # (B, Hq, Hkv, Sq, Skv, D, causal)
    (2, 4, 2, 9, 9, 16, True), (1, 6, 1, 5, 12, 32, True), (1, 4, 4, 7, 11, 16, False),
    (2, 8, 2, 16, 16, 64, True),
    # non-causal with more queries than keys: whisper's cross-attention
    # with a decoder longer than its frames
    (2, 4, 2, 13, 5, 16, False), (1, 4, 4, 24, 12, 32, False)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_bwd_ref_matches_autograd_and_jax_vjp(case):
    B, Hq, Hkv, Sq, Skv, D, causal = case
    rs = np.random.RandomState(sum(case))
    qn = rs.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    kn = rs.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    vn = rs.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    don = rs.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    o, lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
    want = torch.autograd.grad(o, (q, k, v), torch.from_numpy(don))
    lse = lse.detach()
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), lse,
                                torch.from_numpy(don), causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=causal),
                     jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    jgot = vjp(jnp.asarray(don))
    for g, w, j in zip(got, want, jgot):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
    # the lse is the rows' log-sum-exp of the scaled, masked scores
    s = torch.einsum("bhqd,bhkd->bhqk", q.detach(), k.detach().repeat_interleave(
        Hq // Hkv, 1)) / math.sqrt(D)
    if causal:
        s = s.masked_fill(~ref._causal_mask(Sq, Skv, "cpu"), -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), **TOL)


@pytest.mark.parametrize("shape,scaled", [((5, 16), True), ((3, 4, 128), True), ((7, 64), False),
                                          ((2, 256), True)])
def test_rmsnorm_bwd_ref_matches_autograd_and_jax_vjp(shape, scaled):
    rs = np.random.RandomState(len(shape) + shape[-1])
    xn = rs.standard_normal(shape).astype(np.float32)
    sn = rs.standard_normal(shape[-1]).astype(np.float32) if scaled else None
    dyn = rs.standard_normal(shape).astype(np.float32)
    x = torch.from_numpy(xn).requires_grad_(True)
    s = torch.from_numpy(sn).requires_grad_(True) if scaled else None
    y = ref.rmsnorm_ref(x, s)
    want = torch.autograd.grad(y, (x, s) if scaled else (x,), torch.from_numpy(dyn))
    dx, ds = ref.rmsnorm_bwd_ref(x.detach(), s.detach() if scaled else None,
                                 torch.from_numpy(dyn))
    if scaled:
        _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b), jnp.asarray(xn), jnp.asarray(sn))
        jdx, jds = vjp(jnp.asarray(dyn))
        np.testing.assert_allclose(ds.numpy(), want[1].numpy(), **TOL)
        np.testing.assert_allclose(ds.numpy(), np.asarray(jds), **TOL)
    else:
        assert ds is None
        _, vjp = jax.vjp(lambda a: jref.rmsnorm_ref(a, None), jnp.asarray(xn))
        (jdx,) = vjp(jnp.asarray(dyn))
    np.testing.assert_allclose(dx.numpy(), want[0].numpy(), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)


ROUTER_CASES = [  # (T, E, k, ties)
    (9, 4, 2, False), (33, 16, 4, False), (7, 384, 8, False), (12, 16, 4, True),
    (5, 6, 1, True), (4, 8, 8, True),
    (11, 32, 8, False),         # kimi-k2's train step, cut to 32 experts
    (10, 17, 3, True)]          # a row of 17 experts: not a multiple of 16 bytes


def _router_logits(T, E, ties, seed):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((T, E)).astype(np.float32) * 2
    if ties:                    # a grid of 0.5, and one row all equal
        x = np.round(x * 2) / 2
        x[0] = 0.25
    return x


@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("case", ROUTER_CASES, ids=str)
def test_moe_router_bwd_ref_matches_autograd_and_jax_vjp(case, renormalize):
    """The explicit formula against torch autograd of the plain forward
    and ``jax.vjp`` of the reference router; with ties the gradient goes
    to the ids the forward chose (the lowest of equal probabilities), in
    all three."""
    T, E, k, ties = case
    xn = _router_logits(T, E, ties, seed=T + E + k)
    gn = np.random.RandomState(k).standard_normal((T, k)).astype(np.float32)
    x = torch.from_numpy(xn).requires_grad_(True)
    w, idx = ref.moe_router_ref(x, k, renormalize=renormalize)
    want = torch.autograd.grad(w, x, torch.from_numpy(gn))[0]
    got = ref.moe_router_bwd_ref(x.detach(), w.detach(), idx, torch.from_numpy(gn),
                                 renormalize=renormalize)
    (jw, jidx), vjp = jax.vjp(lambda z: jref.moe_router_ref(z, k, renormalize=renormalize),
                              jnp.asarray(xn))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jgot = vjp((jnp.asarray(gn), np.zeros((T, k), jax.dtypes.float0)))[0]
    assert got.dtype == torch.float32 and got.shape == (T, E)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)
    if renormalize:             # only the chosen logits get a gradient
        off = torch.ones(T, E, dtype=torch.bool).scatter_(1, idx.long(), False)
        assert bool((got[off] == 0).all())
        np.testing.assert_array_equal(
            ref.moe_router_bwd_ref(None, w.detach(), idx, torch.from_numpy(gn),
                                   n_experts=E).numpy(), got.numpy())


def test_bwd_refs_cast_as_the_plain_versions_do():
    x = torch.randn(4, 64).to(torch.bfloat16)
    s = torch.randn(64)
    dx, ds = ref.rmsnorm_bwd_ref(x, s, torch.randn(4, 64).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    q = torch.randn(1, 2, 4, 16).to(torch.bfloat16)
    k = torch.randn(1, 1, 4, 16).to(torch.bfloat16)
    o, lse = ref.attention_ref(q, k, k, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = ref.attention_bwd_ref(q, k, k, o, lse, torch.randn_like(o))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [tuple(g.shape) for g in grads] == [(1, 2, 4, 16), (1, 1, 4, 16), (1, 1, 4, 16)]


# ---------------------------------------------------------------------------
# the autograd Functions, wired to the plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def functions_on_plain(monkeypatch):
    """ops as it runs on the card, its kernel entry points replaced by
    the plain versions; the launches are counted per entry point."""
    calls = {"fwd": 0, "bwd": 0, "rms": 0, "rms_bwd": 0, "router": 0, "router_bwd": 0}

    def flash(q, k, v, *, causal, sm_scale, with_lse=False):
        calls["fwd"] += 1
        return ref.attention_ref(q, k, v, causal=causal, sm_scale=sm_scale, return_lse=with_lse)

    def flash_bwd(q, k, v, o, lse, do, *, causal, sm_scale):
        calls["bwd"] += 1
        return ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale)

    def rms(x, scale, eps):
        calls["rms"] += 1
        return ref.rmsnorm_ref(x, scale, eps=eps)

    def rms_bwd(x, scale, dy, eps):
        calls["rms_bwd"] += 1
        return ref.rmsnorm_bwd_ref(x, scale, dy, eps=eps)

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops, "_flash_kernel", flash)
    monkeypatch.setattr(ops, "_flash_bwd_kernel", flash_bwd)
    monkeypatch.setattr(ops, "_rmsnorm_kernel", rms)
    monkeypatch.setattr(ops, "_rmsnorm_bwd_kernel", rms_bwd)

    def router(logits, k, *, renormalize):
        calls["router"] += 1
        return ref.moe_router_ref(logits, k, renormalize=renormalize)

    def router_bwd(logits, w, idx, dw, *, renormalize, n_experts):
        calls["router_bwd"] += 1
        return ref.moe_router_bwd_ref(logits, w, idx, dw, renormalize=renormalize,
                                      n_experts=n_experts)
    monkeypatch.setattr(ops, "_router_kernel", router)
    monkeypatch.setattr(ops, "_router_bwd_kernel", router_bwd)
    return calls


@pytest.mark.parametrize("case", [(1, 4, 2, 3, 5, 16, True), (2, 2, 1, 4, 4, 16, False),
                                  (1, 6, 3, 2, 2, 32, True), (1, 4, 2, 7, 3, 16, False)],
                         ids=str)
def test_attention_function_gradcheck(functions_on_plain, case):
    B, Hq, Hkv, Sq, Skv, D, causal = case
    g = torch.Generator().manual_seed(sum(case))
    q = torch.randn(B, Hq, Sq, D, generator=g, dtype=torch.float64, requires_grad=True)
    k = torch.randn(B, Hkv, Skv, D, generator=g, dtype=torch.float64, requires_grad=True)
    v = torch.randn(B, Hkv, Skv, D, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.attention(a, b, c, causal=causal, sm_scale=0.3), (q, k, v))
    assert functions_on_plain["fwd"] > 0 and functions_on_plain["bwd"] > 0
    # without grad the kernel runs as for inference: no lse, no Function
    with torch.no_grad():
        n = functions_on_plain["fwd"]
        assert ops.attention(q, k, v, causal=causal).grad_fn is None
        assert functions_on_plain["fwd"] == n + 1


@pytest.mark.parametrize("scaled", [True, False])
def test_rmsnorm_function_gradcheck(functions_on_plain, scaled):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, 16, generator=g, dtype=torch.float64, requires_grad=True)
    s = torch.randn(16, generator=g, dtype=torch.float64, requires_grad=True) if scaled else None
    inputs = (x, s) if scaled else (x,)
    assert torch.autograd.gradcheck(lambda *a: ops.rmsnorm(a[0], a[1] if scaled else None,
                                                           eps=1e-5), inputs)
    assert functions_on_plain["rms_bwd"] > 0
    # a scale alone requiring grad still reaches the Function
    if scaled:
        n = functions_on_plain["rms_bwd"]
        ops.rmsnorm(x.detach(), s).sum().backward()
        assert functions_on_plain["rms_bwd"] == n + 1 and s.grad is not None


@pytest.mark.parametrize("renormalize", [True, False])
def test_moe_router_function_gradcheck(functions_on_plain, renormalize):
    """``ops.moe_router`` under grad on the card's path: the Function, its
    forward the kernel, its backward ``moe_router_bwd`` (both pointed at
    the plain versions), the ids non-differentiable."""
    x = torch.from_numpy(_router_logits(6, 8, False, seed=1).astype(np.float64))
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda z: ops.moe_router(z, 3, renormalize=renormalize)[0], (x,))
    assert functions_on_plain["router"] > 0 and functions_on_plain["router_bwd"] > 0
    w, idx = ops.moe_router(x, 3, renormalize=renormalize)
    assert type(w.grad_fn).__name__ == "_MoERouterBackward" and not idx.requires_grad
    with torch.no_grad():       # inference: the kernel as it is, no Function
        assert ops.moe_router(x, 3)[0].grad_fn is None


def test_dropped_assignment_gate_gets_no_gradient():
    """The capacity dispatch in both packages at capacity 4 over 16
    tokens' 32 assignments to 4 experts: the gate of every dropped
    assignment gets a gradient of exactly 0, every kept one its share,
    equal across the packages."""
    rs = np.random.RandomState(3)
    T, D, E, F, k, cap = 16, 8, 4, 6, 2, 4
    xn = rs.standard_normal((T, D)).astype(np.float32)
    en = rs.randint(0, E, size=T * k).astype(np.int32)
    wn = rs.uniform(0.1, 1.0, size=T * k).astype(np.float32)
    tn = np.repeat(np.arange(T, dtype=np.int32), k)
    ws = [rs.standard_normal(s).astype(np.float32) for s in ((E, D, F), (E, D, F), (E, F, D))]
    rn = rs.standard_normal((T, D)).astype(np.float32)

    def jloss(w):
        out = JMoE._dispatch_ffn(jnp.asarray(xn), jnp.asarray(en), jnp.asarray(tn), w, E, cap,
                                 *map(jnp.asarray, ws))
        return jnp.sum(out * rn)
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(wn)))
    w = torch.from_numpy(wn).requires_grad_(True)
    out = MoE._dispatch_ffn(torch.from_numpy(xn), torch.from_numpy(en), torch.from_numpy(tn), w,
                            E, cap, *map(torch.from_numpy, ws))
    (g,) = torch.autograd.grad((out * torch.from_numpy(rn)).sum(), w)
    # kept: the first `cap` assignments of each expert in (stable) order
    seen = np.zeros(E, np.int64)
    kept = np.zeros(T * k, bool)
    for a in np.argsort(en, kind="stable"):
        kept[a] = seen[en[a]] < cap
        seen[en[a]] += 1
    assert 0 < kept.sum() < T * k
    assert (g.numpy()[~kept] == 0).all() and (jg[~kept] == 0).all()
    assert (np.abs(g.numpy()[kept]) > 0).all()
    np.testing.assert_allclose(g.numpy(), jg, **TOL)


def test_train_step_through_the_functions_matches_cpu_autograd(functions_on_plain):
    """The whole loss through the Functions (the card's path, plain
    versions inside) gives the CPU path's gradients: every weight behind
    the first norm gets its gradient, as on the CPU."""
    cfg = get_config("wikikv-router").reduced(n_layers=2)
    params = M.init_params(cfg, seed=3, device="cpu")
    _, tb = _batch(cfg, 2, 16, seed=6)
    loss_f, grads_f = M.loss_and_grads(params, tb, cfg)
    assert functions_on_plain["bwd"] == cfg.n_layers
    assert functions_on_plain["rms_bwd"] == cfg.n_layers * 4 + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cpu", lambda t: True)
        loss_c, grads_c = M.loss_and_grads(params, tb, cfg)
    np.testing.assert_allclose(float(loss_f), float(loss_c), **TOL)
    for a, b in zip(leaves(grads_f), leaves(grads_c)):
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_moe_train_step_through_the_functions_matches_cpu_autograd(functions_on_plain):
    """dbrx reduced through the Functions (the card's path, plain versions
    inside): one router forward and one ``moe_router_bwd`` per MoE layer,
    and the CPU path's gradients, the router's included."""
    cfg = get_config("dbrx-132b").reduced()
    params = M.init_params(cfg, seed=3, device="cpu")
    _, tb = _batch(cfg, 2, 16, seed=6)
    loss_f, grads_f = M.loss_and_grads(params, tb, cfg)
    assert functions_on_plain["router"] == functions_on_plain["router_bwd"] == cfg.n_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cpu", lambda t: True)
        loss_c, grads_c = M.loss_and_grads(params, tb, cfg)
    np.testing.assert_allclose(float(loss_f), float(loss_c), **TOL)
    assert float(grads_f["body"]["slot0"]["moe"]["router"].abs().max()) > 0
    for a, b in zip(leaves(grads_f), leaves(grads_c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# functions_on_plain's name for each kernel
PLAIN_NAMES = {"flash_attention": "fwd", "flash_attention_bwd": "bwd", "rmsnorm": "rms",
               "rmsnorm_bwd": "rms_bwd", "moe_router": "router", "moe_router_bwd": "router_bwd"}


@pytest.mark.parametrize("arch,frames", [("jamba-v0.1-52b", None), ("xlstm-350m", None),
                                         ("whisper-medium", 40), ("internvl2-1b", None),
                                         ("kimi-k2-1t-a32b", None)],
                         ids=["jamba", "xlstm", "whisper", "internvl2", "kimi-k2"])
def test_every_family_through_the_functions_matches_cpu_autograd(functions_on_plain, arch,
                                                                 frames):
    """The SSM, xLSTM, enc-dec and vision families and kimi-k2 (a dense
    prefix layer before its MoE layer) through the Functions (the card's
    path, plain versions inside): one backward a forward call of each
    kernel, counted from the config (whisper: the encoder's 2
    attention calls, the decoder's 2 self and 2 cross at 40 frames over
    24 tokens, the cross-attention's backward at Sq < Skv), and the CPU
    path's loss and gradients."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=3, device="cpu")
    _, tb = _batch(cfg, 2, 24, seed=6, n_frames=frames)
    loss_f, grads_f = M.loss_and_grads(params, tb, cfg)
    assert functions_on_plain == {PLAIN_NAMES[k]: n for k, n in train_launches(cfg).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cpu", lambda t: True)
        loss_c, grads_c = M.loss_and_grads(params, tb, cfg)
    np.testing.assert_allclose(float(loss_f), float(loss_c), **TOL)
    for a, b in zip(leaves(grads_f), leaves(grads_c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _mini_loop(tmp_path, steps, total=12, seed=0):
    cfg = get_config("wikikv-router").reduced(d_model=32, vocab=256, n_layers=2)
    docs = [list(range(4, 200))] * 4
    pipe = DataPipeline(docs, seq_len=16, global_batch=4, seed=2)
    loop = TrainLoop(cfg, AdamWConfig(lr=1e-3),
                     TrainLoopConfig(total_steps=total, checkpoint_every=4,
                                     checkpoint_dir=str(tmp_path),
                                     async_checkpoint=False, log_every=100),
                     pipe, device="cpu", seed=seed)
    loop.run(n_steps=steps)
    return loop


def test_train_loop_crash_restart(tmp_path):
    """Run 8 steps, 'crash', restart a fresh loop → it resumes from the
    step-8 checkpoint and continues to 12 with identical data order, and
    ends bit for bit where an uninterrupted run ends."""
    l1 = _mini_loop(tmp_path / "a", steps=8)
    assert l1.ckpt.latest_step() == 8
    l2 = _mini_loop(tmp_path / "a", steps=None)   # restores, runs to total
    assert l2.step_no == 12 and len(l2.metrics.losses) == 4
    assert l2.pipeline.state.index == 12 % l2.pipeline.steps_per_epoch or \
        l2.pipeline.state.epoch > 0
    whole = _mini_loop(tmp_path / "b", steps=12)
    assert whole.metrics.losses[8:] == l2.metrics.losses
    for a, b in zip(leaves(l2.params), leaves(whole.params)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(l2.opt_state), leaves(whole.opt_state)):
        assert torch.equal(a, b)


def test_train_loop_loss_falls_and_async_checkpoints(tmp_path):
    cfg = get_config("wikikv-router").reduced(d_model=32, vocab=256, n_layers=2)
    pipe = DataPipeline([list(range(4, 60)) * 3] * 4, seq_len=16, global_batch=4, seed=1)
    loop = TrainLoop(cfg, AdamWConfig(lr=3e-3),
                     TrainLoopConfig(total_steps=10, checkpoint_every=5,
                                     checkpoint_dir=str(tmp_path), log_every=100),
                     pipe, device="cpu")
    m = loop.run()
    assert loop.ckpt.all_steps() == [5, 10]
    assert m.losses[-1] < m.losses[0] and len(m.step_times) == 10
    assert all(t > 0 for t in m.step_times)


def test_launch_train_cpu_reduced(tmp_path, capsys):
    metrics = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                                 "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"])
    assert len(metrics.losses) == 3 and all(math.isfinite(x) for x in metrics.losses)
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "step_2" / "meta.json").exists()


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_launch_train_recurrent_cpu_reduced(arch, tmp_path, capsys):
    """The launcher trains the SSM and xLSTM families on the reference's
    text pipeline, as the reference's launcher does: finite losses, a
    checkpoint."""
    metrics = launch_train.main(["--arch", arch, "--device", "cpu", "--reduced", "--steps", "2",
                                 "--batch", "2", "--seq", "32", "--checkpoint-dir",
                                 str(tmp_path), "--checkpoint-every", "2"])
    assert len(metrics.losses) == 2 and all(math.isfinite(x) for x in metrics.losses)
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "step_2" / "meta.json").exists()


def test_build_pipeline_is_the_references():
    from repro.launch.train import build_pipeline as j_build
    pipe, tok = launch_train.build_pipeline(512, seq_len=32, global_batch=4)
    jpipe, jtok = j_build(512, seq_len=32, global_batch=4)
    for _ in range(3):
        a, b = pipe.next_batch(), jpipe.next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])

