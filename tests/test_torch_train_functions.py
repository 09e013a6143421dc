"""The autograd Functions of ``kernels.ops`` with their kernel entry points
pointed at the plain versions (the CUDA kernels have no CPU mode): through
``torch.autograd.gradcheck`` in f64 (the attention at non-causal Sq > Skv
too); a dropped assignment's gate gets a gradient of 0 in both packages;
the router's, dbrx's, jamba's, xlstm's, whisper's, internvl2's and
kimi-k2's losses through them against the CPU path, with one backward a
forward call of each kernel.  f32 to 3e-5 (``torch_train_common.TOL``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_cuda import train_launches  # noqa: E402
from torch_train_common import TOL, _batch, _router_logits  # noqa: E402


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
