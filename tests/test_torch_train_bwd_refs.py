"""The plain backward versions of the training path (``ref.attention_bwd_ref``,
``ref.rmsnorm_bwd_ref``, ``ref.moe_router_bwd_ref`` at both ``renormalize``
settings and with ties) against torch autograd of the plain forwards and
against ``jax.vjp`` of ``repro.kernels.ref``; their casts are the plain
forwards'.  f32 to 3e-5 (``torch_train_common.TOL``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from torch_train_common import TOL, _router_logits  # noqa: E402


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
