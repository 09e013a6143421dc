"""The port's selective SSM (``repro_torch.models.ssm``) and xLSTM blocks
(``repro_torch.models.xlstm``) against the JAX package's, function by
function: the same numpy inputs from a seed, parameters from JAX's
initializers bridged leaf for leaf, on ``ModelConfig.reduced()`` shapes.

Float32 within atol = rtol = 3e-5, the tolerance of tests/test_kernels.py
(the scans sum in another order: JAX's associative scan and its
``lax.scan`` chunks against the port's loops); bfloat16 within 2e-2.  The
deterministic leaves of the initializers equal JAX's bit for bit.

Gradients (the training slice): ``ssm._SelectiveScan`` through
``torch.autograd.gradcheck`` in float64 across chunk boundaries, and
``ssm_apply``, ``mlstm_chunkwise``, ``mlstm_apply`` and ``slstm_apply``
against ``jax.vjp`` of the reference's functions on the same inputs and
cotangents, every input and parameter leaf, at the same 3e-5, with an
absolute floor of 3e-5 times the leaf's largest gradient (a leaf's
gradient sums B * S terms, in another order in each package); every
gradient finite (the -1e30 stabilisers give no NaN), and ties of the
stabilisers' max split as JAX splits them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = ["float32", "bfloat16"]


def _cfgs(arch, dtype="float32", **over):
    over = dict(dtype=dtype, param_dtype=dtype, **over)
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, dtype="float32", **tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **(tol or (F32 if dtype == "float32"
                                                               else BF16)))


def _x(cfg, B, S_, seed, dtype):
    x = np.random.RandomState(seed).randn(B, S_, cfg.d_model).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _both(arr):
    """A float32 numpy array as (jax, torch)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _leaves_equal_tree(jp, tp):
    """Same keys, shapes and dtypes leaf for leaf."""
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(jax.tree.leaves(tp))
    for path, leaf in jflat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_init_trees_and_deterministic_leaves_equal_jax(arch, dtype):
    """Every leaf has JAX's key, shape and dtype, and the leaves drawn
    from no generator equal JAX's bit for bit, at the reduced widths and
    at the full ones: xlstm's blocks whole, jamba's fixed leaves at its
    Din = 8192 (JAX's draws of that block are dead code under jit)."""
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    blocks = ((JS.ssm_init, S.ssm_init, ("dt_bias", "A_log", "D_skip", "conv_b")),) \
        if arch.startswith("jamba") else \
        ((JX.mlstm_init, X.mlstm_init, ("if_bias", "skip_scale")),
         (JX.slstm_init, X.slstm_init, ("bias",)))
    full_j = dataclasses.replace(jget_config(arch), dtype=dtype, param_dtype=dtype)
    full = dataclasses.replace(get_config(arch), dtype=dtype, param_dtype=dtype)
    for j_init, t_init, fixed in blocks:
        for cfg_j, cfg in (_cfgs(arch, dtype), (full_j, full)):
            if arch.startswith("jamba") and cfg is full:
                Din = cfg.ssm_expand * cfg.d_model
                assert Din == 8192
                want = jax.jit(lambda k: {n: j_init(k, cfg_j)[0][n] for n in fixed})(key)
                got = S._fixed_leaves(Din, cfg.d_state, getattr(torch, dtype), "cpu")
            else:
                want = jax.tree.map(np.asarray, j_init(key, cfg_j)[0])
                got = t_init(gen, cfg)
                _leaves_equal_tree(want, got)
            for name in fixed:
                assert str(got[name].dtype)[6:] == str(np.asarray(want[name]).dtype), name
                assert np.array_equal(_bits(got[name]), _jbits(want[name])), name
    if arch.startswith("xlstm"):
        assert X.slstm_ffn_width(64) == 128 and X.slstm_ffn_width(1024) == 1408


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy().view(np.int32)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(np.int32)


def test_state_inits_equal_jax():
    """Zeros everywhere but the sLSTM's stabiliser, which starts at -1e30."""
    for arch, pairs in (("jamba-v0.1-52b", ((JS.ssm_state_init, S.ssm_state_init),)),
                        ("xlstm-350m", ((JX.mlstm_state_init, X.mlstm_state_init),
                                        (JX.slstm_state_init, X.slstm_state_init)))):
        cfg_j, cfg = _cfgs(arch)
        for j_fn, t_fn in pairs:
            want, got = j_fn(cfg_j, 3), t_fn(cfg, 3, "cpu")
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and np.array_equal(g.numpy(), np.asarray(w))
    assert X.NEG_INF == JX.NEG_INF == -1e30


# ---------------------------------------------------------------------------
# the selective SSM
# ---------------------------------------------------------------------------
def _core_inputs(B, S_, Din, N, seed):
    rs = np.random.RandomState(seed)
    u = rs.randn(B, S_, Din)
    dt = np.log1p(np.exp(rs.randn(B, S_, Din) - 2.0))      # softplus: Δ > 0
    Bm, Cm = rs.randn(B, S_, N), rs.randn(B, S_, N)
    A_log = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32)[None], (Din, 1)))
    D_skip = rs.randn(Din)
    h0 = rs.randn(B, Din, N) * 0.5
    return [_both(a) for a in (u, dt, Bm, Cm, A_log, D_skip, h0)]


@pytest.mark.parametrize("chunk", [256, 16], ids=["chunk256", "chunk16"])
@pytest.mark.parametrize("S_", [1, 7, 64, 300])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_ssm_core_matches_reference(S_, with_h0, chunk):
    """The chunked loop equals the associative scan, with and without a
    carried state, across chunk boundaries (300 steps: two chunks of 256,
    19 of 16)."""
    ins = _core_inputs(2, S_, 32, 8, seed=S_)
    (uj, ut), (dj, dt), (bj, bt), (cj, ct), (aj, at), (sj, st), (hj, ht) = ins
    yw, hw = JS._ssm_core(uj, dj, bj, cj, aj, sj, h0=hj if with_h0 else None)
    yg, hg = S._ssm_core(ut, dt, bt, ct, at, st, h0=ht if with_h0 else None, chunk=chunk)
    _close((yg, hg), (yw, hw))
    if with_h0:
        assert np.array_equal(ht.numpy(), np.asarray(hj))       # the carried state is not written


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_apply_matches_reference(dtype):
    cfg_j, cfg = _cfgs("jamba-v0.1-52b", dtype)
    jp, _ = JS.ssm_init(jax.random.PRNGKey(1), cfg_j)
    tp = _bridge(jp)
    xj, xt = _x(cfg, 2, 40, 1, dtype)
    _close(S.ssm_apply(tp, xt, cfg), JS.ssm_apply(jp, xj, cfg_j), dtype)
    # with a carried conv window and ssm state, returning the new state
    Din = cfg.ssm_expand * cfg.d_model
    rs = np.random.RandomState(2)
    (cj, ct), (hj, ht) = (_both(rs.randn(2, cfg.d_conv - 1, Din)),
                          _both(rs.randn(2, Din, cfg.d_state) * 0.3))
    want = JS.ssm_apply(jp, xj, cfg_j, conv_state=cj, ssm_state=hj, return_state=True)
    got = S.ssm_apply(tp, xt, cfg, conv_state=ct, ssm_state=ht, return_state=True)
    _close(got, want, dtype)
    assert got[1][0].dtype == got[1][1].dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_matches_reference(dtype):
    """Six one-token steps from the zero state, each state fed back."""
    cfg_j, cfg = _cfgs("jamba-v0.1-52b", dtype)
    jp, _ = JS.ssm_init(jax.random.PRNGKey(2), cfg_j)
    tp = _bridge(jp)
    jst, tst = JS.ssm_state_init(cfg_j, 3), S.ssm_state_init(cfg, 3, "cpu")
    xj, xt = _x(cfg, 3, 6, 3, dtype)
    for t in range(6):
        yj, jst = JS.ssm_decode(jp, xj[:, t:t + 1], jst, cfg_j)
        yt, tst = S.ssm_decode(tp, xt[:, t:t + 1], tst, cfg)
        _close((yt, tst), (yj, jst), dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_inputs(B, H, S_, Dh, seed, zero_state=False):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, H, S_, Dh) for _ in range(3))
    log_i = rs.randn(B, H, S_)
    log_f = -np.log1p(np.exp(-(rs.randn(B, H, S_) + 3.0)))     # log_sigmoid
    if zero_state:
        st = (np.zeros((B, H, Dh, Dh)), np.zeros((B, H, Dh)), np.zeros((B, H)))
    else:
        st = (rs.randn(B, H, Dh, Dh) * 0.3, rs.randn(B, H, Dh) * 0.3, rs.randn(B, H))
    return [_both(a) for a in (q, k, v, log_i, log_f)], [_both(a) for a in st]


@pytest.mark.parametrize("zero_state", [True, False], ids=["zero-state", "state"])
@pytest.mark.parametrize("S_", [1, 8, 64, 512])
def test_mlstm_chunkwise_matches_reference(S_, zero_state):
    """Chunks of 1, 8, 64 and 256 (``_pick_chunk``), from the zero state
    and from a carried one."""
    chunk = X._pick_chunk(S_)
    assert chunk == JX._pick_chunk(S_) == {1: 1, 8: 8, 64: 64, 512: 256}[S_]
    ins, st = _mlstm_inputs(2, 2, S_, 16, seed=S_, zero_state=zero_state)
    want = JX.mlstm_chunkwise(*[a for a, _ in ins], tuple(a for a, _ in st), chunk=chunk)
    got = X.mlstm_chunkwise(*[b for _, b in ins], tuple(b for _, b in st), chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("S_", [1, 5])
def test_mlstm_recurrent_matches_reference(S_):
    ins, st = _mlstm_inputs(2, 2, S_, 16, seed=10 + S_)
    want = JX._mlstm_recurrent(*[a for a, _ in ins], tuple(a for a, _ in st))
    got = X._mlstm_recurrent(*[b for _, b in ins], tuple(b for _, b in st))
    _close(got, want)


def test_mlstm_state_conventions_of_the_two_forms():
    """From the zero state the recurrent (decode) form and the chunkwise
    form give the same outputs, but their final states differ: the
    chunkwise carry builds C and n from the unscaled keys (it scales q),
    the recurrent step from keys scaled by 1/sqrt(Dh).  So a state a
    chunkwise prefill returns is off by sqrt(Dh) for the recurrent form,
    in the reference as in the port, which keeps the reference's
    contract; no model path hands one to the other (decode starts from
    the zero state)."""
    Dh = 8
    ins, st = _mlstm_inputs(1, 2, 16, Dh, seed=4, zero_state=True)
    for pkg, pick in ((X, 1), (JX, 0)):
        args = [a[pick] for a in ins], tuple(a[pick] for a in st)
        (h_r, (C_r, n_r, m_r)) = pkg._mlstm_recurrent(*args[0], args[1])
        (h_c, (C_c, n_c, m_c)) = pkg.mlstm_chunkwise(*args[0], args[1], chunk=8)
        _close((h_r, m_r), (h_c, m_c), atol=1e-5, rtol=1e-5)
        _close((_np(C_r) * np.sqrt(Dh), _np(n_r) * np.sqrt(Dh)), (C_c, n_c),
               atol=1e-5, rtol=1e-5)
        assert np.abs(_np(C_r) - _np(C_c)).max() > 0.5


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_apply_matches_reference(dtype):
    cfg_j, cfg = _cfgs("xlstm-350m", dtype)
    jp, _ = JX.mlstm_init(jax.random.PRNGKey(3), cfg_j)
    tp = _bridge(jp)
    xj, xt = _x(cfg, 2, 64, 4, dtype)
    _close(X.mlstm_apply(tp, xt, cfg), JX.mlstm_apply(jp, xj, cfg_j), dtype)
    # the full sequence with a state, returning it
    jst = JX.mlstm_state_init(cfg_j, 2)
    want = JX.mlstm_apply(jp, xj, cfg_j, state=jst, return_state=True)
    got = X.mlstm_apply(tp, xt, cfg, state=X.mlstm_state_init(cfg, 2, "cpu"), return_state=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_decode_matches_reference(dtype):
    """Prefill 8 tokens with the state returned, then 4 recurrent steps."""
    cfg_j, cfg = _cfgs("xlstm-350m", dtype)
    jp, _ = JX.mlstm_init(jax.random.PRNGKey(4), cfg_j)
    tp = _bridge(jp)
    xj, xt = _x(cfg, 2, 12, 5, dtype)
    _, jst = JX.mlstm_apply(jp, xj[:, :8], cfg_j, return_state=True)
    _, tst = X.mlstm_apply(tp, xt[:, :8], cfg, return_state=True)
    for t in range(8, 12):
        yj, jst = JX.mlstm_decode(jp, xj[:, t:t + 1], jst, cfg_j)
        yt, tst = X.mlstm_decode(tp, xt[:, t:t + 1], tst, cfg)
        _close((yt, tst), (yj, jst), dtype)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_apply_matches_reference(dtype):
    """From the initial state (m = -1e30: the first forget weight is 0,
    not NaN) and from a carried one, 40 steps (the reference's time
    blocks of 8)."""
    cfg_j, cfg = _cfgs("xlstm-350m", dtype)
    jp, _ = JX.slstm_init(jax.random.PRNGKey(5), cfg_j)
    tp = _bridge(jp)
    xj, xt = _x(cfg, 2, 40, 6, dtype)
    got = X.slstm_apply(tp, xt, cfg, return_state=True)
    _close(got, JX.slstm_apply(jp, xj, cfg_j, return_state=True), dtype)
    assert all(bool(torch.isfinite(t).all()) for t in jax.tree.leaves(got))
    rs = np.random.RandomState(7)
    st = [_both(a) for a in (rs.randn(2, cfg.d_model) * 0.3, rs.randn(2, cfg.d_model),
                             np.abs(rs.randn(2, cfg.d_model)) + 0.5, rs.randn(2, cfg.d_model))]
    want = JX.slstm_apply(jp, xj, cfg_j, state=tuple(a for a, _ in st), return_state=True)
    got = X.slstm_apply(tp, xt, cfg, state=tuple(b for _, b in st), return_state=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_decode_matches_reference(dtype):
    cfg_j, cfg = _cfgs("xlstm-350m", dtype)
    jp, _ = JX.slstm_init(jax.random.PRNGKey(6), cfg_j)
    tp = _bridge(jp)
    jst, tst = JX.slstm_state_init(cfg_j, 3), X.slstm_state_init(cfg, 3, "cpu")
    xj, xt = _x(cfg, 3, 6, 8, dtype)
    for t in range(6):
        yj, jst = JX.slstm_decode(jp, xj[:, t:t + 1], jst, cfg_j)
        yt, tst = X.slstm_decode(tp, xt[:, t:t + 1], tst, cfg)
        _close((yt, tst), (yj, jst), dtype)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
GRAD_REL = 3e-5


def _grads_close(got, want):
    """Each leaf within F32, with an absolute floor of GRAD_REL times the
    leaf's largest gradient; every gradient finite."""
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=F32["rtol"],
                                   atol=max(F32["atol"], GRAD_REL * float(np.abs(w).max())))


def _vjp_both(j_fn, t_fn, jargs, targs, cotangents):
    """``jax.vjp`` of ``j_fn`` and torch autograd of ``t_fn`` at the same
    inputs and output cotangents (numpy, matched to the outputs' leaves)."""
    out, vjp = jax.vjp(j_fn, *jargs)
    want = jax.tree.leaves(vjp(jax.tree.unflatten(jax.tree.structure(out),
                                                  [jnp.asarray(c) for c in cotangents])))
    leaves_ = [t.detach().clone().requires_grad_(True) for t in jax.tree.leaves(targs)]
    tree = jax.tree.unflatten(jax.tree.structure(targs), leaves_)
    outs = jax.tree.leaves(t_fn(*tree))
    got = torch.autograd.grad(outs, leaves_, [torch.from_numpy(c) for c in cotangents])
    return got, want


def _cotangents(outs, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*np.shape(o)).astype(np.float32) for o in jax.tree.leaves(outs)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_selective_scan_gradcheck(with_h0):
    """The scan's autograd Function in float64 across chunk boundaries
    (S = 24 in chunks of 8): the states, the decays, B, C, Δ, u, A and the
    carried state, against finite differences; the loss reads y and
    h_last."""
    g = torch.Generator().manual_seed(3 + with_h0)
    B, S_, Din, N = 2, 24, 5, 3
    u = torch.randn(B, S_, Din, generator=g, dtype=torch.float64)
    dt = torch.nn.functional.softplus(torch.randn(B, S_, Din, generator=g, dtype=torch.float64) - 2.0)
    Bm, Cm = (torch.randn(B, S_, N, generator=g, dtype=torch.float64) for _ in range(2))
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float64)).repeat(Din, 1)
    D_skip = torch.randn(Din, generator=g, dtype=torch.float64)
    h0 = torch.randn(B, Din, N, generator=g, dtype=torch.float64) * 0.5 if with_h0 else None
    ins = [t.requires_grad_(True) for t in (u, dt, Bm, Cm, A_log, D_skip, h0) if t is not None]

    def core(*a):
        a = list(a) + [None] * (7 - len(a))
        return S._ssm_core(*a[:6], h0=a[6], chunk=8)
    assert torch.autograd.gradcheck(core, tuple(ins))
    # under grad the scan is the Function; under no grad the loop runs as
    # it is, to the same numbers
    got = core(*ins)
    assert type(got[1].grad_fn).__name__ == "_SelectiveScanBackward"
    with torch.no_grad():
        want = core(*ins)
    assert want[1].grad_fn is None
    assert torch.equal(got[0].detach(), want[0]) and torch.equal(got[1].detach(), want[1])


@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_ssm_apply_grads_match_jax_vjp(with_state):
    """jamba's mamba block at 40 steps (chunks of 256: one), every
    parameter, the input and, with a carried conv window and ssm state,
    the states' gradients too, against ``jax.vjp``."""
    cfg_j, cfg = _cfgs("jamba-v0.1-52b")
    jp, _ = JS.ssm_init(jax.random.PRNGKey(7), cfg_j)
    tp = _bridge(jp)
    xj, xt = _x(cfg, 2, 40, 9, "float32")
    Din = cfg.ssm_expand * cfg.d_model
    rs = np.random.RandomState(10)
    st = [_both(rs.randn(2, cfg.d_conv - 1, Din)), _both(rs.randn(2, Din, cfg.d_state) * 0.3)]
    if with_state:
        def j_fn(p, x, c, h):
            return JS.ssm_apply(p, x, cfg_j, conv_state=c, ssm_state=h, return_state=True)

        def t_fn(p, x, c, h):
            return S.ssm_apply(p, x, cfg, conv_state=c, ssm_state=h, return_state=True)
        jargs, targs = (jp, xj, st[0][0], st[1][0]), (tp, xt, st[0][1], st[1][1])
    else:
        def j_fn(p, x):
            return JS.ssm_apply(p, x, cfg_j)

        def t_fn(p, x):
            return S.ssm_apply(p, x, cfg)
        jargs, targs = (jp, xj), (tp, xt)
    cot = _cotangents(j_fn(*jargs), seed=11)
    got, want = _vjp_both(j_fn, t_fn, jargs, targs, cot)
    assert len(got) == len(want) == len(jax.tree.leaves(targs))
    _grads_close(got, want)


@pytest.mark.parametrize("S_", [8, 24, 512])
def test_mlstm_chunkwise_grads_match_jax_vjp(S_):
    """The mLSTM cell alone from a carried state (q, k, v, both gates and
    C, n, m), chunks of 8 (one or three) and 256 (two), against
    ``jax.vjp``; the cotangent reaches the final state too."""
    chunk = X._pick_chunk(S_) if S_ != 24 else 8
    ins, st = _mlstm_inputs(1, 2, S_, 16, seed=20 + S_)

    def j_fn(q, k, v, li, lf, C, n, m):
        return JX.mlstm_chunkwise(q, k, v, li, lf, (C, n, m), chunk=chunk)

    def t_fn(q, k, v, li, lf, C, n, m):
        return X.mlstm_chunkwise(q, k, v, li, lf, (C, n, m), chunk=chunk)
    jargs = [a for a, _ in ins] + [a for a, _ in st]
    targs = [b for _, b in ins] + [b for _, b in st]
    got, want = _vjp_both(j_fn, t_fn, jargs, targs, _cotangents(j_fn(*jargs), seed=S_))
    _grads_close(got, want)


def test_stabiliser_ties_split_as_jax():
    """Log gates of exactly 0 (i = f = 1) from the zero state make the
    stabilisers' max tie everywhere: the intra-chunk log decays are all 0
    on and below the diagonal, and so is the carried m.  The
    port's ``amax`` and ``maximum`` split a tie's gradient evenly, as
    JAX's ``max`` and ``maximum`` do, so the gradients agree."""
    B, H, S_, Dh = 1, 2, 16, 8
    rs = np.random.RandomState(5)
    q, k, v = (_both(rs.randn(B, H, S_, Dh)) for _ in range(3))
    zero = _both(np.zeros((B, H, S_)))
    st = [_both(np.zeros((B, H, Dh, Dh))), _both(np.zeros((B, H, Dh))), _both(np.zeros((B, H)))]

    def j_fn(q, k, v, li, lf, C, n, m):
        return JX.mlstm_chunkwise(q, k, v, li, lf, (C, n, m), chunk=8)

    def t_fn(q, k, v, li, lf, C, n, m):
        return X.mlstm_chunkwise(q, k, v, li, lf, (C, n, m), chunk=8)
    jargs = [q[0], k[0], v[0], zero[0], zero[0]] + [a for a, _ in st]
    targs = [q[1], k[1], v[1], zero[1], zero[1]] + [b for _, b in st]
    got, want = _vjp_both(j_fn, t_fn, jargs, targs, _cotangents(j_fn(*jargs), seed=6))
    _grads_close(got, want)
    # the gate gradients are not all zero in either package: the ties carry them
    for i in (3, 4):
        assert float(np.abs(_np(want[i])).max()) > 0 and float(np.abs(_np(got[i])).max()) > 0


@pytest.mark.parametrize("S_", [8, 24, 512])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_grads_match_jax_vjp(kind, S_):
    """xlstm's blocks at S = 8 (one mLSTM chunk), 24 (three of 8) and 512
    (two of 256; the sLSTM's time blocks of 32), every parameter leaf and
    the input against ``jax.vjp``, from the initial state (the sLSTM's
    m = -1e30)."""
    cfg_j, cfg = _cfgs("xlstm-350m")
    init, j_apply, t_apply = {"mlstm": (JX.mlstm_init, JX.mlstm_apply, X.mlstm_apply),
                              "slstm": (JX.slstm_init, JX.slstm_apply, X.slstm_apply)}[kind]
    jp, _ = init(jax.random.PRNGKey(3), cfg_j)
    tp = _bridge(jp)
    xj, xt = _x(cfg, 1, S_, 1, "float32")

    def j_fn(p, x):
        return j_apply(p, x, cfg_j)

    def t_fn(p, x):
        return t_apply(p, x, cfg)
    got, want = _vjp_both(j_fn, t_fn, (jp, xj), (tp, xt), _cotangents(j_fn(jp, xj), seed=S_))
    assert len(got) == len(jax.tree.leaves(tp)) + 1
    _grads_close(got, want)
