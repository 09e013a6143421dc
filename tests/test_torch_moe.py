"""The port's MoE path against the JAX package's: the plain router
(``moe_router_ref``) against JAX's reference and the Pallas kernel in
interpret mode, the capacity dispatch and ``moe_apply_local`` on bridged
weights, and ``forward``/``loss_fn``/``make_serve_step`` of reduced
dbrx-132b (16e top-4 family) and kimi-k2 (shared expert, dense prefix).

Inputs come from numpy with a fixed seed and go to both packages.  Router
indices and greedy tokens must match exactly; router weights within 1e-6
(tests/test_kernels.py); f32 activations and logits within 3e-5 (sums in
another order); bf16 logits within 2e-2 with the router indices of every
MoE layer asserted equal, since one flipped expert moves a token's output
by far more than any bf16 tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_router import moe_router as j_router  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]


def _bridge(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _cfgs(arch, cf=None, **over):
    cfg_j, cfg = jget_config(arch).reduced(**over), get_config(arch).reduced(**over)
    if cf is not None:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg_j, cfg


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
def _logits(T_, E, ties, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(T_, E).astype(np.float32) * 2
    if ties:
        x = np.round(x * 2) / 2          # a grid of 0.5: many exactly equal logits
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("renormalize", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("T_,E,k", [(8, 4, 2), (256, 16, 4), (64, 384, 8), (100, 16, 2)])
def test_router_plain_matches_reference_and_pallas(T_, E, k, renormalize, ties):
    x = _logits(T_, E, ties, T_ * 1000 + E)
    w, idx = ops.moe_router(torch.from_numpy(x), k, renormalize=renormalize)
    assert w.dtype == torch.float32 and idx.dtype == torch.int32
    assert tuple(w.shape) == tuple(idx.shape) == (T_, k)
    for jw, ji in (jref.moe_router_ref(jnp.asarray(x), k, renormalize=renormalize),
                   j_router(jnp.asarray(x), k, renormalize=renormalize, interpret=True)):
        assert np.array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    if ties:   # the grid really ties candidates, and the lowest id goes first
        sel = np.take_along_axis(x, idx.numpy().astype(np.int64), 1)
        tied = (sel[:, :-1] == sel[:, 1:])
        assert tied.any()
        assert np.all(idx.numpy()[:, :-1][tied] < idx.numpy()[:, 1:][tied])
    if renormalize:
        np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)


def test_router_selects_on_probabilities_and_counts_no_launch():
    """Two logits one f32 step apart round to one probability: the tie
    goes to the lower id, as the Pallas kernel's first match gives it."""
    x = np.zeros((1, 8), np.float32)
    x[0, 5] = 30.0
    x[0, 2] = np.nextafter(np.float32(30.0), np.float32(0.0))
    ops.reset_launches()
    w, idx = ops.moe_router(torch.from_numpy(x), 2, renormalize=False)
    assert ops.LAUNCHES["moe_router"] == 0
    jw, ji = j_router(jnp.asarray(x), 2, renormalize=False, interpret=True)
    assert idx.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_local_matches_reference(arch, cf):
    cfg_j, cfg = _cfgs(arch, cf)
    jparams = JM.init_params(cfg_j, seed=2)
    jmoe = jparams["body"]["slot0"]["moe"]
    jmoe = jax.tree.map(lambda a: a[0], jmoe)            # the first period
    tmoe = _bridge(jmoe)
    rs = np.random.RandomState(7)
    x = rs.randn(48, cfg.d_model).astype(np.float32)
    want = np.asarray(JMoE.moe_apply_local(jmoe, jnp.asarray(x), cfg_j))
    got = MoE.moe_apply_local(tmoe, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the routed part alone: the same assignments kept, the same tokens dropped
    m = cfg.moe
    logits = x @ np.asarray(jmoe["router"])
    jw, ji = jref.moe_router_ref(jnp.asarray(logits), m.top_k)
    tw, ti = ops.moe_router(torch.from_numpy(logits), m.top_k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    cap = MoE._capacity(x.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    assert cap == JMoE._capacity(x.shape[0], m.top_k, m.n_experts, m.capacity_factor)
    tok = np.repeat(np.arange(x.shape[0], dtype=np.int32), m.top_k)
    jr = np.asarray(JMoE._dispatch_ffn(
        jnp.asarray(x), ji.reshape(-1), jnp.asarray(tok), jw.reshape(-1), m.n_experts, cap,
        jmoe["w_gate"], jmoe["w_up"], jmoe["w_down"]))
    tr = MoE._dispatch_ffn(torch.from_numpy(x), ti.reshape(-1), torch.from_numpy(tok),
                           tw.reshape(-1), m.n_experts, cap, tmoe["w_gate"], tmoe["w_up"],
                           tmoe["w_down"]).numpy()
    np.testing.assert_allclose(tr, jr, **TOL)
    dropped_j, dropped_t = np.all(jr == 0, axis=1), np.all(tr == 0, axis=1)
    assert np.array_equal(dropped_j, dropped_t)
    assert dropped_t.any() == (cf < 1.0)


def test_moe_drop_rule_keeps_the_first_arrivals():
    """The capacity rule on a hand-made routing: expert 0 is chosen by
    tokens 0..5 with capacity 4, so tokens 4 and 5 lose that assignment."""
    D = 8
    x = torch.eye(6, D)
    local_e = torch.tensor([0, 1, 0, 1, 0, 2, 0, 1, 0, 2, 0, 3], dtype=torch.int32)
    tok = torch.arange(6).repeat_interleave(2)
    w = torch.full((12,), 0.5)
    eye = torch.eye(D)[None].repeat(4, 1, 1)
    out = MoE._dispatch_ffn(x, local_e, tok, w, 4, 4, eye * 4, eye, eye)
    want = np.asarray(JMoE._dispatch_ffn(
        jnp.asarray(x.numpy()), jnp.asarray(local_e.numpy()), jnp.asarray(tok.numpy()),
        jnp.asarray(w.numpy()), 4, 4, *(jnp.asarray(a.numpy()) for a in (eye * 4, eye, eye))))
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    one = float(torch.nn.functional.silu(torch.tensor(4.0))) * 0.5   # one kept assignment
    np.testing.assert_allclose(out[:, :6].diagonal().numpy(),
                               [2 * one] * 4 + [one, one], rtol=1e-6)


# ---------------------------------------------------------------------------
# the model: forward, loss, serve steps
# ---------------------------------------------------------------------------
def _batch(cfg, B, S, seed):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg_j, cfg = _cfgs(arch)
    jparams = JM.init_params(cfg_j, seed=0)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 2, 24, 0)
    want = np.asarray(jax.jit(JM.make_prefill_step(cfg_j))(jparams, jb))
    got = M.make_prefill_step(cfg)(params, tb)
    assert got.shape == want.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(M.make_eval_step(cfg)(params, tb)),
                               float(jax.jit(JM.make_eval_step(cfg_j))(jparams, jb)), **TOL)
    with torch.inference_mode():
        np.testing.assert_allclose(T.hidden_states(params, tb, cfg).numpy(),
                                   np.asarray(JT.hidden_states(jparams, jb, cfg_j)), **TOL)


def test_kimi_at_head_dim_112_forward_and_serve_match_reference():
    """Reduced kimi-k2 with its own head_dim of 112 (4 heads over 2 KV
    heads, so 448-wide attention over a 64-wide model): the prefill logits
    against ``T.forward`` and 6 serve steps against the reference's, tokens
    exact."""
    cfg_j, cfg = _cfgs("kimi-k2-1t-a32b", d_head=112)
    assert cfg.head_dim == 112
    jparams = JM.init_params(cfg_j, seed=5)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 2, 24, 5)
    with torch.inference_mode():
        got = T.forward(params, tb, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(JT.forward(jparams, jb, cfg_j)), **TOL)
    jserve, serve = jax.jit(JM.make_serve_step(cfg_j)), M.make_serve_step(cfg)
    jstate, state = JT.init_decode_state(cfg_j, 2, 16), T.init_decode_state(cfg, 2, 16, "cpu")
    toks, lens = np.array([3, 9], np.int32), np.array([0, 5], np.int32)
    for _ in range(6):
        jn, jl, jstate = jserve(jparams, jstate, {"tokens": toks, "lengths": lens})
        tn, tl, state = serve(params, state, {"tokens": torch.from_numpy(toks),
                                              "lengths": torch.from_numpy(lens)})
        np.testing.assert_allclose(tl.numpy()[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab],
                                   **TOL)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        toks, lens = np.asarray(jn).astype(np.int32), lens + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(arch):
    cfg_j, cfg = _cfgs(arch)
    jparams = JM.init_params(cfg_j, seed=3)
    params = _bridge(jparams)
    B, max_len = 3, 32
    jserve, serve = jax.jit(JM.make_serve_step(cfg_j)), M.make_serve_step(cfg)
    jstate = JT.init_decode_state(cfg_j, B, max_len)
    state = T.init_decode_state(cfg, B, max_len, "cpu")
    assert ("prefix" in state) == (cfg.n_dense_prefix > 0) == ("prefix" in jstate)
    toks = np.random.RandomState(3).randint(0, cfg.vocab, size=B).astype(np.int32)
    lens = np.array([0, 3, 7], np.int32)
    for _ in range(6):
        jn, jl, jstate = jserve(jparams, jstate, {"tokens": toks, "lengths": lens})
        tn, tl, state = serve(params, state, {"tokens": torch.from_numpy(toks),
                                              "lengths": torch.from_numpy(lens)})
        np.testing.assert_allclose(tl.numpy()[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab],
                                   **TOL)
        assert np.array_equal(tn.numpy(), np.asarray(jn))
        toks, lens = np.asarray(jn).astype(np.int32), lens + 1
    for name in ("k", "v"):       # the caches hold the same keys and values
        np.testing.assert_allclose(state["slot0"][name].numpy(),
                                   np.asarray(jstate["slot0"][name]), **TOL)
        for got, want in zip(state.get("prefix", []), jstate.get("prefix", [])):
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL)


def _log_routers(monkeypatch):
    """Record (logits, indices) of every router call in both packages; the
    JAX side through an ordered debug callback (it runs under jit/scan)."""
    jlog, tlog = [], []
    j_orig, t_orig = jops.moe_router, ops.moe_router

    def j_logged(logits, k, **kw):
        w, idx = j_orig(logits, k, **kw)
        jax.debug.callback(lambda lg, i: jlog.append((np.asarray(lg), np.asarray(i))),
                           logits, idx, ordered=True)
        return w, idx

    def t_logged(logits, k, **kw):
        w, idx = t_orig(logits, k, **kw)
        tlog.append((logits.numpy().copy(), idx.numpy().copy()))
        return w, idx
    monkeypatch.setattr(jops, "moe_router", j_logged)
    monkeypatch.setattr(ops, "moe_router", t_logged)
    return jlog, tlog


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_bf16_dbrx_matches_reference_with_equal_routing(monkeypatch, seed):
    """bf16 dbrx on bridged weights.  Router logits within 2e-2 in every
    MoE layer.  Router indices equal in every layer for every token before
    the first one whose experts differ in any layer; each row that differs
    (in its experts or only in their order, seed 0) must be a near tie:
    the port's smallest gap among its k + 1 largest logits no larger than
    the two packages' bf16 rounding difference in that row (seed 3 has a
    changed expert, an exact bf16 tie on the port's side).  Tokens after it see other
    inputs (causal attention, and a flip changes later arrivals' capacity
    slots), so the logits are compared on the tokens before it.  dbrx's
    untied head gives |logits| up to ~4, where each package's bf16 result
    lies ~0.05 from the f32 computation of the same weights, so an
    elementwise 2e-2 does not hold between two correct bf16 runs
    (measured: 0.033 on 20 of 8192 logits at seed 1).  They are held
    within 2e-2 of the largest logit, and the port's distance from the f32
    computation within twice JAX's own, in the max and the mean."""
    cfg_j, cfg = _cfgs("dbrx-132b", dtype="bfloat16", param_dtype="bfloat16")
    jparams = JM.init_params(cfg_j, seed=seed)
    params = _bridge(jparams)
    S = 32
    jb, tb = _batch(cfg, 1, S, seed)
    jlog, tlog = _log_routers(monkeypatch)
    want = np.asarray(jax.jit(JM.make_prefill_step(cfg_j))(jparams, jb), np.float32)
    jax.effects_barrier()
    got = M.make_prefill_step(cfg)(params, tb)
    monkeypatch.undo()
    assert got.dtype == torch.bfloat16
    assert len(jlog) == len(tlog) == cfg.n_layers
    k, upto = cfg.moe.top_k, S
    for layer, ((jl, ji), (tl, ti)) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(tl[:upto], jl[:upto], atol=2e-2, rtol=2e-2)
        for r in np.flatnonzero((ji[:upto] != ti[:upto]).any(axis=1)):
            top = np.sort(tl[r])[::-1][:k + 1]
            gap, rounding = (top[:-1] - top[1:]).min(), np.abs(tl[r] - jl[r]).max()
            assert gap <= rounding, (f"layer {layer} token {r}: experts {ti[r]} vs {ji[r]} "
                                     f"with a logit gap {gap} > the rounding {rounding}")
        # the same experts in another order route the token alike
        flipped = np.flatnonzero((np.sort(ji[:upto], 1) != np.sort(ti[:upto], 1)).any(axis=1))
        if flipped.size:
            upto = int(flipped[0])
    assert upto >= S // 2, f"seed {seed}: routing flips at token {upto}"
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    f32 = M.make_prefill_step(cfg32)(jax.tree.map(lambda t: t.float(), params), tb).numpy()
    got, want, f32 = got.float().numpy()[:, :upto], want[:, :upto], f32[:, :upto]
    assert np.abs(got - want).max() <= 2e-2 * np.abs(f32).max()
    e_t, e_j = np.abs(got - f32), np.abs(want - f32)
    assert e_t.max() <= 2 * e_j.max() and e_t.mean() <= 2 * e_j.mean()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode over 8 tokens reproduces the prefill logits
    (tests/test_models.py's test, on the port).  Capacity is raised to 64
    so prefill (8 tokens) and decode (1 token) see the same routing."""
    _, cfg = _cfgs(arch, cf=64.0)
    params = M.init_params(cfg, seed=1, device="cpu")
    B, S = 1, 8
    toks = np.random.RandomState(0).randint(4, cfg.vocab, size=(B, S)).astype(np.int32)
    full = M.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(toks)})
    state = T.init_decode_state(cfg, B, 32, "cpu")
    got = []
    with torch.inference_mode():
        for t in range(S):
            logits, state = T.decode_step(params, state, torch.from_numpy(toks[:, t]),
                                          torch.full((B,), t, dtype=torch.int32), cfg)
            got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_own_init_keep_the_moe_tree(arch):
    """The JAX tree (kimi's ``prefix`` list included) crosses leaf for
    leaf, and the port's own initializer builds the same tree; drawn from
    a generator on the CPU, it is the facade's default draw."""
    cfg_j, cfg = _cfgs(arch)
    jparams = jax.tree.map(np.asarray, JM.init_params(cfg_j, seed=4))
    params = params_from_jax(jparams, device="cpu")
    assert isinstance(params.get("prefix", []), list)
    assert len(params.get("prefix", [])) == cfg.n_dense_prefix
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = params
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert np.array_equal(node.numpy(), leaf)
    own = M.init_params(cfg, seed=4, device="cpu")
    assert jax.tree.structure(jparams) == jax.tree.structure(jax.tree.map(np.asarray, own))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(jax.tree.map(np.asarray, own))):
        assert a.shape == b.shape and a.dtype == b.dtype
    same = T.init_params(torch.Generator(device="cpu").manual_seed(4), cfg)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(same)))


@pytest.mark.parametrize("seed", range(3))
def test_dispatch_sizes_equal_bincount(seed):
    """``_dispatch_ffn`` counts each expert's assignments with a
    static-length ``scatter_add_`` (so the MoE traces under fake tensors):
    the counts equal ``torch.bincount``'s on random ids, ids equal to
    ``n_local`` (not this rank's) included, and the layer's output is the
    one the bincount counts give."""
    rs = np.random.RandomState(seed)
    n_local, A, D = 4, 64, 8
    ids = torch.from_numpy(rs.randint(0, n_local + 1, A))
    ids[:5] = n_local
    want = torch.bincount(ids, minlength=n_local + 1)[:n_local]
    got = torch.zeros(n_local + 1, dtype=torch.int64).scatter_add_(
        0, ids, torch.ones_like(ids))[:n_local]
    assert torch.equal(got, want)
    # the dispatch with those ids against the JAX reference's (a capacity
    # that drops, so the per-expert offsets decide which assignments stay)
    x = rs.randn(16, D).astype(np.float32)
    tok = np.repeat(np.arange(16), 4).astype(np.int32)
    w = rs.rand(A).astype(np.float32)
    ws = [rs.randn(n_local, D, D).astype(np.float32) / 3 for _ in range(3)]
    out = MoE._dispatch_ffn(torch.from_numpy(x), ids, torch.from_numpy(tok), torch.from_numpy(w),
                            n_local, 10, *(torch.from_numpy(t) for t in ws))
    ref_out = np.asarray(JMoE._dispatch_ffn(jnp.asarray(x), jnp.asarray(ids.numpy()),
                                            jnp.asarray(tok), jnp.asarray(w), n_local, 10,
                                            *(jnp.asarray(t) for t in ws)))
    np.testing.assert_allclose(out.numpy(), ref_out, atol=3e-5, rtol=3e-5)
