"""The port's optimizer against the JAX package's: ``adamw_update`` with
f32, bf16 and int8 moments over 10 steps on the same numpy parameters
and gradients (a stacked leaf updated one period at a time included),
``cosine_schedule``, ``compress_grads`` with error feedback, the int8
state's size, and ``bridge.opt_state_from_jax`` continuing a JAX
trajectory.

Tolerances: the update math is f32 in both packages and only the order
of a few scalar ops differs, so f32 parameters agree to 1e-6 after 10
steps of lr 1e-2.  bf16 moments round the same f32 values to bf16; a
value on a rounding boundary may round either way, which moves that
element's next update by at most ~1% of lr: 2e-4 absolute.  int8 moments
likewise may round an element to the neighbouring level; parameters are
held to 5e-4 (5% of lr) and each moment to one quantization step of its
row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import adamw as JA  # noqa: E402
from repro.optim.compress import compress_grads as j_compress  # noqa: E402
from repro.optim.compress import decompress_grads as j_decompress  # noqa: E402
from repro.optim.schedule import cosine_schedule as j_cosine  # noqa: E402
from repro_torch.bridge import opt_state_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim.compress import compress_grads, decompress_grads  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402


def _np_params(rs):
    return {"w": rs.standard_normal((320, 256)).astype(np.float32),       # int8-quantized
            "stack": rs.standard_normal((4, 64, 48)).astype(np.float32),  # per-period update
            "b": rs.standard_normal((40,)).astype(np.float32) * 0.1,
            "layers": [{"s": np.ones((16,), np.float32)}]}


def _like(tree, fn):
    if isinstance(tree, dict):
        return {k: _like(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_like(v, fn) for v in tree]
    return fn(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _run_both(state_dtype, steps=10, dtype=np.float32):
    rs = np.random.RandomState(0)
    params = _like(_np_params(rs), lambda a: a.astype(dtype))
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, state_dtype=state_dtype, scan_update_min=4096)
    jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
    jp = _like(params, jnp.asarray)
    tp = _like(params, lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16 if dtype != np.float32 else torch.float32))
    js, ts = JA.adamw_init(jp, jcfg), TA.adamw_init(tp, tcfg)
    for i in range(steps):
        g = _like(params, lambda a: (rs.standard_normal(a.shape) * 0.1 + 0.02).astype(np.float32))
        lr_scale = 1.0 - 0.05 * i
        jp, js = JA.adamw_update(jp, _like(g, jnp.asarray), js, jcfg, lr_scale=lr_scale)
        tp, ts = TA.adamw_update(tp, _like(g, torch.from_numpy), ts, tcfg, lr_scale=lr_scale)
    return jp, js, tp, ts


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_adamw_f32_matches_jax_over_10_steps():
    jp, js, tp, ts = _run_both("float32")
    assert int(ts["step"]) == int(js["step"]) == 10 and ts["step"].dtype == torch.int32
    for a, b in zip(_flat(tp), _flat(jp)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(_flat(ts[key]), _flat(js[key])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-7, rtol=1e-5)


def test_adamw_bf16_moments_match_jax_over_10_steps():
    jp, js, tp, ts = _run_both("bfloat16")
    for a, b in zip(_flat(tp), _flat(jp)):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-4, rtol=0)
    for key in ("m", "v"):
        for a, b in zip(_flat(ts[key]), _flat(js[key])):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-2)


def test_adamw_bf16_params_match_jax():
    """bf16 parameters (qwen3's), f32 moments: the f32 update is rounded to
    bf16 in both; an element on a rounding boundary may land one bf16 ulp
    apart, which stays within one ulp of the parameter (|p| < 4: 2^-6)."""
    jp, js, tp, ts = _run_both("float32", steps=5, dtype=jnp.bfloat16)
    for a, b in zip(_flat(tp), _flat(jp)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), atol=2 ** -6, rtol=0)
        assert np.mean(_np(a) != _np(b)) < 0.01


def test_adamw_int8_moments_match_jax_over_10_steps():
    jp, js, tp, ts = _run_both("int8")
    for a, b in zip(_flat(tp), _flat(jp)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-4, rtol=0)
    for key in ("m", "v"):
        tw, jw = ts[key]["w"], js[key]["w"]
        assert tw["q"].dtype == torch.int8 and tw["q"].shape == (320, 256)
        np.testing.assert_allclose(tw["scale"].numpy(), np.asarray(jw["scale"]), rtol=1e-3)
        step = np.asarray(jw["scale"])[:, None]
        diff = np.abs(tw["q"].numpy().astype(np.float32) - np.asarray(jw["q"], np.float32))
        assert np.all(diff * step <= step + 1e-12)
        assert not isinstance(ts[key]["b"], dict)       # small leaves keep f32
        assert ts[key]["b"].dtype == torch.float32


def test_int8_state_is_small():
    params = {"w": torch.ones((1024, 512))}
    opt = TA.adamw_init(params, TA.AdamWConfig(state_dtype="int8"))
    m = opt["m"]["w"]
    assert m["q"].dtype == torch.int8 and m["q"].shape == (1024, 512)
    assert m["scale"].dtype == torch.float32 and m["scale"].shape == (1024,)
    nbytes = sum(t.numel() * t.element_size() for t in (m["q"], m["scale"]))
    assert nbytes < params["w"].numel() * 4 / 3.9      # ~4x under f32


def test_adamw_first_step_is_lr_times_sign():
    p = {"b": torch.zeros(40)}
    cfg = TA.AdamWConfig(lr=1e-2, weight_decay=0.0)
    p2, opt = TA.adamw_update(p, {"b": torch.ones(40)}, TA.adamw_init(p, cfg), cfg)
    np.testing.assert_allclose(p2["b"].numpy(), -1e-2, rtol=1e-3)
    assert int(opt["step"]) == 1 and float(p["b"][0]) == 0.0    # arguments untouched


@pytest.mark.parametrize("warmup,total", [(200, 10000), (1, 12), (5, 40), (0, 3)])
def test_cosine_schedule_matches_jax(warmup, total):
    for s in list(range(0, total + 3)) + [total * 2]:
        want = float(j_cosine(s, warmup=warmup, total=total))
        got = cosine_schedule(torch.tensor(s, dtype=torch.int32), warmup=warmup, total=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(cosine_schedule(0, warmup=warmup, total=total)) > 0


def test_compress_grads_with_error_feedback_matches_jax():
    rs = np.random.RandomState(3)
    g = {"a": rs.standard_normal((300, 7)).astype(np.float32),
         "b": [rs.standard_normal((256,)).astype(np.float32)]}
    jr = tr = None
    total_j = total_t = 0.0
    for step in range(4):
        gs = _like(g, lambda a: a * (1 + step))
        jc, jr = j_compress(_like(gs, jnp.asarray), jr)
        tc, tr = compress_grads(_like(gs, torch.from_numpy), tr)
        assert tc["a"]["q"].dtype == torch.int8 and tc["a"]["q"].shape == (9, 256)
        assert tc["a"]["shape"] == (300, 7)
        np.testing.assert_array_equal(tc["a"]["q"].numpy(), np.asarray(jc["a"]["q"]))
        np.testing.assert_allclose(tc["b"][0]["scale"].numpy(), np.asarray(jc["b"][0]["scale"]),
                                   rtol=1e-6)
        dj, dt = j_decompress(jc), decompress_grads(tc)
        np.testing.assert_allclose(dt["a"].numpy(), np.asarray(dj["a"]), atol=1e-6)
        np.testing.assert_allclose(tr["a"].numpy(), np.asarray(jr["a"]), atol=1e-6)
        total_j = total_j + np.asarray(dj["a"])
        total_t = total_t + dt["a"].numpy()
    # error feedback: the sum of what was sent tracks the sum of the grads
    sent = sum(g["a"] * (1 + s) for s in range(4))
    np.testing.assert_allclose(total_t + tr["a"].numpy(), sent, atol=1e-5)


def test_opt_state_from_jax_continues_the_jax_trajectory():
    rs = np.random.RandomState(5)
    params = {"w": rs.standard_normal((320, 256)).astype(np.float32),
              "b": np.zeros((8,), np.float32)}
    for state_dtype in ("float32", "int8"):
        cfg_kw = dict(lr=1e-2, state_dtype=state_dtype)
        jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
        jp = _like(params, jnp.asarray)
        js = JA.adamw_init(jp, jcfg)
        grads = [_like(params, lambda a: rs.standard_normal(a.shape).astype(np.float32))
                 for _ in range(4)]
        for g in grads[:3]:
            jp, js = JA.adamw_update(jp, _like(g, jnp.asarray), js, jcfg)
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
        tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
        jp, js = JA.adamw_update(jp, _like(grads[3], jnp.asarray), js, jcfg)
        tp, ts = TA.adamw_update(tp, _like(grads[3], torch.from_numpy), ts, tcfg)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=5e-4, rtol=0)
