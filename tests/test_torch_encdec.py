"""The port's encoder-decoder and vision paths against the JAX package's:
reduced whisper-medium (the audio stub: frames through a non-causal
encoder, cross-attention in every decoder block) and reduced internvl2-1b
(the vision stub: patch embeddings prepended to the text), parameters
bridged from JAX ``init_params``, the same numpy tokens, frames and patch
embeddings in both: ``cross_attn_apply``, non-causal ``attn_apply``, the
encoder's output, ``hidden_states``, ``forward`` and ``loss_fn`` (the
vision prefix's labels masked), the prefill, eval and serve facades, 8
serve steps with the encoder's output and the decode state after them,
and teacher-forced decode against the prefill.  Then what the port
refuses for these families (the train launcher, whose text pipeline has
no frames or patch embeddings; the ServingEngine for whisper) and two
faults of the reference that the refusals and the docstrings name.

Tolerances: float32 within the 3e-5 of tests/test_kernels.py (sums in
another order); bfloat16 within 2e-2, as tests/test_torch_forward.py
holds a bf16 model (each package rounds every matmul and norm output to
bf16, in its own order).  Greedy tokens equal exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.oracle import HeuristicOracle as JOracle  # noqa: E402
from repro.core.store import MemKV as JMemKV  # noqa: E402
from repro.core.store import PathStore as JPathStore  # noqa: E402
from repro.data.tokenizer import HashTokenizer as JTok  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro.runtime.serving import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core.oracle import HeuristicOracle  # noqa: E402
from repro_torch.core.store import MemKV, PathStore  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.serving import ServingEngine  # noqa: E402

ARCHS = ["whisper-medium", "internvl2-1b"]
F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
N_FRAMES = 40            # the reduced encoder's input length


def _cfgs(arch, dtype="float32"):
    over = dict(dtype=dtype, param_dtype=dtype)
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _bridge(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _both(x: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _batch(cfg, B, S, seed, n_frames=N_FRAMES):
    """tokens and next-token labels (the last masked, and a few scattered
    pads), with the family's stub input: ``frames`` (B, n_frames, D) or
    ``prefix_embeds`` (B, Np, D)."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    labels[0, rs.randint(0, S, size=3)] = -1
    arrays = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        arrays["frames"] = rs.randn(B, n_frames, cfg.d_model).astype(np.float32)
    if cfg.frontend == "vision_stub":
        arrays["prefix_embeds"] = rs.randn(B, cfg.n_prefix_embeds, cfg.d_model).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _j_encode(jparams, frames, cfg_j):
    """The reference's encoder output, as its ``hidden_states`` computes it."""
    e = JT._body_scan(jparams["enc_body"], frames.astype(cfg_j.dtype), cfg_j, None, remat=False)
    return JL.norm_apply(jparams["final_norm"], e, cfg_j)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Se", [(12, 20), (24, 8), (1, 20)])
def test_cross_attn_apply_matches_reference(Sq, Se):
    """q from x, k and v from the encoder's output, no RoPE, non-causal:
    more queries than keys (24 over 8) and one query (a decode step)."""
    cfg_j, cfg = _cfgs("whisper-medium")
    jp = JL.cross_attn_init(jax.random.PRNGKey(Sq * Se), cfg_j)[0]
    p = _bridge(jp)
    rs = np.random.RandomState(Sq + Se)
    (jx, tx), (je, te) = (_both(rs.randn(2, n, cfg.d_model).astype(np.float32))
                          for n in (Sq, Se))
    want = JL.cross_attn_apply(jp, jx, je, cfg_j)
    ops.reset_launches()
    got = L.cross_attn_apply(p, tx, te, cfg)
    assert ops.LAUNCHES["flash_attention"] == 0              # CPU: the plain version
    assert got.shape == (2, Sq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_apply_causal_flag_matches_reference(causal):
    """The encoder's non-causal self-attention, with RoPE, beside the
    causal one; the two differ."""
    cfg_j, cfg = _cfgs("whisper-medium")
    jp = JL.attn_init(jax.random.PRNGKey(3), cfg_j)[0]
    p = _bridge(jp)
    jx, tx = _both(np.random.RandomState(3).randn(2, 17, cfg.d_model).astype(np.float32))
    want = JL.attn_apply(jp, jx, cfg_j, causal=causal)
    got = L.attn_apply(p, tx, cfg, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    other = L.attn_apply(p, tx, cfg, causal=not causal)
    assert float((other - got).abs().max()) > 1e-3


def test_encoder_output_matches_reference():
    """``transformer._encode``: the frames through the non-causal encoder
    stack, normed by the shared final norm."""
    cfg_j, cfg = _cfgs("whisper-medium")
    jparams = JM.init_params(cfg_j, seed=2)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 2, 8, 2)
    want = _j_encode(jparams, jb["frames"], cfg_j)
    got = T._encode(params, tb["frames"], cfg)
    assert got.shape == (2, N_FRAMES, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# forward, loss, prefill and eval
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [24, 56])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, S):
    """Logits, hidden states and the loss through the facades and the
    module functions; whisper's decoder longer than its 40 frames (56:
    the cross-attention takes more queries than keys) and shorter (24);
    internvl2's logits span the prefix and the text."""
    cfg_j, cfg = _cfgs(arch)
    jparams = JM.init_params(cfg_j, seed=1)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 2, S, S)
    want = np.asarray(jax.jit(JM.make_prefill_step(cfg_j))(jparams, jb))
    ops.reset_launches()
    got = M.make_prefill_step(cfg)(params, tb)
    assert sum(ops.LAUNCHES.values()) == 0
    total = S + (cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else 0)
    assert got.shape == want.shape == (2, total, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    loss = M.make_eval_step(cfg)(params, tb)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jax.jit(JM.make_eval_step(cfg_j))(jparams, jb)),
                               **F32)
    with torch.inference_mode():
        assert torch.equal(T.forward(params, tb, cfg), got)
        assert float(T.loss_fn(params, tb, cfg)) == float(loss)
        np.testing.assert_allclose(T.hidden_states(params, tb, cfg).numpy(),
                                   np.asarray(JT.hidden_states(jparams, jb, cfg_j)), **F32)


def test_vision_loss_masks_the_prefix():
    """The prefix's positions carry no label: the loss equals the masked
    mean over the text's positions of the forward's own logits."""
    cfg_j, cfg = _cfgs("internvl2-1b")
    params = _bridge(JM.init_params(cfg_j, seed=4))
    _, tb = _batch(cfg, 2, 16, 4)
    with torch.inference_mode():
        logits = T.forward(params, tb, cfg)[:, cfg.n_prefix_embeds:].float()
        loss = float(T.loss_fn(params, tb, cfg))
    lab = tb["labels"].long()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
    mask = lab >= 0
    np.testing.assert_allclose(loss, float(nll[mask].mean()), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    """A bf16 model end to end on the same bridged weights: logits and
    loss within the bf16 tolerance."""
    cfg_j, cfg = _cfgs(arch, "bfloat16")
    jparams = JM.init_params(cfg_j, seed=5)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 1, 32, 5)
    want = _f32(jax.jit(JM.make_prefill_step(cfg_j))(jparams, jb))
    got = M.make_prefill_step(cfg)(params, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, **BF16)
    np.testing.assert_allclose(float(M.make_eval_step(cfg)(params, tb)),
                               float(jax.jit(JM.make_eval_step(cfg_j))(jparams, jb)), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_own_init_keep_the_tree(arch):
    """The JAX tree crosses leaf for leaf (``enc_body``, and ``norm_x`` and
    ``cross`` in every decoder slot), and the port's own initializer
    builds the same tree with the same shapes and dtypes."""
    cfg_j, cfg = _cfgs(arch)
    jparams = jax.tree.map(np.asarray, JM.init_params(cfg_j, seed=4))
    params = params_from_jax(jparams, device="cpu")
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(params)):
        assert np.array_equal(a, b.numpy())
    own = jax.tree.map(np.asarray, M.init_params(cfg, seed=4, device="cpu"))
    assert jax.tree.structure(jparams) == jax.tree.structure(own)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype
    if cfg.is_encdec:
        assert set(params["enc_body"]["slot0"]) == {"norm1", "attn", "norm2", "mlp"}
        assert params["enc_body"]["slot0"]["attn"]["wq"].shape[0] == cfg.n_enc_layers
        assert {"norm_x", "cross"} <= set(params["body"]["slot0"])
    else:
        assert "enc_body" not in params and "cross" not in params["body"]["slot0"]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _leaves(state):
    return jax.tree.leaves(state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_and_decode_state_match_reference(arch, dtype):
    """8 serve steps at B = 3 with ragged lengths, JAX's greedy tokens fed
    back to both: the logits every step, and in float32 the greedy tokens
    and the KV caches after the 8 steps (in bf16 a few cached keys,
    rounded after RoPE in another order, differ by up to 0.035).  whisper's
    steps take the same encoder output in ``batch["enc_out"]``: JAX's,
    bridged bit for bit, so the decode path is held alone (the port's own
    ``_encode`` is held to JAX's in float32 here and in
    ``test_encoder_output_matches_reference``; in bf16 the two encoders'
    roundings differ by up to 0.03 at B = 3, which the logits would
    inherit)."""
    cfg_j, cfg = _cfgs(arch, dtype)
    tol = F32 if dtype == "float32" else BF16
    jparams = JM.init_params(cfg_j, seed=3)
    params = _bridge(jparams)
    B, max_len = 3, 32
    jserve, serve = jax.jit(JM.make_serve_step(cfg_j)), M.make_serve_step(cfg)
    jstate = JT.init_decode_state(cfg_j, B, max_len)
    state = T.init_decode_state(cfg, B, max_len, "cpu")
    assert jax.tree.structure(jstate) == jax.tree.structure(state)
    jextra, extra = {}, {}
    if cfg.is_encdec:
        jb, tb = _batch(cfg, B, 4, 3)
        jextra["enc_out"] = _j_encode(jparams, jb["frames"], cfg_j)
        extra["enc_out"] = _bridge(jextra["enc_out"])
        if dtype == "float32":
            np.testing.assert_allclose(T._encode(params, tb["frames"], cfg).numpy(),
                                       _f32(jextra["enc_out"]), **F32)
    toks = np.random.RandomState(3).randint(0, cfg.vocab, size=B).astype(np.int32)
    lens = np.array([0, 3, 7], np.int32)
    ops.reset_launches()
    for _ in range(8):
        jn, jl, jstate = jserve(jparams, jstate, {"tokens": toks, "lengths": lens, **jextra})
        tn, tl, state2 = serve(params, state, {"tokens": torch.from_numpy(toks),
                                               "lengths": torch.from_numpy(lens), **extra})
        assert state2 is state                       # written in place
        np.testing.assert_allclose(_f32(tl)[:, :cfg.vocab], _f32(jl)[:, :cfg.vocab], **tol)
        if dtype == "float32":
            assert np.array_equal(tn.numpy(), np.asarray(jn))
        toks, lens = np.asarray(jn).astype(np.int32), lens + 1
    assert sum(ops.LAUNCHES.values()) == 0
    if dtype == "float32":
        for g, w in zip(_leaves(state), _leaves(jstate)):
            np.testing.assert_allclose(_f32(g), _f32(w), **F32)


def test_whisper_decode_matches_prefill():
    """Teacher-forced decode over 8 tokens, each step given the encoder's
    output, reproduces the prefill's logits within 2e-3
    (tests/test_models.py's test, on the port)."""
    _, cfg = _cfgs("whisper-medium")
    params = M.init_params(cfg, seed=1, device="cpu")
    _, tb = _batch(cfg, 1, 8, 1)
    full = M.make_prefill_step(cfg)(params, tb)
    with torch.inference_mode():
        enc_out = T._encode(params, tb["frames"], cfg)
        state = T.init_decode_state(cfg, 1, 32, "cpu")
        got = []
        for t in range(8):
            logits, state = T.decode_step(params, state, tb["tokens"][:, t],
                                          torch.full((1,), t, dtype=torch.int32), cfg,
                                          enc_out=enc_out)
            got.append(logits)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# what the port refuses for these families
# ---------------------------------------------------------------------------
def _store(path_store, kv, dir_record):
    store = path_store(kv())
    store.put_record("/", dir_record(name=""))
    return store


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_refuses_encdec_and_vision(arch, tmp_path):
    """The train launcher refuses these families, naming the data: its
    text pipeline (the reference's) gives tokens and labels only, with no
    ``frames`` or ``prefix_embeds``.  ``make_train_step`` and
    ``loss_and_grads`` train them given such batches (held against JAX's
    in tests/test_torch_train_encdec.py), and the other facades run them."""
    _, cfg = _cfgs(arch)
    with pytest.raises(NotImplementedError, match="text pipeline gives tokens and labels only"):
        train_launch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
                           "--checkpoint-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    params = M.init_params(cfg, device="cpu")
    _, tb = _batch(cfg, 1, 8, 0)
    loss, grads = M.loss_and_grads(params, tb, cfg)
    assert np.isfinite(float(loss)) and len(grads) == len(params)
    opt_cfg = AdamWConfig()
    new, opt, aux = M.make_train_step(cfg, opt_cfg)(params, adamw_init(params, opt_cfg), tb)
    assert int(opt["step"]) == 1 and float(aux["loss"]) == float(loss)
    assert np.isfinite(float(M.make_eval_step(cfg)(params, tb)))


def test_serving_engine_refuses_whisper_and_serves_internvl2_text():
    """The port's ServingEngine refuses the encoder-decoder (the
    reference's engine never passes ``enc_out``, below) and takes
    internvl2 as the reference takes it: text only."""
    for arch, refused in (("whisper-medium", True), ("internvl2-1b", False)):
        _, cfg = _cfgs(arch)
        args = (cfg, M.init_params(cfg, device="cpu"),
                HashTokenizer(vocab_size=cfg.vocab).fit(["x"]),
                _store(PathStore, MemKV, R.DirRecord), HeuristicOracle())
        if refused:
            with pytest.raises(NotImplementedError, match="enc_out"):
                ServingEngine(*args, batch_size=2, max_len=32, device="cpu")
        else:
            eng = ServingEngine(*args, batch_size=2, max_len=32, device="cpu")
            assert eng.state["slot0"]["k"].shape == (cfg.n_periods, 2, cfg.n_kv_heads, 32,
                                                     cfg.head_dim)


# ---------------------------------------------------------------------------
# faults of the reference (ROADMAP §3), shown with its own code
# ---------------------------------------------------------------------------
def test_reference_serving_engine_decodes_whisper_without_its_encoder():
    """The reference's ServingEngine calls its serve step with only
    ``tokens`` and ``lengths`` (``_prefill`` and ``step``), so whisper's
    decoder never sees the encoder: the engine's next logits after its own
    ``_prefill`` are the same whatever the frames, while the serve step
    given the encoder's output of two different frames gives two
    different logits."""
    cfg = jget_config("whisper-medium").reduced()
    jparams = JM.init_params(cfg, seed=0)
    eng = JServing(cfg, jparams, JTok(vocab_size=cfg.vocab).fit(["x"]),
                   _store(JPathStore, JMemKV, JR.DirRecord), JOracle(), batch_size=1,
                   max_len=64)
    req = JRequest(rid="r0", query="where is the wiki root", max_new_tokens=4)
    req.answer = "the root lies at slash"
    eng._prefill(0, req)                               # the reference's own loop
    step = {"tokens": eng.tokens, "lengths": eng.lengths}
    _, engine_logits, _ = eng._serve(jparams, eng.state, step)
    rs = np.random.RandomState(0)
    outs = []
    for _ in range(2):
        frames = jnp.asarray(rs.randn(1, N_FRAMES, cfg.d_model).astype(np.float32))
        enc_out = _j_encode(jparams, frames, cfg)
        outs.append(np.asarray(eng._serve(jparams, eng.state, {**step, "enc_out": enc_out})[1]))
    moved = float(np.abs(outs[0] - outs[1]).max())
    print(f"two frames move the logits by {moved}; the engine's logits take neither")
    assert moved > 1e-2
    for o in outs:
        assert float(np.abs(o - np.asarray(engine_logits)).max()) > 1e-2


def test_reference_decode_never_sees_the_vision_prefix():
    """The reference's ``decode_step`` has no ``prefix_embeds`` input and
    nothing writes the prefill's keys and values into the cache, so a
    decode of internvl2 never sees the image: teacher-forced decode of the
    text equals the prefill of the same weights under ``frontend="none"``
    (in both packages) and differs from the prefill with the prefix."""
    cfg_j, cfg = _cfgs("internvl2-1b")
    jparams = JM.init_params(cfg_j, seed=6)
    params = _bridge(jparams)
    jb, tb = _batch(cfg, 1, 8, 6)
    jserve = jax.jit(JM.make_serve_step(cfg_j))
    st = JT.init_decode_state(cfg_j, 1, 16)
    dec = []
    for t in range(8):
        _, lg, st = jserve(jparams, st, {"tokens": jb["tokens"][:, t],
                                         "lengths": jnp.full((1,), t, jnp.int32)})
        dec.append(np.asarray(lg))
    dec = np.stack(dec, 1)[..., :cfg.vocab]
    text_j = np.asarray(JM.make_prefill_step(dataclasses.replace(cfg_j, frontend="none"))(
        jparams, {"tokens": jb["tokens"]}))[..., :cfg.vocab]
    with_prefix = np.asarray(JM.make_prefill_step(cfg_j)(jparams, jb))[
        :, cfg.n_prefix_embeds:, :cfg.vocab]
    np.testing.assert_allclose(dec, text_j, atol=2e-3, rtol=2e-3)
    assert float(np.abs(dec - with_prefix).max()) > 1e-2
    text = M.make_prefill_step(dataclasses.replace(cfg, frontend="none"))(
        params, {"tokens": tb["tokens"]})
    np.testing.assert_allclose(text.numpy()[..., :cfg.vocab], text_j, **F32)
