"""The port's full-sequence attention on the CPU: the plain
``attention_ref``/``chunked_attention_ref`` and the ``ops.attention``
dispatch against the JAX package's ``attention_ref``,
``chunked_attention_ref`` and Pallas ``flash_attention`` (interpret mode,
as tests/test_kernels.py runs it).  The CUDA kernel against its plain
version on the card is in tests/test_torch_cuda.py.

Inputs come from numpy with a fixed seed and go to both packages.
Tolerances are those of tests/test_kernels.py: f32 3e-5 (sums in another
order), bf16 2e-2 (one bf16 rounding of the output; the chunked twin also
rounds q * scale and p to bf16, in both packages alike)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def _both(x: np.ndarray, dtype: str):
    """The same numbers in both frameworks, rounded once to ``dtype``."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, seed):
    rs = np.random.RandomState(seed)
    arrs = (rs.randn(B, Hq, Sq, D), rs.randn(B, Hkv, Skv, D), rs.randn(B, Hkv, Skv, D))
    return [_both(a.astype(np.float32), dtype) for a in arrs]


# the sweep of tests/test_kernels.py::test_flash_attention_sweep
SWEEP = [(2, 4, 2, 64, 64, 32, True), (1, 8, 1, 32, 128, 16, True),
         (2, 2, 2, 64, 64, 64, False), (1, 4, 4, 128, 128, 8, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", SWEEP)
def test_attention_plain_matches_reference_and_pallas(B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, Sq * 7 + D)
    got = ref.attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    kern = j_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **_tol(dtype))
    # the chunked twin, with a chunk that divides Skv
    chunk = 32
    got_c = ref.chunked_attention_ref(tq, tk, tv, causal=causal, chunk=chunk)
    want_c = jref.chunked_attention_ref(jq, jk, jv, causal=causal, chunk=chunk)
    np.testing.assert_allclose(_f32(got_c), _f32(want_c), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (1, 4, 2, 7, 7, 64, True),        # the oracle's short prompts
    (1, 4, 2, 37, 37, 64, True),
    (1, 4, 2, 113, 113, 64, True),
    (2, 4, 2, 13, 50, 32, True),      # ragged Sq < Skv (chunked prefill)
    (1, 2, 1, 45, 150, 16, False),    # non-causal, ragged
    (1, 12, 2, 40, 40, 16, True),     # group 6
    (1, 14, 2, 33, 70, 32, True),     # group 7, Sq < Skv
    (1, 14, 2, 19, 19, 16, False),    # group 7, non-causal
    (1, 2, 2, 1, 9, 128, True),       # one query over a context
])
def test_attention_plain_ragged_and_groups(B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    """Lengths that are no block multiple and groups 6 and 7: the JAX
    kernel asserts multiples, so these hold against its attention_ref."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Hq, Hkv, Sq, Skv, D, dtype, Sq + Skv + Hq)
    got = ops.attention(tq, tk, tv, causal=causal)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq", [64, 2048])
def test_ops_attention_takes_the_chunked_path_at_2048(Sq, dtype):
    """Skv = 2048 (> 1024, a multiple of 1024): both packages' CPU dispatch
    takes the chunked online softmax; the port's equals the JAX one."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 1, Sq, 2048, 16, dtype, Sq)
    got = ops.attention(tq, tk, tv)
    want = jops.attention(jq, jk, jv)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(
        _f32(got), _f32(ref.chunked_attention_ref(tq, tk, tv, chunk=1024)), atol=0, rtol=0)
    # and within float tolerance of the full softmax
    np.testing.assert_allclose(_f32(got), _f32(ref.attention_ref(tq, tk, tv)), **_tol(dtype))


def test_chunked_attention_refuses_a_ragged_context():
    q = torch.zeros(1, 1, 4, 16)
    k = torch.zeros(1, 1, 100, 16)
    with pytest.raises(ValueError, match="multiple"):
        ref.chunked_attention_ref(q, k, k, chunk=64)


def test_attention_respects_sm_scale_and_masks_the_future():
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 5, 16).astype(np.float32)) for _ in range(3))
    got = ops.attention(q, k, v, sm_scale=0.5)
    want = jref.attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)), sm_scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)
    # the first query sees only the first key: its output is v[0]
    np.testing.assert_allclose(got[:, :, 0].numpy(), v[:, :, 0].numpy(), atol=1e-6)
