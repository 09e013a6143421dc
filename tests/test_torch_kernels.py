"""The port's kernels: plain versions against the JAX Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them), the CPU dispatch,
(each CUDA/Triton kernel against its plain version on the card is in
tests/test_torch_cuda.py).

Inputs come from numpy with a fixed seed and go to both packages.
Integers and bools must match exactly; floats within the tolerances of
tests/test_kernels.py (f32 3e-5: sums in another order; bf16 2e-2: one
bf16 rounding of the output)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as j_decode  # noqa: E402
from repro.kernels.path_lookup import pad_keys as j_pad_keys  # noqa: E402
from repro.kernels.path_lookup import pad_pinned as j_pad_pinned  # noqa: E402
from repro.kernels.path_lookup import path_lookup as j_lookup  # noqa: E402
from repro.kernels.prefix_search import prefix_search as j_prefix  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.path_lookup import key64, pad_keys, pad_pinned  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def _both(x: np.ndarray, dtype: str):
    """The same numbers in both frameworks, rounded once to ``dtype``."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,scaled", [((7, 130), True), ((4, 32, 64), True),
                                          ((16, 256), False), ((8, 4, 64), True)])
def test_rmsnorm_plain_matches_pallas(shape, scaled, dtype):
    rs = np.random.RandomState(len(shape) * 100 + shape[-1])
    x = rs.randn(*shape).astype(np.float32)
    s = rs.randn(shape[-1]).astype(np.float32) if scaled else None
    jx, tx = _both(x, dtype)
    want = j_rmsnorm(jx, None if s is None else jnp.asarray(s), block_t=8, interpret=True)
    got = ops.rmsnorm(tx, None if s is None else torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,S,D,block_k", [
    (2, 8, 4, 256, 32, 64), (1, 4, 1, 512, 64, 128), (3, 2, 2, 128, 16, 32),
    (8, 4, 2, 512, 64, 256)])
def test_decode_attention_plain_matches_pallas(B, Hq, Hkv, S, D, block_k, dtype):
    rs = np.random.RandomState(B * 1000 + S)
    q = rs.randn(B, Hq, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    lens = np.array([(S // 2 + 7 * i) % S + 1 for i in range(B)], np.int32)
    lens[0] = 1                                   # a single live position
    if B > 2:
        lens[-1] = S                              # a full cache
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = j_decode(jq, jk, jv, jnp.asarray(lens), block_k=block_k, interpret=True)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_decode_attention_zero_length_gives_zeros():
    """The TPU kernel's l == 0 guard: a lane with no live position
    returns zeros (the plain version follows the kernel)."""
    q = torch.randn(2, 4, 16)
    kv = torch.randn(2, 2, 8, 16)
    out = ops.decode_attention(q, kv, kv, torch.tensor([0, 3], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out[1]))


# ---------------------------------------------------------------------------
# path lookup
# ---------------------------------------------------------------------------
def _key_table(rs, N):
    keys64 = np.unique(rs.randint(0, 2**63, size=N).astype(np.uint64))
    return ((keys64 >> np.uint64(32)).astype(np.uint32),
            (keys64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("N,Q,n_pin,bq", [(1000, 301, 5, 128), (130, 40, 1, 32),
                                          (5000, 64, 33, 64), (512, 96, 0, 32),
                                          (50, 20, 3, 8)])
def test_path_lookup_plain_matches_pallas(N, Q, n_pin, bq):
    rs = np.random.RandomState(N + n_pin)
    khi, klo = _key_table(rs, N)
    khi_p, klo_p = j_pad_keys(khi, klo)
    pin_rows = rs.choice(len(khi), size=min(n_pin, len(khi)), replace=False).astype(np.int32)
    qidx = rs.randint(0, len(khi), size=Q)
    qhi = np.concatenate([khi[qidx], khi[pin_rows], np.array([1, 2, 0], np.uint32)])
    qlo = np.concatenate([klo[qidx], klo[pin_rows], np.array([3, 4, 0], np.uint32)])
    pinned = j_pad_pinned(khi[pin_rows], klo[pin_rows], pin_rows) if n_pin else None
    want = np.asarray(j_lookup(
        jnp.asarray(khi_p), jnp.asarray(klo_p), jnp.asarray(qhi), jnp.asarray(qlo),
        pinned=None if pinned is None else tuple(jnp.asarray(a) for a in pinned),
        block_q=bq, interpret=True))
    # the port's numpy padding helpers are the reference's
    for a, b in zip(pad_keys(khi, klo), (khi_p, klo_p)):
        assert np.array_equal(a, b)
    queries = torch.from_numpy(key64(qhi, qlo))
    t_pin = None
    if pinned is not None:
        assert all(np.array_equal(a, b) for a, b in
                   zip(pad_pinned(khi[pin_rows], klo[pin_rows], pin_rows), pinned))
        t_pin = (torch.from_numpy(key64(pinned[0], pinned[1])), torch.from_numpy(pinned[2]))
    got = ops.path_lookup(torch.from_numpy(key64(khi_p, klo_p)), queries, pinned=t_pin)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # unpadded table, no pinning: the same positions
    plain = ops.path_lookup(torch.from_numpy(key64(khi, klo)), queries)
    assert np.array_equal(plain.numpy(), want)


def test_path_lookup_empty_table_misses():
    got = ops.path_lookup(torch.zeros(0, dtype=torch.int64),
                          torch.tensor([0, 5, -7], dtype=torch.int64))
    assert got.tolist() == [-1, -1, -1]


def test_key64_keeps_unsigned_order():
    rs = np.random.RandomState(3)
    hi = rs.randint(0, 2**32, size=500, dtype=np.uint64).astype(np.uint32)
    lo = rs.randint(0, 2**32, size=500, dtype=np.uint64).astype(np.uint32)
    hi[:3] = [0, 0xFFFFFFFF, 0x80000000]
    u = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert np.array_equal(np.argsort(u, kind="stable"),
                          np.argsort(key64(hi, lo), kind="stable"))
    assert key64(np.array([0xFFFFFFFF], np.uint32),
                 np.array([0xFFFFFFFF], np.uint32))[0] == np.iinfo(np.int64).max


# ---------------------------------------------------------------------------
# prefix search
# ---------------------------------------------------------------------------
def _pack(strings, L):
    out = np.zeros((len(strings), L), np.uint8)
    for i, s in enumerate(strings):
        b = s.encode()[:L]
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return out


def test_prefix_search_semantics():
    paths = ["/", "/a", "/a/b", "/ab", "/a/bc", "/sources/digests/x", "/b/c"]
    toks = torch.from_numpy(_pack(paths, 32))
    prefs = torch.from_numpy(_pack(["/a", "/sources", "/a/"], 32))
    bm = ops.prefix_search(toks, prefs, torch.tensor([2, 8, 3], dtype=torch.int32)).numpy()
    assert bm.shape == (7, 3) and bm.dtype == np.bool_
    assert bm[:, 0].tolist() == [False, True, True, False, True, False, False]
    assert bm[:, 1].tolist() == [False] * 5 + [True, False]
    assert bm[:, 2].tolist() == [False, False, True, False, True, False, False]


@pytest.mark.parametrize("N,L,Q,bn", [(100, 48, 3, 32), (513, 96, 5, 128), (64, 32, 9, 16)])
def test_prefix_search_plain_matches_pallas(N, L, Q, bn):
    rs = np.random.RandomState(L + Q)
    alphabet = np.frombuffer(b"abcd/", np.uint8)
    toks = alphabet[rs.randint(0, 5, size=(N, L))].astype(np.uint8)
    toks[:, 0] = ord("/")
    toks[1] = 0                                   # a free slot
    toks[2] = 255                                 # a tombstone
    prefs = alphabet[rs.randint(0, 5, size=(Q, L))].astype(np.uint8)
    prefs[:, 0] = ord("/")
    plens = rs.randint(1, 10, size=Q).astype(np.int32)
    plens[0] = L                                  # boundary check skipped
    prefs[-1, :4] = toks[5, :4]
    plens[-1] = 4
    want = np.asarray(j_prefix(jnp.asarray(toks), jnp.asarray(prefs), jnp.asarray(plens),
                               block_n=bn, interpret=True))
    got = ops.prefix_search(torch.from_numpy(toks), torch.from_numpy(prefs),
                            torch.from_numpy(plens))
    assert np.array_equal(got.numpy(), want)
    one = jref.prefix_search_ref(jnp.asarray(toks), jnp.asarray(prefs[1]),
                                 jnp.asarray(plens[1]))
    assert np.array_equal(ref.prefix_search_one_ref(
        torch.from_numpy(toks), torch.from_numpy(prefs[1]),
        torch.tensor(plens[1])).numpy(), np.asarray(one))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_cpu_dispatch_uses_plain_versions_and_counts_no_launch():
    ops.reset_launches()
    ops.rmsnorm(torch.randn(3, 64), torch.ones(64))
    ops.decode_attention(torch.randn(1, 2, 16), torch.randn(1, 1, 8, 16),
                         torch.randn(1, 1, 8, 16), torch.tensor([5], dtype=torch.int32))
    ops.path_lookup(torch.arange(10, dtype=torch.int64), torch.tensor([3], dtype=torch.int64))
    ops.prefix_search(torch.zeros((4, 32), dtype=torch.uint8),
                      torch.zeros((2, 32), dtype=torch.uint8),
                      torch.ones(2, dtype=torch.int32))
    assert ops.LAUNCHES == {"path_lookup": 0, "prefix_search": 0,
                            "decode_attention": 0, "rmsnorm": 0}
