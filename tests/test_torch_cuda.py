"""On the card only: each of the port's CUDA/Triton kernels against its
plain PyTorch version, at small shapes and at the main path's.  This file
imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips.  Integers and bools must match exactly;
floats within the tolerances of tests/test_kernels.py (f32 3e-5, bf16
2e-2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.path_lookup import key64, pad_keys, pad_pinned  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def _key_table(rs, N):
    keys64 = np.unique(rs.randint(0, 2**63, size=N).astype(np.uint64))
    return ((keys64 >> np.uint64(32)).astype(np.uint32),
            (keys64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA/Triton kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rmsnorm_matches_plain(cuda, dtype):
    for shape, scaled in [((7, 130), True), ((32, 64), True), ((8, 256), False)]:
        x = torch.randn(shape, dtype=getattr(torch, dtype), device=cuda)
        s = torch.randn(shape[-1], device=cuda) if scaled else None
        n0 = ops.LAUNCHES["rmsnorm"]
        got = ops.rmsnorm(x, s)
        assert ops.LAUNCHES["rmsnorm"] == n0 + 1
        torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, s).float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_matches_plain(cuda, dtype):
    for B, Hq, Hkv, S, D in [(8, 4, 2, 512, 64), (2, 8, 4, 300, 32), (3, 16, 2, 4096, 128)]:
        dt = getattr(torch, dtype)
        q = torch.randn(B, Hq, D, dtype=dt, device=cuda)
        k = torch.randn(B, Hkv, S, D, dtype=dt, device=cuda)
        v = torch.randn(B, Hkv, S, D, dtype=dt, device=cuda)
        lens = torch.tensor([1] + [S - 3 * i for i in range(1, B)], dtype=torch.int32,
                            device=cuda)
        got = ops.decode_attention(q, k, v, lens)
        torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, k, v, lens).float(),
                                   **_tol(dtype))


@pytest.mark.cuda
def test_cuda_path_lookup_matches_plain(cuda):
    rs = np.random.RandomState(11)
    for N, Q, n_pin in [(1000, 301, 5), (50, 20, 3), (0, 8, 0), (200_000, 4096, 17)]:
        khi, klo = _key_table(rs, N) if N else (np.zeros(0, np.uint32),) * 2
        n = len(khi)
        keys = torch.from_numpy(key64(*pad_keys(khi, klo)))
        qidx = rs.randint(0, max(n, 1), size=Q)
        qk = np.concatenate([key64(khi, klo)[qidx] if n else np.zeros(0, np.int64),
                             np.array([0, 12345], np.int64)])
        queries = torch.from_numpy(qk)
        pin_rows = rs.choice(n, size=min(n_pin, n), replace=False).astype(np.int32)
        ph, pl, pp = pad_pinned(khi[pin_rows], klo[pin_rows], pin_rows)
        pinned = (torch.from_numpy(key64(ph, pl)), torch.from_numpy(pp))
        want = ops.path_lookup(keys, queries, pinned=pinned)
        got = ops.path_lookup(keys.to(cuda), queries.to(cuda),
                              pinned=tuple(t.to(cuda) for t in pinned))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_prefix_search_matches_plain(cuda):
    rs = np.random.RandomState(5)
    alphabet = np.frombuffer(b"abcd/", np.uint8)
    for N, L, Q in [(1000, 96, 64), (333, 48, 5), (300, 32, 300)]:
        toks = alphabet[rs.randint(0, 5, size=(N, L))].astype(np.uint8)
        prefs = alphabet[rs.randint(0, 5, size=(Q, L))].astype(np.uint8)
        plens = rs.randint(0, 10, size=Q).astype(np.int32)
        t, p, ln = (torch.from_numpy(a) for a in (toks, prefs, plens))
        got = ops.prefix_search(t.to(cuda), p.to(cuda), ln.to(cuda))
        assert torch.equal(got.cpu(), ops.prefix_search(t, p, ln))
