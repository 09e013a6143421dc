"""On the card only: each of the port's CUDA kernels against its
plain PyTorch version, at small shapes and at the main path's, and the
durable tier under a DeviceEngine on the card (rehydration after a
crash, and reader threads on streams of their own against a committing
writer).  This file imports neither JAX nor the JAX package, so it runs
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips.  Integers and bools must match exactly;
floats within the tolerances of tests/test_kernels.py (f32 3e-5, bf16
2e-2)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.path_lookup import key64, pad_keys, pad_pinned  # noqa: E402
from repro_torch.kernels.path_lookup import path_lookup as pl_kernel  # noqa: E402

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
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rmsnorm_matches_plain(cuda, dtype):
    """Both bodies (16-byte vectors; scalar at D = 130 and on a misaligned
    base), warp and block rows, the main path's shapes, an f32 scale with
    bf16 x, a non-contiguous input and zero rows."""
    dt = getattr(torch, dtype)
    # (shape, scale): "f32" an f32 scale, "x" one in x's dtype, None none
    cases = [((7, 130), "f32"), ((32, 64), "f32"), ((8, 256), None), ((5, 3, 130), "x"),
             ((65536, 128), "x"), ((4096, 2048), "x"), ((4096, 6144), "x"), ((4, 6144), "f32"),
             ((4, 256), "x"), ((3, 1030), None), ((0, 256), "x")]
    for shape, scaled in cases:
        x = torch.randn(shape, dtype=dt, device=cuda)
        s = {"f32": torch.randn(shape[-1], device=cuda),
             "x": torch.randn(shape[-1], dtype=dt, device=cuda), None: None}[scaled]
        n0 = ops.LAUNCHES["rmsnorm"]
        got = ops.rmsnorm(x, s)
        assert ops.LAUNCHES["rmsnorm"] == n0 + (1 if x.numel() else 0)
        assert got.shape == x.shape and got.dtype == x.dtype
        torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, s).float(), **_tol(dtype))
    s = torch.randn(256, dtype=dt, device=cuda)
    for x in (torch.randn(64, 512, dtype=dt, device=cuda)[:, ::2],       # non-contiguous
              torch.randn(64 * 256 + 1, dtype=dt, device=cuda)[1:].view(64, 256)):  # misaligned
        torch.testing.assert_close(ops.rmsnorm(x, s).float(), ref.rmsnorm_ref(x, s).float(),
                                   **_tol(dtype))


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
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_group_6(cuda, dtype):
    """dbrx's 48 query heads over 8 KV heads, head_dim 128."""
    dt = getattr(torch, dtype)
    B, Hq, Hkv, S, D = 4, 48, 8, 512, 128
    q = torch.randn(B, Hq, D, dtype=dt, device=cuda)
    k = torch.randn(B, Hkv, S, D, dtype=dt, device=cuda)
    v = torch.randn(B, Hkv, S, D, dtype=dt, device=cuda)
    lens = torch.tensor([1, 129, 300, 512], dtype=torch.int32, device=cuda)
    n0 = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, lens)
    assert ops.LAUNCHES["decode_attention"] == n0 + 1
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, k, v, lens).float(),
                               **_tol(dtype))


def _decode_inputs(cuda, dt, B, Hq, Hkv, S, D, lens):
    return (torch.randn(B, Hq, D, dtype=dt, device=cuda),
            torch.randn(B, Hkv, S, D, dtype=dt, device=cuda),
            torch.randn(B, Hkv, S, D, dtype=dt, device=cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_split_path_three_calls(cuda, dtype):
    """S = 4096 over 6 x 2 (sequence, KV head), group 8: the plan splits
    each over 11 blocks, and three calls in a row, with the lengths
    {0, 1, 31, 32, 33, S} permuted between them, each match the plain
    version: the tickets are back at 0 after every launch."""
    from repro_torch.kernels.decode_attention import decode_plan
    dt = getattr(torch, dtype)
    B, Hq, Hkv, S, D = 6, 16, 2, 4096, 128
    assert decode_plan(B, Hkv, Hq // Hkv, S, D, dt.itemsize)[2]
    q, k, v, lens = _decode_inputs(cuda, dt, B, Hq, Hkv, S, D, [0, 1, 31, 32, 33, S])
    for perm in ([0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0], [2, 5, 0, 4, 1, 3]):
        ln = lens[torch.tensor(perm, device=cuda)]
        n0 = ops.LAUNCHES["decode_attention"]
        got = ops.decode_attention(q, k, v, ln)
        assert ops.LAUNCHES["decode_attention"] == n0 + 1
        want = ref.decode_attention_ref(q, k, v, ln)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
        assert not bool(got[ln == 0].any())            # a length of 0 gives zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_every_group_and_dim(cuda, dtype):
    """Every G in GROUPS and D in HEAD_DIMS, on both plans: one block per
    (sequence, KV head) at S = 100 and the split one at S = 300 and 4096;
    and 132 (sequence, KV head), which fill the card unsplit, with
    several chunks a warp."""
    from repro_torch.kernels.decode_attention import GROUPS, HEAD_DIMS, decode_plan
    dt = getattr(torch, dtype)
    plans = set()
    for G in GROUPS:
        for D in HEAD_DIMS:
            for B, Hkv, S, lens in ((3, 2, 100, [100, 33, 1]), (3, 2, 300, [300, 33, 0]),
                                    (1, 2, 4096, [4000])):
                plans.add(decode_plan(B, Hkv, G, S, D, dt.itemsize)[2])
                q, k, v, ln = _decode_inputs(cuda, dt, B, Hkv * G, Hkv, S, D, lens)
                got = ops.decode_attention(q, k, v, ln)
                torch.testing.assert_close(got.float(),
                                           ref.decode_attention_ref(q, k, v, ln).float(),
                                           **_tol(dtype))
    assert plans == {False, True}
    assert decode_plan(66, 2, 8, 1024, 128, dt.itemsize) == (8, 1, False)
    q, k, v, ln = _decode_inputs(cuda, dt, 66, 16, 2, 1024, 128, [1024, 511, 1] * 22)
    torch.testing.assert_close(ops.decode_attention(q, k, v, ln).float(),
                               ref.decode_attention_ref(q, k, v, ln).float(), **_tol(dtype))


@pytest.mark.cuda
def test_cuda_decode_attention_one_kernel_node_per_call(cuda):
    """Captured in a CUDA graph, three calls make three kernel nodes and no
    other node, on both plans (one block per (sequence, KV head) at S =
    100; split at the router's serving shape and over a long cache, after
    a warm-up call has made the workspace); LAUNCHES rises by one a call,
    and the replay matches the plain version."""
    from repro_torch.kernels import build
    for B, Hq, Hkv, S, D, lens in ((4, 4, 2, 100, 64, [1, 50, 99, 100]),
                                   (4, 4, 2, 512, 64, [1, 97, 311, 512]),
                                   (1, 4, 2, 4096, 64, [4096])):
        q, k, v, ln = _decode_inputs(cuda, torch.float32, B, Hq, Hkv, S, D, lens)
        ops.decode_attention(q, k, v, ln)
        torch.cuda.synchronize()
        n0 = ops.LAUNCHES["decode_attention"]
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            outs = [ops.decode_attention(q, k, v, ln) for _ in range(3)]
        assert ops.LAUNCHES["decode_attention"] == n0 + 3
        assert build.graph_nodes(g) == (3, 3)
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, k, v, ln)
        for got in outs:
            torch.testing.assert_close(got, want, **_tol("float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [0, 128, 4095, 4096, 300_000])
def test_cuda_path_lookup_exact_at_every_geometry(cuda, N):
    """Exactly the plain version's answers at P in {0, 8, 24} pinned
    entries, Q in {1, 33, 4096} queries, on mixed, all-miss and
    all-pinned batches, with and without the pinned level."""
    rs = np.random.RandomState(N)
    khi, klo = _key_table(rs, N) if N else (np.zeros(0, np.uint32),) * 2
    n = len(khi)
    real = key64(khi, klo)
    keys = torch.from_numpy(key64(*pad_keys(khi, klo)))
    card_keys = keys.to(cuda)
    for P in (0, 8, 24):
        pin_rows = rs.choice(n, size=min(P, n), replace=False).astype(np.int32)
        ph, pl, pp = pad_pinned(khi[pin_rows], klo[pin_rows], pin_rows)
        pinned = (torch.from_numpy(key64(ph, pl)), torch.from_numpy(pp))
        card_pinned = tuple(t.to(cuda) for t in pinned)
        for Q in (1, 33, 4096):
            misses = rs.randint(-2**63, 2**63 - 1, size=Q, dtype=np.int64)
            batches = {"all_miss": misses[~np.isin(misses, real)]}
            if n:
                batches["mixed"] = np.where(rs.rand(Q) < 0.7, real[rs.randint(0, n, size=Q)],
                                            misses)
            if len(pin_rows):
                batches["all_pinned"] = real[pin_rows][rs.randint(0, len(pin_rows), size=Q)]
            for kind, qk in batches.items():
                queries = torch.from_numpy(qk)
                want = ops.path_lookup(keys, queries, pinned=pinned)
                if kind == "all_miss":
                    assert (want == -1).all()
                got = pl_kernel(card_keys, queries.to(cuda), pinned=card_pinned)
                assert torch.equal(got.cpu(), want), (P, Q, kind)
                got = pl_kernel(card_keys, queries.to(cuda))
                assert torch.equal(got.cpu(), ops.path_lookup(keys, queries)), (P, Q, kind)


# (T, E, k): dbrx prefill and decode, jamba, kimi-k2, a ragged T, a tiny E;
# odd T at E = 16 (two tokens a warp: the last warp's second token past T)
ROUTER_SHAPES = [(4096, 16, 4), (4, 16, 4), (4096, 16, 2), (4096, 384, 8), (4099, 16, 4),
                 (33, 4, 2), (5, 1000, 32), (1, 16, 1), (1, 16, 16), (3, 16, 1),
                 (3, 16, 4), (3, 16, 16), (4099, 16, 1), (4099, 16, 16), (7, 17, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("renormalize", [True, False])
def test_cuda_moe_router_matches_plain(cuda, renormalize):
    """Weights within 1e-6; indices equal in every row of the tie-laden
    inputs (logits on a grid of 0.5, and all equal), and on normal input
    wherever no two of the row's k + 1 largest probabilities lie within
    1e-6 of each other (the kernel's expf and the plain version's exp may
    order such a pair apart)."""
    g = torch.Generator().manual_seed(0)
    for T, E, k in ROUTER_SHAPES:
        x = torch.randn(T, E, generator=g) * 2
        for logits in (x, torch.round(x * 2) / 2, torch.zeros_like(x)):
            n0 = ops.LAUNCHES["moe_router"]
            w, idx = ops.moe_router(logits.to(cuda), k, renormalize=renormalize)
            assert ops.LAUNCHES["moe_router"] == n0 + 1
            pw, pidx = ref.moe_router_ref(logits.to(cuda), k, renormalize=renormalize)
            assert w.dtype == torch.float32 and idx.dtype == torch.int32
            differ = (idx != pidx).any(dim=1)
            if logits is not x:
                assert not bool(differ.any())
            else:
                top = torch.softmax(logits.double(), -1).sort(-1, descending=True).values
                top = top[:, :k + 1]                    # k + 1 largest, or all E at k = E
                near = (top[:, :-1] - top[:, 1:]).amin(-1) < 1e-6
                assert not bool((differ.cpu() & ~near).any())
            torch.testing.assert_close(w[~differ], pw[~differ], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_moe_router_one_kernel_node_per_call(cuda):
    """Captured in a CUDA graph, three calls make three kernel nodes and
    no other node, at two tokens a warp (dbrx's decode and prefill) and at
    one (kimi-k2's E); the replay matches the plain version."""
    from repro_torch.kernels import build
    g0 = torch.Generator().manual_seed(1)
    for T, E, k in ((4, 16, 4), (4099, 16, 4), (33, 384, 8)):
        x = (torch.round(torch.randn(T, E, generator=g0) * 4) / 2).to(cuda)
        ops.moe_router(x, k)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            outs = [ops.moe_router(x, k) for _ in range(3)]
        assert build.graph_nodes(g) == (3, 3)
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        pw, pidx = ref.moe_router_ref(x, k)
        for w, idx in outs:
            assert torch.equal(idx, pidx)
            torch.testing.assert_close(w, pw, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_moe_router_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError):                      # logits not f32
        ops.moe_router(torch.randn(4, 16, device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError):                      # k > E
        ops.moe_router(torch.randn(4, 4, device=cuda), 5)
    with pytest.raises(ValueError):                      # E > 1024
        ops.moe_router(torch.randn(4, 1025, device=cuda), 2)


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


def search_case(L, Q, order, N=300):
    """N rows: a sorted tree of /dNN/tNN/eNNN paths (packed, cut at L),
    rows that fill all L bytes and L - 1 bytes, free (zero) and tombstone
    (255) rows; Q prefixes cycling through the kernel's edge cases: len 0,
    1, 3, 4, 5, L - 1 and L taken from a row, a directory ending in '/',
    a prefix whose next byte is neither 0 nor '/', a padding prefix
    (0xFF, len 1)."""
    rs = np.random.RandomState(L * 1000 + Q)
    alphabet = np.frombuffer(b"abcd/", np.uint8)
    paths = [f"/d{d:02d}/t{t:02d}/e{e:03d}" for d in range(3) for t in range(4)
             for e in range(rs.randint(3, 12))] + ["/", "/d01", "/d01/t02", "/d1"]
    toks = np.zeros((len(paths), L), np.uint8)
    for i, s in enumerate(paths):
        b = s.encode()[:L]
        toks[i, :len(b)] = np.frombuffer(b, np.uint8)
    full = alphabet[rs.randint(0, 5, size=(8, L))].astype(np.uint8)
    full[:, 0] = ord("/")
    full[4:, L - 1] = 0                            # four rows of L - 1 bytes
    toks = np.concatenate([toks, full, np.zeros((6, L), np.uint8),
                           np.full((6, L), 255, np.uint8)])
    toks = toks[rs.randint(0, len(toks), size=N)]
    if order == "sorted":
        toks = toks[np.lexsort(toks.T[::-1])]
    prefs = np.zeros((Q, L), np.uint8)
    lens = np.zeros((Q,), np.int32)
    kinds = ("len0", "len1", "len3", "len4", "len5", "lenL-1", "lenL", "dir/", "other",
             "padding", "row")
    for i in range(Q):
        kind = kinds[(i + Q) % len(kinds)]
        src = toks[rs.randint(0, N)] if kind != "lenL-1" and kind != "lenL" \
            else full[rs.randint(0, 8)]
        if kind == "padding":
            prefs[i], lens[i] = 255, 1
            continue
        n = {"len0": 0, "len1": 1, "len3": 3, "len4": 4, "len5": 5, "lenL-1": L - 1,
             "lenL": L}.get(kind)
        if kind == "dir/":
            prefs[i, :9] = np.frombuffer(b"/d01/t02/", np.uint8)
            n = 9
        elif kind == "other":
            prefs[i, :3] = np.frombuffer(b"/d1", np.uint8)   # "/d10/..." must not match
            n = 3
        elif kind == "row":
            n = rs.randint(1, L + 1)
        if kind not in ("dir/", "other"):
            prefs[i, :n] = src[:n]
        prefs[i, n:] = rs.randint(0, 256, size=L - n)     # bytes past len never count
        lens[i] = n
    return toks, prefs, lens



@pytest.mark.cuda
def test_cuda_prefix_search_matches_plain(cuda):
    """Exactly the plain version's bitmap: on random rows (Q = 300 is two
    launches, the output's rows 300 bytes apart); on ``search_case`` at
    every row length, Q in {1, 3, 4, 5, 64, 257}, sorted and shuffled
    (len 0, 1, 3, 4, 5, L - 1 and L, prefixes ending in '/', free and
    tombstone rows, N a multiple of neither 32 nor the tile); with int64
    lengths; and on a sorted table of more than 3 tiles a block, so each
    block walks several tiles."""
    from repro_torch.kernels.prefix_search import (BLOCKS_PER_SM, ROW_LENGTHS, TILE,
                                                   search_geometry)
    rs = np.random.RandomState(5)
    alphabet = np.frombuffer(b"abcd/", np.uint8)
    for N, L, Q in [(1000, 96, 64), (333, 48, 5), (300, 32, 300)]:
        toks = alphabet[rs.randint(0, 5, size=(N, L))].astype(np.uint8)
        prefs = alphabet[rs.randint(0, 5, size=(Q, L))].astype(np.uint8)
        plens = rs.randint(0, 10, size=Q).astype(np.int32)
        t, p, ln = (torch.from_numpy(a) for a in (toks, prefs, plens))
        got = ops.prefix_search(t.to(cuda), p.to(cuda), ln.to(cuda))
        assert torch.equal(got.cpu(), ops.prefix_search(t, p, ln))
    for L in ROW_LENGTHS:
        for Q in (1, 3, 4, 5, 64, 257):
            for order in ("sorted", "shuffled"):
                t, p, ln = (torch.from_numpy(a) for a in search_case(L, Q, order))
                n0 = ops.LAUNCHES["prefix_search"]
                got = ops.prefix_search(t.to(cuda), p.to(cuda), ln.to(cuda))
                assert ops.LAUNCHES["prefix_search"] == n0 + (1 if Q <= 256 else 2)
                assert torch.equal(got.cpu(), ops.prefix_search(t, p, ln)), (L, Q, order)
    t, p, ln = (torch.from_numpy(a).to(cuda) for a in search_case(64, 5, "shuffled"))
    assert torch.equal(ops.prefix_search(t, p, ln.long()), ref.prefix_search_ref(t, p, ln))
    toks, prefs, lens = search_case(96, 64, "sorted")
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    N = 3 * n_sm * BLOCKS_PER_SM * TILE + 77
    assert -(-N // TILE) > 3 * search_geometry(N, 96, 64, n_sm)[0]   # 3+ tiles a block
    t = torch.from_numpy(np.repeat(toks, -(-N // len(toks)), axis=0)[:N]).to(cuda)
    p, ln = torch.from_numpy(prefs).to(cuda), torch.from_numpy(lens).to(cuda)
    got = ops.prefix_search(t, p, ln)
    assert got.any() and torch.equal(got, ref.prefix_search_ref(t, p, ln))


@pytest.mark.cuda
def test_cuda_prefix_search_one_kernel_node_per_call(cuda):
    """Captured in a CUDA graph, three calls at Q <= Q_CHUNK make three
    kernel nodes and no other node; the replay matches the plain version."""
    from repro_torch.kernels import build
    for L, Q in ((96, 64), (32, 5), (128, 256)):
        t, p, ln = (torch.from_numpy(a).to(cuda) for a in search_case(L, Q, "sorted"))
        ops.prefix_search(t, p, ln)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            outs = [ops.prefix_search(t, p, ln) for _ in range(3)]
        assert build.graph_nodes(g) == (3, 3)
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        want = ref.prefix_search_ref(t, p, ln)
        for got in outs:
            assert torch.equal(got, want), (L, Q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_flash_attention_matches_plain(cuda, dtype):
    """Ragged lengths, Sq < Skv, groups 1-7, non-causal, every head_dim;
    the bf16 body's tile edges (Sq and Skv of 1, 127, 128, 129, 257) with
    its 64-query tile (small grids) and its 128-query tile (grids of 132
    blocks or more), where the last head of the last sequence ends in a
    ragged tail that only the tensor maps' zero fill keeps from the rows
    past it."""
    from repro_torch.kernels.flash_attention import query_tile
    dt = getattr(torch, dtype)
    cases = [(1, 4, 2, 7, 7, 64, True), (1, 4, 2, 113, 113, 64, True),
             (2, 4, 2, 64, 64, 32, True), (1, 8, 1, 32, 128, 16, True),
             (1, 16, 8, 130, 300, 128, True), (1, 2, 2, 45, 150, 16, False),
             (1, 12, 2, 65, 65, 128, True), (1, 14, 2, 33, 70, 32, True),
             (1, 14, 2, 19, 19, 64, False), (1, 2, 2, 1, 9, 128, True),
             # tile edges, the 64-query tile
             (1, 4, 4, 1, 1, 64, True), (1, 4, 4, 127, 127, 128, True),
             (1, 4, 2, 128, 128, 32, True), (1, 6, 1, 129, 129, 16, True),
             (1, 7, 1, 257, 257, 64, True), (1, 4, 2, 128, 257, 128, True),
             (1, 7, 1, 1, 257, 128, True), (1, 6, 6, 127, 129, 64, True),
             (2, 4, 2, 129, 257, 32, False), (1, 12, 2, 127, 257, 16, False),
             # the 128-query tile: groups 6, 7 and 11, ragged tails in every head
             (2, 48, 8, 257, 257, 128, True), (1, 70, 10, 129, 129, 128, True),
             (2, 66, 6, 257, 300, 64, False), (1, 132, 132, 128, 128, 32, True),
             (1, 132, 66, 127, 127, 16, True)]
    tiles = set()
    for B, Hq, Hkv, Sq, Skv, D, causal in cases:
        tiles.add(query_tile(B, Hq, Sq))
        q = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        k = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        v = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        n0 = ops.LAUNCHES["flash_attention"]
        got = ops.attention(q, k, v, causal=causal)
        assert ops.LAUNCHES["flash_attention"] == n0 + 1
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=causal)
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got[-1, -1].float(), want[-1, -1].float(), **_tol(dtype))
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    assert tiles == {64, 128}


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda)            # head_dim 48
    with pytest.raises(ValueError):
        ops.attention(q, q[:, :1], q[:, :1])
    q = torch.randn(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError):                      # Sq > Skv
        ops.attention(q, q[:, :, :4], q[:, :, :4])


@pytest.mark.cuda
def test_cuda_forward_and_loss_match_cpu(cuda):
    """The full-sequence forward of a reduced f32 router on the card (flash
    and rmsnorm kernels) against the same weights on the CPU (plain
    versions): one flash launch per layer, logits and loss within 3e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("wikikv-router").reduced(n_layers=3, d_model=128, vocab=1000)
    params = M.init_params(cfg, seed=3, device="cpu")
    rs = np.random.RandomState(3)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, 77)).astype(np.int32))
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    card_params = M._to(params, cuda)
    ops.reset_launches()
    logits = M.make_prefill_step(cfg)(card_params, on_card)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(logits.cpu(), M.make_prefill_step(cfg)(params, batch),
                               atol=3e-5, rtol=3e-5)
    loss = M.make_eval_step(cfg)(card_params, on_card)
    torch.testing.assert_close(loss.cpu(), M.make_eval_step(cfg)(params, batch),
                               atol=3e-5, rtol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_cuda_moe_forward_and_serve_match_cpu(cuda, arch):
    """Reduced dbrx (MoE in every layer) and kimi-k2 (shared expert, dense
    prefix) in f32: the forward, the loss and 6 serve steps on the card
    (moe_router, flash and decode kernels) against the CPU (plain
    versions) on the same weights; router launches counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced(d_model=128, vocab=1000)
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    params = M.init_params(cfg, seed=5, device="cpu")
    card_params = M._to(params, cuda)
    rs = np.random.RandomState(5)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, 40)).astype(np.int32))
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    ops.reset_launches()
    logits = M.make_prefill_step(cfg)(card_params, on_card)
    assert ops.LAUNCHES["moe_router"] == n_moe
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(logits.cpu(), M.make_prefill_step(cfg)(params, batch),
                               atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(M.make_eval_step(cfg)(card_params, on_card).cpu(),
                               M.make_eval_step(cfg)(params, batch), atol=3e-5, rtol=3e-5)
    serve = M.make_serve_step(cfg)
    B = 3
    st_card = T.init_decode_state(cfg, B, 32, cuda)
    st_cpu = T.init_decode_state(cfg, B, 32, "cpu")
    tk = toks[0, :B].clone()
    lens = torch.tensor([0, 3, 7], dtype=torch.int32)
    for _ in range(6):
        ops.reset_launches()
        n_card, l_card, st_card = serve(card_params, st_card,
                                        {"tokens": tk.to(cuda), "lengths": lens.to(cuda)})
        assert ops.LAUNCHES["moe_router"] == n_moe
        assert ops.LAUNCHES["decode_attention"] == cfg.n_layers
        n_cpu, l_cpu, st_cpu = serve(params, st_cpu, {"tokens": tk, "lengths": lens})
        torch.testing.assert_close(l_card.cpu()[:, :cfg.vocab], l_cpu[:, :cfg.vocab],
                                   atol=3e-5, rtol=3e-5)
        assert torch.equal(n_card.cpu(), n_cpu)
        tk, lens = n_cpu, lens + 1


# ---------------------------------------------------------------------------
# the durable tier under a DeviceEngine on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_durable_device_rehydration_epoch_consistent(cuda, tmp_path):
    """The rehydration scenario of the durable engine suite with the
    DeviceEngine on the card: the reopened engine's epoch and
    rehydrated paths, its Q1/Q4 answers against the HostEngine, and the
    DEVMARK that leaves the next reopen nothing to rehydrate."""
    from test_torch_durable_engine import rehydration_scenario
    ops.reset_launches()
    rehydration_scenario(tmp_path, "cuda")
    assert ops.LAUNCHES["path_lookup"] > 0 and ops.LAUNCHES["prefix_search"] > 0


@pytest.mark.cuda
def test_cuda_delta_one_wave_all_features_on(cuda, tmp_path, monkeypatch):
    """The concurrency suite's Δ = 1 case (fan-out pool, commit pipeline
    and background compaction on) with its DeviceEngines on the card."""
    import test_torch_concurrency as tc
    monkeypatch.setattr(tc, "DEVICE", "cuda")
    ops.reset_launches()
    tc.test_delta_one_wave_all_features_on(tmp_path)
    assert ops.LAUNCHES["path_lookup"] > 0


@pytest.mark.cuda
def test_cuda_device_readers_never_see_a_partial_epoch(cuda, tmp_path):
    """Reader threads, each on a stream of its own, launch Q1 and Q4
    batches while a writer thread on another stream commits and patches:
    no batch sees a partial epoch, and every batch launched its kernel
    exactly once (the launch counts are exact across threads)."""
    from test_torch_concurrency import device_readers_scenario
    ops.reset_launches()
    batches, seen = device_readers_scenario(tmp_path, "cuda")
    assert ops.LAUNCHES["path_lookup"] == batches["q1"]
    assert ops.LAUNCHES["prefix_search"] == batches["q4"]
    assert 10 in seen and len(seen) >= 2
