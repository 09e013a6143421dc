"""The port's kernels: plain versions against the JAX Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them), the CPU dispatch,
(each CUDA kernel against its plain version on the card is in
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
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.path_lookup import pad_keys as j_pad_keys  # noqa: E402
from repro.kernels.path_lookup import pad_pinned as j_pad_pinned  # noqa: E402
from repro.kernels.path_lookup import path_lookup as j_lookup  # noqa: E402
from repro.kernels.prefix_search import prefix_search as j_prefix  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.path_lookup import key64, pad_keys, pad_pinned  # noqa: E402
from test_torch_cuda import search_case  # noqa: E402

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
    (8, 4, 2, 512, 64, 256),
    (4, 14, 2, 512, 64, 128), (2, 7, 1, 256, 128, 64), (3, 7, 1, 64, 16, 32)])  # group 7
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,block", [
    (1, 4, 4, 128, 64, 64, 64), (2, 4, 2, 96, 32, 16, 32), (1, 14, 2, 64, 32, 32, 32),
    (2, 2, 2, 32, 64, 128, 32)])
def test_noncausal_attention_plain_matches_pallas_with_more_queries(B, Hq, Hkv, Sq, Skv, D,
                                                                    block, dtype):
    """Whisper's cross-attention takes a decoder longer than its frames:
    non-causal attention with Sq > Skv (and one Sq < Skv beside it), the
    plain version against the Pallas kernel in interpret mode and the
    JAX ``attention_ref``; the same through the CPU dispatch."""
    rs = np.random.RandomState(Sq * 3 + Skv)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rs.randn(B, h, n, D).astype(np.float32), dtype)
                                    for h, n in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    got = ref.attention_ref(tq, tk, tv, causal=False)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kern = j_flash(jq, jk, jv, causal=False, block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(jref.attention_ref(jq, jk, jv, causal=False)),
                               **_tol(dtype))
    assert torch.equal(ops.attention(tq, tk, tv, causal=False), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,causal,block", [
    (1, 8, 1, 128, 128, True, 64), (2, 16, 2, 64, 192, True, 64),
    (1, 8, 8, 96, 64, False, 32), (1, 4, 2, 32, 32, False, 32)])
def test_attention_plain_matches_pallas_at_head_dim_112(B, Hq, Hkv, Sq, Skv, causal, block,
                                                         dtype):
    """kimi-k2's head_dim of 112 (group 8 as in its 64/8 heads): the plain
    version against the Pallas kernel in interpret mode and the JAX
    ``attention_ref``, causal (Sq < Skv: the queries the last Sq
    positions) and not (Sq > Skv too), and the CPU dispatch."""
    D = 112
    rs = np.random.RandomState(Sq * 7 + Skv + Hq)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rs.randn(B, h, n, D).astype(np.float32), dtype)
                                    for h, n in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
    got = ref.attention_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kern = j_flash(jq, jk, jv, causal=causal, block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(jref.attention_ref(jq, jk, jv, causal=causal)),
                               **_tol(dtype))
    assert torch.equal(ops.attention(tq, tk, tv, causal=causal), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,S,block_k", [(4, 64, 8, 256, 64), (3, 8, 1, 128, 32)])
def test_decode_attention_plain_matches_pallas_at_head_dim_112(B, Hq, Hkv, S, block_k, dtype):
    """kimi-k2's decode shape, cut in S: 64 query heads over 8 KV heads of
    112 dims, lengths from 1 to a full cache, against the Pallas kernel in
    interpret mode."""
    D = 112
    rs = np.random.RandomState(B * 1000 + S + Hq)
    q = rs.randn(B, Hq, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    lens = np.array([1, S, S // 2 + 3, 33][:B], np.int32)
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
# decode attention split over head_dim slices (the head_dim cache layout)
# ---------------------------------------------------------------------------
def _split_decode(q, k, v, lens, slices: int):
    """``decode_scores`` of each head_dim slice summed (the all-reduce),
    then ``decode_combine`` of each slice, the slices' outputs joined."""
    D = q.shape[-1]
    Dl = D // slices
    cols = [slice(i * Dl, (i + 1) * Dl) for i in range(slices)]
    s = sum(ops.decode_scores(q[..., c].contiguous(), k[..., c].contiguous(), lens,
                              sm_scale=1.0 / np.sqrt(D)) for c in cols)
    return torch.cat([ops.decode_combine(s, v[..., c].contiguous(), lens) for c in cols], dim=-1)


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 8, 4, 256, 32),     # group 2
    (3, 2, 2, 64, 16),      # group 1
    (1, 6, 1, 128, 28),     # group 6; Dl 28, 14, 7
    (4, 12, 2, 96, 56)])    # group 6; Dl 56, 28, 14
def test_decode_split_plain_matches_jax_decode_attention(B, Hq, Hkv, S, D, slices):
    """The plain split, the slices' scores summed as the all-reduce sums
    them, against JAX's ``decode_attention_ref`` and the port's fused
    plain version in f32: lengths of 1, a full cache and between."""
    rs = np.random.RandomState(B * 100 + S + D + slices)
    q = rs.randn(B, Hq, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    lens = np.array([1, S, S // 2 + 5, 9][:B], np.int32)
    want = jref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, lens)))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    got = _split_decode(tq, tk, tv, tl, slices)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("float32"))
    np.testing.assert_allclose(got.numpy(), ops.decode_attention(tq, tk, tv, tl).numpy(),
                               **_tol("float32"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,S,D,slices", [
    (2, 16, 2, 64, 112, 16),    # kimi-k2's heads over 16 ranks: Dl 7, group 8
    (2, 14, 2, 96, 64, 16),     # internvl2's: Dl 4, group 7
    (2, 48, 8, 64, 128, 16)])   # dbrx's: Dl 8, group 6
def test_decode_split_at_the_zoo_slices_matches_pallas(B, Hq, Hkv, S, D, slices, dtype):
    """The zoo's head_dim layouts at 16 "model" ranks: the plain split
    against the Pallas decode kernel in interpret mode (bf16: the caches
    in bf16, one rounding of the output)."""
    rs = np.random.RandomState(Hq * 10 + D)
    q = rs.randn(B, Hq, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    lens = np.array([S, 3], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = j_decode(jq, jk, jv, jnp.asarray(lens), block_k=32, interpret=True)
    got = _split_decode(tq, tk, tv, torch.from_numpy(lens), slices)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_decode_split_masks_past_the_length():
    """Scores at or past a lane's length are 0 and the combine never reads
    them (any value there leaves the output as it was); a length of 0
    gives zeros, as the fused kernel's l == 0 guard does."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g) for shape in ((2, 4, 8), (2, 2, 16, 8),
                                                           (2, 2, 16, 8)))
    lens = torch.tensor([0, 5], dtype=torch.int32)
    s = ops.decode_scores(q, k, lens, sm_scale=0.25)
    assert s.dtype == torch.float32 and s.shape == (2, 4, 16)
    assert torch.all(s[0] == 0) and torch.all(s[1, :, 5:] == 0) and torch.all(s[1, :, :5] != 0)
    out = ops.decode_combine(s, v, lens)
    assert torch.all(out[0] == 0)
    junk = s.clone()
    junk[1, :, 5:] = 1e4
    assert torch.equal(ops.decode_combine(junk, v, lens), out)


# ---------------------------------------------------------------------------
# the split's launch geometry: the Python plans the CUDA kernels are given
# ---------------------------------------------------------------------------
#: (B, Hkv, S) of the split at the smoke's and the card tests' shapes, a
#: card-filling B*Hkv, and S around a combine span and a scores tile
_SPLIT_PLANS = [(4, 8, 4096), (8, 8, 32768), (4, 8, 4096 + 1), (4, 2, 512), (12, 2, 600),
                (528, 2, 512), (1, 1, 1), (1, 1, 33), (2, 1, 1023), (2, 3, 1025),
                (64, 16, 100_000)]


@pytest.mark.parametrize("B,Hkv,S", _SPLIT_PLANS)
def test_decode_combine_spans_cover_each_live_position_once(B, Hkv, S):
    """At the zoo's slices, on the plan's block count and on 1 and
    MAX_BLOCKS: each live position of a lane lies in exactly one block's
    span, every span holds a live position (none lies past the length, so
    the merge waits on no idle block), spans start on a CHUNK and all but
    the last hold at least the span minimum, and at most nblk blocks take
    one; the grid stays within the card's limits."""
    from repro_torch.kernels.decode_split import (BLOCKS_PER_SM, CHUNK, MAX_BLOCKS, MAX_GRID,
                                                  combine_plan, combine_span_min, combine_spans)
    for G, Dl, elt in ((2, 8, 2), (6, 8, 2), (8, 7, 2), (7, 4, 2), (2, 64, 2), (2, 32, 4),
                       (16, 128, 4)):
        span_min = combine_span_min(G, Dl, elt)
        assert span_min >= CHUNK and span_min % CHUNK == 0
        nblk = combine_plan(B, Hkv, S, span_min, 132)
        assert 1 <= nblk <= MAX_BLOCKS and B * Hkv <= MAX_GRID and nblk <= 65535
        assert nblk == 1 or B * Hkv * nblk <= BLOCKS_PER_SM * 132
        for blocks in sorted({1, nblk, MAX_BLOCKS}):
            for length in {0, 1, 7, 8, 9, 31, 32, 33, span_min + 1, S // 2 + 1, S - 1, S}:
                if not 0 <= length <= S:
                    continue
                spans = combine_spans(length, blocks, span_min)
                assert len(spans) <= blocks
                covered = [t for lo, hi in spans for t in range(lo, hi)]
                assert covered == list(range(length))
                assert all(lo < hi <= length and lo % CHUNK == 0 for lo, hi in spans)
                assert all(hi - lo >= min(span_min, length) for lo, hi in spans[:-1])


#: every tile decode_scores_tile gives: rows of one 16-byte piece or of at
#: most 32 bytes through the ring (1024), 64 rows a pass of wider rows of
#: whole pieces over 1, 2, 4 or 8 passes, wider rows through the ring (64)
_SCORES_TILES = [64, 128, 256, 512, 1024]


@pytest.mark.parametrize("tile", _SCORES_TILES)
@pytest.mark.parametrize("B,Hkv,S", _SPLIT_PLANS)
def test_decode_scores_plan_walks_every_tile_once(B, Hkv, S, tile):
    """Each block walks a contiguous run of tiles: together the blocks
    take every tile of every (sequence, KV head) exactly once, the last
    block a non-empty run, the grid at most SCORES_BLOCKS_PER_SM blocks an
    SM and within the card's limit."""
    from repro_torch.kernels.decode_split import MAX_GRID, SCORES_BLOCKS_PER_SM, scores_plan
    tiles = B * Hkv * -(-S // tile)
    blocks, per = scores_plan(B, Hkv, S, tile, 132)
    assert 1 <= blocks <= min(SCORES_BLOCKS_PER_SM * 132, MAX_GRID) and per >= 1
    taken = [i for blk in range(blocks) for i in range(blk * per, min(blk * per + per, tiles))]
    assert taken == list(range(tiles)) and (blocks - 1) * per < tiles


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


# the new kernel body of csrc/prefix_search.cu, mirrored in numpy
_SLASH = ord("/")


def _search_descriptors(prefs, lens):
    """Per prefix, as the kernel stages it: two heads (words 0 and 1, and
    words 2 and 3, under their masks, and the masks: p_a & m_a, m_a,
    p_b & m_b, m_b; masks 0 past the word count) and the descriptor (word
    count, last-word mask, index of the byte after the prefix, whether
    the boundary rule applies)."""
    L = prefs.shape[1]
    pwords = np.ascontiguousarray(prefs).view("<u4")
    out = []
    for q, raw in enumerate(lens):
        n = max(int(raw), 0)
        nw = min((n + 3) >> 2, L // 4)
        rem = n - 4 * (nw - 1)
        last_mask = 0xFFFFFFFF if rem >= 4 else (1 << (8 * rem)) - 1
        m = [0 if k >= nw else last_mask if k == nw - 1 else 0xFFFFFFFF for k in range(4)]
        pm = [np.uint32(int(pwords[q, k]) & m[k]) for k in range(4)]
        heads = ((pm[0], np.uint32(m[0]), pm[1], np.uint32(m[1])),
                 (pm[2], np.uint32(m[2]), pm[3], np.uint32(m[3])))
        last = prefs[q, min(max(n - 1, 0), L - 1)]
        out.append((heads, (nw, last_mask, min(n, L - 1), n < L and last != _SLASH)))
    return out


def _head_match(w, a, head):
    """Lanes whose words a and a + 1 match a head (p_a & m_a, m_a, ...)."""
    pa, ma, pb, mb = head
    return (((w[:, a] & ma) ^ pa) | ((w[:, a + 1] & mb) ^ pb)) == 0


def _mirror_prefix_search(toks, prefs, lens):
    """The kernel's compare, one warp (32 neighbouring rows; lanes past N
    hold zeros and do not match) at a time, four prefixes at a time:
    words 0 and 1 of the four under their heads; then, for each prefix
    some lane still matches (the warp's OR), words 2 and 3 under the
    second head, past word 3 word by word up to the word count while a
    lane still matches, the warp leaving the prefix once none does, and
    the byte after it where the boundary rule applies.  Returns the
    bitmap and the words compared past word 3 over all (warp, prefix)
    pairs."""
    N, L = toks.shape
    words = np.ascontiguousarray(toks).view("<u4")
    pwords = np.ascontiguousarray(prefs).view("<u4")
    desc = _search_descriptors(prefs, lens)
    Q = len(desc)
    out = np.zeros((N, Q), bool)
    compared = 0
    for r0 in range(0, N, 32):
        w = np.zeros((32, L // 4), np.uint32)
        row = np.zeros((32, L), np.uint8)
        valid = np.arange(r0, r0 + 32) < N
        w[valid] = words[r0:r0 + 32]
        row[valid] = toks[r0:r0 + 32]
        for q4 in range(0, Q, 4):
            group = range(q4, min(q4 + 4, Q))
            live = {q: valid & _head_match(w, 0, desc[q][0][0]) for q in group}
            for q in group:
                if not live[q].any():                  # not in the warp's OR
                    continue
                nw, last_mask, nxt, boundary = desc[q][1]
                alive = live[q] & _head_match(w, 2, desc[q][0][1])
                if nw > 4 and alive.any():
                    for k in range(4, nw):
                        m = last_mask if k == nw - 1 else 0xFFFFFFFF
                        alive &= ((w[:, k] ^ pwords[q, k]) & np.uint32(m)) == 0
                        compared += 1
                        if not alive.any():
                            break
                if boundary:
                    alive &= (row[:, nxt] == 0) | (row[:, nxt] == _SLASH)
                live[q] = alive
            for q in group:
                out[r0:r0 + 32, q] = live[q][valid]
    return out, compared


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("Q", [1, 3, 4, 5, 64, 257])
@pytest.mark.parametrize("L", [32, 48, 64, 96, 128])
def test_prefix_search_kernel_body_matches_plain_and_pallas(L, Q, order):
    """csrc/prefix_search.cu's body (descriptors, the compare up to each
    prefix's word count, the warp's early exit), mirrored in numpy, equals
    the plain version and the Pallas kernel in interpret mode, at every
    row length and on sorted and shuffled rows; N = 300 is a multiple of
    neither 32 nor the 256-row tile."""
    from repro_torch.kernels.prefix_search import ROW_LENGTHS
    assert L in ROW_LENGTHS
    toks, prefs, lens = search_case(L, Q, order)
    want = ref.prefix_search_ref(torch.from_numpy(toks), torch.from_numpy(prefs),
                                 torch.from_numpy(lens)).numpy()
    got, compared = _mirror_prefix_search(toks, prefs, lens)
    assert np.array_equal(got, want)
    pallas = np.asarray(j_prefix(jnp.asarray(toks), jnp.asarray(prefs), jnp.asarray(lens),
                                 block_n=128, interpret=True))
    assert np.array_equal(pallas, want)
    warps = -(-toks.shape[0] // 32)
    assert compared < warps * Q * (L // 4 - 4)      # never more than every word
    if Q >= 64:
        assert want.any() and not want.all()


@pytest.mark.parametrize("case", ["zeros", "tombstones", "next_zero", "next_slash",
                                  "next_other", "ends_in_slash", "len_L_no_boundary"])
def test_prefix_search_kernel_body_edge_rows(case):
    """One row kind against one prefix at a time, where the boundary byte
    decides: the mirror equals the plain version, and the expected bit."""
    L = 32
    rows = {"zeros": "", "tombstones": None, "next_zero": "/ab", "next_slash": "/ab/c",
            "next_other": "/abc", "ends_in_slash": "/ab/c", "len_L_no_boundary": "/" + "a" * 31}
    prefix, n, want = {"zeros": ("/", 1, False), "tombstones": ("/", 1, False),
                       "next_zero": ("/ab", 3, True), "next_slash": ("/ab", 3, True),
                       "next_other": ("/ab", 3, False), "ends_in_slash": ("/ab/", 4, True),
                       "len_L_no_boundary": ("/" + "a" * 31, 32, True)}[case]
    toks = (np.full((1, L), 255, np.uint8) if rows[case] is None
            else _pack([rows[case]], L))
    toks = np.repeat(toks, 33, axis=0)              # a full warp and one lane more
    prefs, lens = _pack([prefix], L), np.array([n], np.int32)
    got, _ = _mirror_prefix_search(toks, prefs, lens)
    plain = ref.prefix_search_ref(torch.from_numpy(toks), torch.from_numpy(prefs),
                                  torch.from_numpy(lens)).numpy()
    assert np.array_equal(got, plain) and (plain == want).all()


def test_prefix_search_kernel_body_leaves_early_on_sorted_rows():
    """On the smoke's kind of table (sorted /dimDD/topic_DDTTT/... rows)
    and its kind of prefix (a topic, 18 bytes = 5 words), the warps go
    past word 3 only where their rows share the prefix's dimension and
    the first digit of its topic: on average at most one more word a
    (warp, prefix), where a full walk would compare all 24 words of a row
    at L = 96."""
    L = 96
    paths = sorted(f"/dim{d:02d}/topic_{d:02d}{t:03d}/entity_{t:03d}{k:03d}"
                   for d in range(4) for t in range(16) for k in range(8))
    toks = _pack(paths, L)
    topics = [f"/dim{d:02d}/topic_{d:02d}{t:03d}" for d, t in ((0, 3), (1, 7), (3, 15), (2, 0))]
    prefs = _pack(topics, L)
    lens = np.array([len(p) for p in topics], np.int32)
    got, compared = _mirror_prefix_search(toks, prefs, lens)
    assert np.array_equal(got, ref.prefix_search_ref(
        torch.from_numpy(toks), torch.from_numpy(prefs), torch.from_numpy(lens)).numpy())
    assert got.sum() == 4 * 8
    warps = len(paths) // 32
    assert compared <= warps * len(topics)          # a word past word 1 on average, not 22


def _writeout_coverage(N, Q, out_stride, base):
    """Bytes of the (N, out_stride) output written by the kernels of one
    call (Q split into Q_CHUNK launches), each tile's bitmap copied out in
    pieces of 16, 4 or 1 bytes as the alignment of base + q0, out_stride
    and nq allows, as csrc/prefix_search.cu does."""
    from repro_torch.kernels.prefix_search import Q_CHUNK, TILE
    seen = np.zeros((N, out_stride), np.int64)
    for q0 in range(0, Q, Q_CHUNK):
        nq = min(Q_CHUNK, Q - q0)
        align = (base + q0) | out_stride | nq
        piece = 16 if align % 16 == 0 else 4 if align % 4 == 0 else 1
        rs = -(-nq // 16) * 16 + 16
        assert rs % 16 == 0 and rs >= -(-nq // 4) * 4      # the packs fit the padded row
        for row0 in range(0, N, TILE):
            rows, per_row = min(TILE, N - row0), nq // piece
            for i in range(rows * per_row):
                r, c = divmod(i, per_row)
                seen[row0 + r, q0 + c * piece:q0 + (c + 1) * piece] += 1
    return seen


@pytest.mark.parametrize("N,Q,out_stride,base", [
    (300, 64, 64, 0), (300, 5, 5, 0), (513, 257, 257, 0), (513, 300, 300, 0),
    (256, 16, 16, 0), (257, 4, 4, 0), (33, 1, 1, 0), (40, 64, 64, 4), (40, 512, 512, 0)])
def test_prefix_search_writeout_covers_each_byte_once(N, Q, out_stride, base):
    seen = _writeout_coverage(N, Q, out_stride, base)
    assert (seen[:, :Q] == 1).all() and (seen[:, Q:] == 0).all()


@pytest.mark.parametrize("n_rows,L,n_q,want", [
    (1_316_000, 96, 64, (528, 256, 29184)),     # the smoke's Q4 launch: 4 blocks an SM
    (1_316_000, 96, 4, (528, 256, 8736)),       # a short Q4 wave (Q padded to 4)
    (1_316_000, 96, 256, (264, 256, 104448)),   # a full Q chunk: 2 blocks an SM
    (1_316_000, 128, 256, (264, 256, 112640)),  # the largest block
    (1_316_000, 128, 128, (396, 256, 58368)),   # above 48 KB: 3 an SM
    (1_316_000, 32, 256, (264, 256, 88064)),
    (1_316_000, 32, 4, (528, 256, 8480)),
    (300, 32, 44, (2, 256, 19552)),             # the second chunk of Q = 300
    (300, 48, 5, (2, 256, 8752)),
    (33, 32, 1, (1, 256, 8384)),
    (256, 64, 3, (1, 256, 8544)),
    (257, 64, 3, (2, 256, 8544)),
])
def test_prefix_search_geometry(n_rows, L, n_q, want):
    from repro_torch.kernels.prefix_search import (BLOCKS_PER_SM, Q_CHUNK, SMEM_MAX, SMEM_SM,
                                                   TILE, search_geometry)
    blocks, tile, smem = got = search_geometry(n_rows, L, n_q)
    assert got == want
    assert tile == TILE and smem <= SMEM_MAX
    assert smem == n_q * L + 40 * (-(-n_q // 4) * 4) + TILE * (-(-n_q // 16) * 16 + 16)
    per_sm = -(-blocks // 132)
    assert per_sm <= BLOCKS_PER_SM and per_sm * (smem + 1024) <= SMEM_SM
    assert blocks == min(-(-n_rows // TILE), 132 * per_sm) or blocks == -(-n_rows // TILE)
    assert search_geometry(n_rows, 128, Q_CHUNK)[2] <= SMEM_MAX


# ---------------------------------------------------------------------------
# moe_router launch geometry and lane layout (csrc/moe_router.cu)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,E,k,want", [
    (4096, 16, 4, (2, 1, 256)),     # dbrx prefill: two tokens a warp
    (4, 16, 4, (2, 1, 1)),          # dbrx decode
    (4096, 16, 2, (2, 1, 256)),     # jamba
    (4099, 16, 4, (2, 1, 257)),     # ragged: the last warp's second token is past T
    (3, 16, 16, (2, 1, 1)),
    (1, 4, 2, (2, 1, 1)),
    (4096, 17, 4, (1, 1, 512)),     # one expert more: one token a warp
    (4096, 32, 4, (1, 1, 512)),
    (33, 33, 2, (1, 2, 5)),
    (4096, 384, 8, (1, 12, 512)),   # kimi-k2
    (5, 700, 32, (1, 24, 1)),
    (8, 1024, 8, (1, 32, 1)),
    (0, 16, 4, (2, 1, 0)),
])
def test_router_geometry(T, E, k, want):
    from repro_torch.kernels.moe_router import V_INSTANCES, WARPS, router_geometry
    tpw, v, blocks = got = router_geometry(T, E)
    assert got == want
    sub = 32 // tpw
    assert (tpw == 2) == (E <= 16) and k <= sub
    assert v == min(u for u in V_INSTANCES if sub * u >= E)     # the least that holds E
    assert (blocks - 1) * WARPS * tpw < T <= blocks * WARPS * tpw or T == blocks == 0


@pytest.mark.parametrize("E", [1, 4, 15, 16, 17, 32, 384, 1024])
def test_router_lane_layout_holds_each_expert_once(E):
    """A token's experts over its lanes' slots (sub-lane s, slot v holds
    expert s + SUB v): each expert of each token of a warp is held once,
    by one of that token's lanes, and every shuffle offset (SUB/2 .. 1)
    pairs a lane with a lane of the same token."""
    from repro_torch.kernels.moe_router import router_geometry
    tpw, v, _ = router_geometry(8, E)
    sub = 32 // tpw
    held = np.zeros((tpw, E), np.int64)
    for lane in range(32):
        token, sl = lane // sub, lane % sub
        for slot in range(v):
            if sl + sub * slot < E:
                held[token, sl + sub * slot] += 1
        o = sub // 2
        while o:
            assert (lane ^ o) // sub == token
            o >>= 1
    assert (held == 1).all()


ROUTER_BWD_E = [1, 2, 3, 4, 5, 16, 17, 32, 33, 384, 700, 1024]
#: the training paths' calls: dbrx, jamba, jamba's cut to 2 experts,
#: kimi-k2's cut to 32 and kimi-k2 at 384, the ragged row
ROUTER_BWD_WANT = {(4096, 16, 4): (4, 1, 4, 128), (4096, 16, 2): (4, 1, 4, 128),
                   (4096, 2, 2): (1, 1, 4, 32), (4096, 32, 8): (8, 1, 4, 256),
                   (4096, 384, 8): (32, 3, 2, 2048), (4099, 16, 4): (4, 1, 4, 129)}


def _bwd_width(n: int) -> int:
    """The widest access csrc/moe_router.cu takes over rows of n floats
    (on aligned bases, as the wrapper's allocations are)."""
    return 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1


@pytest.mark.parametrize("T", [0, 1, 4096, 4099])
@pytest.mark.parametrize("E,k", sorted({(E, k) for E in ROUTER_BWD_E for k in (1, min(E, 32))}))
def test_router_bwd_geometry(T, E, k):
    """Lanes a token: the least power of two with 4 lanes >= E, at most 32;
    pieces: the least compiled count that holds E; warps a block 4 (2 at a
    token a warp) or as many as T needs, within the instance's most;
    blocks exactly enough for T (the C entry refuses any other)."""
    from repro_torch.kernels.moe_router import BWD_PIECES, bwd_max_warps, router_bwd_geometry
    L, P, W, blocks = got = router_bwd_geometry(T, E, k)
    if (T, E, k) in ROUTER_BWD_WANT:
        assert got == ROUTER_BWD_WANT[(T, E, k)]
    assert L in (1, 2, 4, 8, 16, 32) and (L == 32 or 4 * L >= E) and (L == 1 or 2 * L < E)
    assert P == (1 if L < 32 else min(p for p in BWD_PIECES if 128 * p >= E))
    assert 4 * L * P >= E and k <= 4 * L * P
    assert 1 <= W <= bwd_max_warps(L) <= 32
    warps_all = -(-T // (32 // L))
    assert W == max(1, min(2 if L == 32 else 4, warps_all))
    tokens = W * (32 // L)                  # tokens a block
    assert blocks == -(-T // tokens)


def _fwd_sum(p: np.ndarray) -> np.float32:
    """The softmax's sum as csrc/moe_router.cu's forward kernel takes it:
    sub-lane f of SUB (16 at E <= 16, else 32) adds columns f, f + SUB, ...
    in turn from 0 over V slots, then a butterfly over offsets SUB/2 .. 1."""
    from repro_torch.kernels.moe_router import V_INSTANCES
    E = p.shape[0]
    sub = 16 if E <= 16 else 32
    V = min(v for v in V_INSTANCES if sub * v >= E)
    col = np.concatenate([p, np.zeros(sub * V - E, np.float32)]).reshape(V, sub)
    acc = np.zeros(sub, np.float32)
    for v in range(V):
        acc = (acc + col[v]).astype(np.float32)
    o = sub // 2
    while o:
        acc = (acc + acc[np.arange(sub) ^ o]).astype(np.float32)
        o //= 2
    assert (acc == acc[0]).all()
    return acc[0]


def _bwd_sum(p: np.ndarray) -> np.float32:
    """The same sum as the backward kernel takes it over its layout (lane
    l's piece q holds columns 4 (l + L q) .. + 3), written the way the
    kernel's shuffles take it: a narrow row (L < 32) in registers; a wide
    one from its stage in shared memory, lane f adding columns f + 32 u
    in turn, then the same butterfly as the forward's."""
    from repro_torch.kernels.moe_router import router_bwd_geometry
    E = p.shape[0]
    L, P, _, _ = router_bwd_geometry(1, E, 1)
    x = np.concatenate([p, np.zeros(4 * L * P - E, np.float32)]).reshape(P, L, 4)
    lanes = np.arange(L)
    if L == 32:
        stage = x.reshape(-1)               # column e at (e >> 7, (e >> 2) & 31, e & 3)
        acc = np.zeros(32, np.float32)
        for u in range(4 * P):
            acc = (acc + stage[lanes + 32 * u]).astype(np.float32)
        o = 16
        while o:
            acc = (acc + acc[lanes ^ o]).astype(np.float32)
            o //= 2
        assert (acc == acc[0]).all()
        return acc[0]
    acc = x[0].copy()
    if L == 16:
        acc = (acc + acc[lanes ^ 8]).astype(np.float32)
    o = (16 if L <= 4 else 32) // 8
    while o:
        if o < L:
            acc = (acc + acc[lanes ^ o]).astype(np.float32)
        o //= 2
    s = ((acc[:, 0] + acc[:, 2]).astype(np.float32) + (acc[:, 1] + acc[:, 3]).astype(np.float32))
    s = s.astype(np.float32)
    assert (s == s[0]).all()                # every lane of the token holds the same sum
    return s[0]


@pytest.mark.parametrize("E", ROUTER_BWD_E)
def test_router_bwd_softmax_sum_in_the_forwards_order(E):
    """Without renormalize the backward recomputes p; its sum over its own
    lane layout adds in the forward kernel's order, so p is the forward's
    to the bit: the two orders agree bit for bit on values of many
    magnitudes (where another order rounds differently)."""
    rs = np.random.RandomState(E)
    for _ in range(20):
        p = np.exp(rs.standard_normal(E) * 6).astype(np.float32)
        assert _bwd_sum(p) == _fwd_sum(p)


@pytest.mark.parametrize("E", ROUTER_BWD_E)
def test_router_bwd_layout_writes_each_column_once(E):
    """Over the launch's grid (router_bwd_geometry at a ragged T), every
    column of every token is written by exactly one lane of that token, in
    stores of the width its rows allow, none reaching past its row or past
    the flat (T, E) tail; each chosen id has exactly one owning lane there
    and a slot within its pieces."""
    from repro_torch.kernels.moe_router import router_bwd_geometry
    for T in (1, 37):
        L, P, W, blocks = router_bwd_geometry(T, E, min(E, 32))
        width = _bwd_width(E)
        written = np.zeros(T * E, np.int64)
        owners = np.zeros((T, E), np.int64)
        for thread in range(blocks * W * 32):
            warp, lane = divmod(thread, 32)
            t, sl = warp * (32 // L) + lane // L, lane % L
            if t >= T:
                continue
            for q in range(P):
                col = 4 * (sl + L * q)
                for h in range(0, 4, width):
                    if col + h < E:
                        assert col + h + width <= E          # within the row
                        lo = t * E + col + h
                        assert lo % width == 0 and lo + width <= T * E
                        written[lo:lo + width] += 1
            for ident in range(E):                            # the kernel's owner and slot
                if ((ident >> 2) & (L - 1)) == sl:
                    assert ((ident >> 2) // L) * 4 + (ident & 3) < 4 * P
                    assert 4 * (sl + L * ((ident >> 2) // L)) + (ident & 3) == ident
                    owners[t, ident] += 1
        assert (written == 1).all() and (owners == 1).all()


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
    ops.attention(torch.randn(1, 2, 5, 16), torch.randn(1, 1, 9, 16), torch.randn(1, 1, 9, 16))
    ops.moe_router(torch.randn(6, 16), 4)
    # a backward through the CPU dispatch is autograd of the plain versions
    x = torch.randn(1, 2, 5, 16, requires_grad=True)
    ops.rmsnorm(ops.attention(x, x[:, :1], x[:, :1]), torch.ones(16)).sum().backward()
    ops.moe_router(torch.randn(6, 16, requires_grad=True), 4)[0].sum().backward()
    s = ops.decode_scores(torch.randn(1, 2, 4), torch.randn(1, 1, 8, 4),
                          torch.tensor([5], dtype=torch.int32), sm_scale=0.25)
    ops.decode_combine(s, torch.randn(1, 1, 8, 4), torch.tensor([5], dtype=torch.int32))
    assert ops.LAUNCHES == {"path_lookup": 0, "prefix_search": 0, "decode_attention": 0,
                            "flash_attention": 0, "rmsnorm": 0, "moe_router": 0,
                            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "moe_router_bwd": 0,
                            "decode_scores": 0, "decode_combine": 0}


# ---------------------------------------------------------------------------
# launch geometry chosen on the host (pure Python, so it is tested here)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Hq,Sq,D,want", [
    (1, 16, 4096, 128, 128),   # qwen3-1.7B prefill: 512 blocks of 128 queries
    (1, 16, 128, 128, 64),     # its chunked prefill: 16 blocks of 128 would idle 116 SMs
    (1, 16, 448, 64, 64),      # whisper's 448 x 1500 cross-attention at B = 1
    (1, 48, 1024, 128, 128),   # dbrx's group 6 at S=1024
    (1, 48, 4096, 128, 128),   # dbrx prefill
    (1, 64, 4096, 112, 128),   # kimi-k2 prefill: no 192 above head_dim 64
    (1, 4, 113, 64, 64),       # the oracle's NLLs
    (1, 132, 128, 128, 128),   # exactly one wave of 128-query blocks
    (1, 131, 128, 128, 64),    # one block short of a wave
    (2, 33, 129, 128, 128),    # 2 * 33 * 2 = 132
    (1, 1, 1, 64, 64),
    # head_dim 64: three warpgroups where the grid fills the card and the
    # tiles of 192 pad at most 1/16 more rows than tiles of 128
    (4, 16, 1500, 64, 192),    # whisper's encoder: 1536 rows either way
    (1, 14, 4096, 64, 192),    # internvl2-1b prefill: 4224 rows against 4096
    (4, 16, 448, 64, 128),     # whisper's decoder and cross-attention: 576 against 512
    (1, 132, 128, 32, 128),    # 192 rows against 128
    (1, 131, 192, 64, 128),    # one block short of a wave of 192: two of 128
    (2, 66, 257, 64, 192),     # 384 rows either way: 132 blocks of 192
])
def test_flash_query_tile(B, Hq, Sq, D, want):
    from repro_torch.kernels.flash_attention import BLOCK_Q, query_tile
    tile = query_tile(B, Hq, Sq, D=D)
    assert tile == want
    assert tile % BLOCK_Q == 0 and (tile < 192 or D <= 64)
    one = query_tile(B, Hq, Sq, n_sm=1, D=D)       # every grid fills one SM
    assert one == (192 if D <= 64 and 16 * -(-Sq // 192) * 192 <= 17 * -(-Sq // 128) * 128
                   else 128)


@pytest.mark.parametrize("rows,D,elt,vec_ok,want", [
    (4, 256, 4, True, (32, 1, 4)),          # router decode, f32
    (4, 64, 4, True, (32, 1, 4)),           # router qk-norm rows
    (65536, 128, 2, True, (128, 4, 8)),     # qwen3 qk-norm
    (4096, 2048, 2, True, (64, 1, 8)),      # qwen3 block norm: 4 vectors a thread
    (4096, 6144, 2, True, (192, 1, 8)),     # dbrx block norm, prefill
    (4, 6144, 2, True, (192, 1, 8)),        # dbrx decode
    (4096, 6144, 4, True, (384, 1, 4)),     # f32 at d_model 6144
    (7, 130, 2, True, (32, 1, 1)),          # 260-byte rows: the scalar body
    (4096, 128, 2, False, (128, 4, 1)),     # a misaligned base: the scalar body
    (1000, 1024, 2, True, (64, 2, 8)),      # the longest bf16 warp row: 4 vectors a lane
    (1000, 1024, 4, True, (64, 1, 4)),      # f32 rows of 1024: a block row
    (3, 1030, 2, True, (256, 1, 1)),        # a block row of odd bytes
])
def test_rmsnorm_launch_geometry(rows, D, elt, vec_ok, want):
    from repro_torch.kernels.rmsnorm import NVMAX, launch_geometry
    threads, rpb, vec = got = launch_geometry(rows, D, elt, vec_ok)
    assert got == want
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert vec in (1, 16 // elt) and (vec == 1 or (D * elt) % 16 == 0)
    tpr = 32 if threads == 32 * rpb else threads      # a warp a row, or the block
    assert rpb == 1 or tpr == 32
    if vec > 1:
        assert -(-(D // vec) // tpr) <= NVMAX
    if rpb > 1:                      # never fewer than two waves of 132 blocks
        assert -(-rows // rpb) >= 2 * 132


# ---------------------------------------------------------------------------
# the backward kernels' launch geometry and the flash backward's bf16
# rounding (pure Python, so they are tested here; the kernels follow them
# on the card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,bf16,want", [
    # qwen3-1.7B training: 256 key blocks of 128 keys walk up to 2 x 64
    # query tiles, 512 query blocks up to 64 key tiles; keys first
    ((1, 16, 8, 4096, 4096), True, (2, 128, 256, 512, 128, 64, False, 1)),
    # ragged 128 x 4096: 16 query blocks walk 64 key tiles each, so they start first
    ((1, 16, 8, 128, 4096), True, (2, 128, 256, 16, 4, 64, True, 1)),
    # whisper's non-causal 448 x 1500
    ((1, 16, 16, 448, 1500), True, (2, 128, 192, 64, 7, 24, True, 1)),
    # dbrx's group 6: its heads split over 3 key-tile blocks of the same keys
    ((1, 48, 8, 1024, 1024), True, (2, 128, 192, 384, 32, 16, False, 3)),
    # small grids keep one consumer warpgroup a block
    ((1, 2, 2, 37, 37), True, (1, 64, 2, 2, 1, 1, False, 1)),
    ((1, 16, 8, 200, 1037), True, (1, 64, 136, 64, 8, 17, True, 1)),
    # the router's f32 training: the f32 body's 64-row tiles, its group of 2
    # split over 2 key-tile blocks of the same keys
    ((8, 4, 2, 128, 128), False, (0, 64, 64, 64, 2, 2, False, 2)),
    # kimi-k2's ragged f32 shape: its group of 8 over 8 key-tile blocks
    ((1, 8, 1, 300, 1037), False, (0, 64, 136, 40, 5, 17, True, 8)),
])
def test_flash_bwd_geometry(shape, bf16, want):
    from repro_torch.kernels.flash_attention import BWD_ROWS, bwd_geometry
    B, Hq, Hkv, Sq, Skv = shape
    geo = bwd_geometry(B, Hq, Hkv, Sq, Skv, bf16)
    assert tuple(geo) == want
    assert geo.rows == BWD_ROWS * max(geo.warpgroups, 1)
    # every key and every query has one block of its role (a key-tile
    # block one of head_split)
    pairs = geo.key_blocks // geo.head_split
    assert pairs * geo.head_split == geo.key_blocks
    assert pairs * geo.rows >= B * Hkv * Skv > (pairs - B * Hkv) * geo.rows
    assert geo.query_blocks * geo.rows >= B * Hq * Sq > (geo.query_blocks - B * Hq) * geo.rows
    if bf16 and geo.warpgroups == 1:      # two warpgroups a block would leave SMs idle
        assert B * Hkv * -(-Skv // 128) + B * Hq * -(-Sq // 128) < 132
    assert bwd_geometry(B, Hq, Hkv, Sq, Skv, bf16, n_sm=1).warpgroups == (2 if bf16 else 0)


# (tag, B, Hq, Hkv, S_q, S_kv, D, bf16, causal, head split): the zoo's
# training shapes of flash_attention_bwd (chip_smoke.FLASH_BWD_SHAPES)
ZOO_BWD_SHAPES = [
    ("router", 8, 4, 2, 128, 128, 64, False, True, 2),
    ("qwen3", 1, 16, 8, 4096, 4096, 128, True, True, 1),
    ("dbrx", 1, 48, 8, 1024, 1024, 128, True, True, 3),
    ("jamba", 1, 32, 8, 4096, 4096, 128, True, True, 1),
    ("internvl2", 1, 14, 2, 4096, 4096, 64, True, True, 3),
    ("kimi-k2", 1, 64, 8, 4096, 4096, 112, True, True, 1),
    ("whisper cross", 4, 16, 16, 448, 1500, 64, True, False, 1),
    ("whisper encoder", 4, 16, 16, 1500, 1500, 64, True, False, 1),
    ("whisper decoder", 4, 16, 16, 448, 448, 64, True, True, 1),
]


def _split_heads(G, c, part):
    """The query heads [lo, hi) of a group of G that part ``part`` of a
    head split c walks, as csrc/flash_attention_bwd.cu computes them."""
    return part * G // c, (part + 1) * G // c


def _bwd_blocks(B, Hq, Hkv, Sq, Skv, causal, geo):
    """The key-tile blocks of a backward launch in grid order, as
    csrc/flash_attention_bwd.cu decodes blockIdx (part fastest, then the
    sequence and KV head, then the key block): (b, KV head, first key,
    heads [lo, hi), query tiles walked a head), and the query-tile
    blocks' key tiles walked."""
    from repro_torch.kernels.flash_attention import BWD_ROWS
    G, c, off = Hq // Hkv, geo.head_split, Skv - Sq
    n_qt = -(-Sq // BWD_ROWS)
    keys = []
    for idx in range(geo.key_blocks):
        part, pair = idx % c, idx // c
        bkv, k0 = pair % (B * Hkv), pair // (B * Hkv) * geo.rows
        qt0 = max(0, k0 - off) // BWD_ROWS if causal else 0
        keys.append((bkv // Hkv, bkv % Hkv, k0, *_split_heads(G, c, part), n_qt - qt0))
    queries = [-(-(min(Skv, min(Sq, q0 + geo.rows) + off) if causal else Skv) // BWD_ROWS)
               for q0 in range(0, Sq, geo.rows)] * (B * Hq)
    return keys, queries


@pytest.mark.parametrize("tag,B,Hq,Hkv,Sq,Skv,D,bf16,causal,split", ZOO_BWD_SHAPES,
                         ids=[z[0] for z in ZOO_BWD_SHAPES])
def test_flash_bwd_head_split_at_the_zoo_shapes(tag, B, Hq, Hkv, Sq, Skv, D, bf16, causal,
                                                split):
    """Over the launch of each training shape: every (sequence, KV head,
    key tile, query head) is walked by exactly one key-tile block; the
    longest key-tile block costs no more than one SM's share of the grid
    (4 products a query tile of a head, 3 a key tile of a query-tile
    block) or, where no split reaches it, one head's walk, and one part
    fewer would not do, in both bodies; in bf16 groups of 4 and less and
    kimi-k2 keep the unsplit geometry of before the split."""
    from repro_torch.kernels.flash_attention import BWD_ROWS, bwd_geometry
    geo = bwd_geometry(B, Hq, Hkv, Sq, Skv, bf16, 132, causal)
    assert geo.head_split == split
    G, n_qt, n_kt = Hq // Hkv, -(-Sq // BWD_ROWS), -(-Skv // BWD_ROWS)
    keys, queries = _bwd_blocks(B, Hq, Hkv, Sq, Skv, causal, geo)
    walked = np.zeros((B, Hkv, n_kt, G), np.int64)
    for b, hk, k0, lo, hi, nq in keys:
        for kt in range(k0 // BWD_ROWS, min(n_kt, (k0 + geo.rows) // BWD_ROWS)):
            walked[b, hk, kt, lo:hi] += 1
    assert (walked == 1).all()
    assert geo.query_blocks == len(queries) and geo.query_block_tiles == max(queries)
    cost = [4 * (hi - lo) * nq for *_, lo, hi, nq in keys]
    share = (sum(cost) + 3 * sum(queries)) / 132
    assert max(cost) == 4 * geo.key_block_tiles
    assert max(cost) <= max(share, 4 * n_qt)
    if split > 1:
        assert 4 * -(-G // (split - 1)) * n_qt > share
    if bf16 and (G <= 4 or tag == "kimi-k2"):
        wg = (2 if B * Hkv * -(-Skv // 128) + B * Hq * -(-Sq // 128) >= 132 else 1) if bf16 \
            else 0
        rows = max(wg, 1) * BWD_ROWS
        assert tuple(geo) == (wg, rows, B * Hkv * -(-Skv // rows), B * Hq * -(-Sq // rows),
                              G * n_qt, n_kt, 3 * n_kt > 4 * G * n_qt, 1)


@pytest.mark.parametrize("tag,B,Hq,Hkv,Sq,Skv,D,bf16,causal,split", ZOO_BWD_SHAPES,
                         ids=[z[0] for z in ZOO_BWD_SHAPES])
def test_flash_bwd_workspace(tag, B, Hq, Hkv, Sq, Skv, D, bf16, causal, split):
    """The f32 scratch the wrapper allocates for a call of either body:
    lse2 and delta of every query row padded to tiles of 64, and with a
    head split a 128-thread block of (dK, dV) partials, the tile's columns
    each, for every 64 rows of every key-tile block (internvl2-1b: 12.6
    MB; the router's f32 training 2.1 MB)."""
    from repro_torch.kernels.flash_attention import (BWD_ROWS, bwd_geometry,
                                                     bwd_workspace_floats, tile_columns)
    geo = bwd_geometry(B, Hq, Hkv, Sq, Skv, bf16, 132, causal)
    rows = 2 * B * Hq * -(-Sq // BWD_ROWS) * BWD_ROWS
    parts = geo.key_blocks * geo.rows * 2 * tile_columns(D) if split > 1 else 0
    assert bwd_workspace_floats(B, Hq, Sq, D, geo) == rows + parts
    assert tile_columns(D) == {64: 64, 112: 128, 128: 128}[D]
    if tag == "internvl2":
        assert 4 * parts == 3 * 2 * 4096 * 64 * 4 * 2 == 12_582_912
    if tag == "dbrx":
        assert 4 * parts == 3 * 8 * 1024 * 128 * 4 * 2
    if tag == "router":
        assert 4 * parts == 2 * 8 * 2 * 2 * 128 * 64 * 4 == 2_097_152


def test_flash_bwd_split_within_a_slot_of_tickets():
    """A head-split launch draws one ticket a (sequence, KV head, key
    block) pair from its stream's slot of TICKETS_A_SLOT: on a card of
    many SMs every grid would split, but not one of more pairs."""
    from repro_torch.kernels import flash_attention as fa
    fits = fa.bwd_geometry(1, 16, 2, 64, fa.TICKETS_A_SLOT // 2 * 64, True, 10 ** 6)
    assert fits.head_split == 8 and fits.key_blocks == 8 * fa.TICKETS_A_SLOT
    over = fa.bwd_geometry(1, 16, 2, 64, (fa.TICKETS_A_SLOT // 2 + 1) * 64, True, 10 ** 6)
    assert over.head_split == 1


def test_flash_bwd_split_heads_cover_the_group():
    """Part p of a split c walks heads [p G / c, (p + 1) G / c): the parts
    cover the group once, each ceil(G / c) or floor(G / c) heads."""
    for G in range(1, 17):
        for c in range(1, G + 1):
            parts = [_split_heads(G, c, p) for p in range(c)]
            assert [h for lo, hi in parts for h in range(lo, hi)] == list(range(G))
            assert {hi - lo for lo, hi in parts} <= {G // c, -(-G // c)}


@pytest.mark.parametrize("rows,D,elt,vec_ok,want", [
    (1024, 256, 4, True, (32, 2, 4, 128, 8)),      # the router's norms, f32
    (4096, 2048, 2, True, (128, 2, 8, 264, 8)),    # qwen3's block norms: two vectors a thread
    (65536, 128, 2, True, (8, 2, 8, 264, 8)),      # its qk-norm: 32 rows a block
    (8, 6144, 2, True, (256, 4, 8, 8, 8)),         # dbrx's rows: three vectors of four used
    (7, 130, 4, True, (32, 8, 1, 1, 1)),           # 520-byte rows: the scalar body
    (64, 130, 2, False, (32, 8, 1, 8, 8)),         # a misaligned base: the scalar body
    (33, 16, 2, True, (1, 2, 8, 1, 1)),            # one thread a row, 256 rows a block
    (15, 64, 2, True, (4, 2, 8, 1, 1)),            # one block, a cluster of one
    (100, 8192, 4, True, (256, 8, 4, 96, 8)),      # the longest f32 row: whole clusters of 8
    (100, 8192, 2, False, (256, 32, 1, 96, 8)),    # the longest scalar row
])
def test_rmsnorm_bwd_geometry(rows, D, elt, vec_ok, want):
    from repro_torch.kernels.rmsnorm import (BWD_BLOCKS_PER_SM, BWD_MAX_CLUSTER, BWD_MAX_D,
                                             bwd_geometry)
    tpr, units, vec, blocks, cluster = got = bwd_geometry(rows, D, elt, vec_ok)
    assert got == want
    assert tpr & (tpr - 1) == 0 and 1 <= tpr <= 256 and units & (units - 1) == 0
    assert vec in (1, 16 // elt) and (vec == 1 or (D * elt) % 16 == 0)
    assert tpr * units * vec >= D and units * vec <= 32          # 32 floats a thread at most
    assert tpr * (units // 2) * vec < D or units == 1              # no unit column wasted twice
    assert blocks <= BWD_BLOCKS_PER_SM * 132 and blocks * (256 // tpr) < rows + 256 // tpr
    assert cluster & (cluster - 1) == 0 and cluster <= BWD_MAX_CLUSTER and blocks % cluster == 0
    with pytest.raises(ValueError, match="exceed"):
        bwd_geometry(rows, BWD_MAX_D + 8, elt, vec_ok)


def test_rmsnorm_bwd_counters_one_slot_a_stream(monkeypatch):
    """Each (kernel, device, stream) gets its own slot of the kernel's
    zeroed int32 counter buffer on the device, the same one on every call
    (rmsnorm_bwd's dscale counters, flash_attention_bwd's tickets); more
    streams than slots raise."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn
    monkeypatch.setattr(build, "_SLOT_BUFFERS", {})
    monkeypatch.setattr(build, "_STREAM_SLOTS", {})
    monkeypatch.setattr(build, "STREAM_SLOTS", 3)
    x = torch.zeros(2, 8)
    a = build.stream_slot("rmsnorm_bwd", x, 11, rn.COUNTERS_A_SLOT)
    b = build.stream_slot("rmsnorm_bwd", x, 22, rn.COUNTERS_A_SLOT)
    assert b - a == 4 * rn.COUNTERS_A_SLOT
    assert build.stream_slot("rmsnorm_bwd", x, 11, rn.COUNTERS_A_SLOT) == a
    buf = build._SLOT_BUFFERS[("rmsnorm_bwd", x.get_device())]
    assert buf.dtype == torch.int32 and buf.numel() == 3 * rn.COUNTERS_A_SLOT
    assert int(buf.abs().sum()) == 0
    other = build.stream_slot("flash_attention_bwd", x, 11, 1024)   # a buffer of its own
    assert build._SLOT_BUFFERS[("flash_attention_bwd", x.get_device())].data_ptr() == other
    build.stream_slot("rmsnorm_bwd", x, 33, rn.COUNTERS_A_SLOT)
    with pytest.raises(RuntimeError, match="streams"):
        build.stream_slot("rmsnorm_bwd", x, 44, rn.COUNTERS_A_SLOT)


def test_flash_bwd_tensor_maps_take_the_layers_strides():
    """q, k, v and dO of the attention layer are transposed views: a TMA
    map reads them as they are; a size-1 dimension takes its contiguous
    stride; a row that is not contiguous, or a base or stride off 16
    bytes, is refused (the wrapper then copies)."""
    from repro_torch.kernels.flash_attention import tma_strides
    B, S, H, D = 2, 48, 4, 64
    t = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    assert tma_strides(t) == (S * H * D, D, H * D)
    assert tma_strides(torch.zeros(1, H, S, D, dtype=torch.bfloat16)) == (H * S * D, S * D, D)
    one = torch.zeros(1, S, 1, D, dtype=torch.bfloat16).transpose(1, 2)
    assert tma_strides(one) == (S * D, S * D, D)
    assert tma_strides(torch.zeros(B, H, D, S, dtype=torch.bfloat16).transpose(2, 3)) is None
    odd = torch.zeros(B * H * S * D + 1, dtype=torch.bfloat16)[1:].view(B, H, S, D)
    assert tma_strides(odd) is None
    pad = torch.zeros(B, H, S, D + 4, dtype=torch.bfloat16)[..., :D]
    assert tma_strides(pad) is None                       # rows 136 bytes apart


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header names another library, so a stale build
    is never loaded."""
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.lib_path("k")
    assert build.lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.lib_path("k") != first


def _bf16_body_emulation(q, k, v, o, lse, do, causal=True):
    """The arithmetic of the bf16 wgmma body on the CPU: products of bf16
    operands summed in f32, P = exp2(s * scale * log2 e - lse * log2 e),
    dS = P (dP - delta), and P and dS rounded to bf16 before they enter
    dV += P^T dO, dK += dS^T Q and dQ += dS K; delta = rowsum(dO O) in f32;
    outputs rounded once to bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    log2e = 1.4426950408889634
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    if causal:
        pos = torch.arange(Sq)[:, None] + (Skv - Sq)
        p = torch.where(pos >= torch.arange(Skv)[None, :], p, torch.zeros_like(p))
    delta = (dof * o.float()).sum(-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    p16, ds16 = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds16, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds16, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, dof)
    dk = dk.reshape(B, Hkv, G, Skv, D).sum(2)
    dv = dv.reshape(B, Hkv, G, Skv, D).sum(2)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def test_flash_bwd_bf16_rounding_holds_the_card_tolerance():
    """Before any chip time: the bf16 body's roundings (P and dS to bf16
    ahead of the register-A products, f32 sums) at 1024 x 1024, D = 128,
    group 2, causal, stay within the card test's bf16 tolerance (2e-2
    absolute and relative) of ref.attention_bwd_ref; dQ sums 1024 keys and
    dK 2 x 1024 queries."""
    rs = np.random.RandomState(19)
    B, Hq, Hkv, S, D = 1, 4, 2, 1024, 128
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, S, D).astype(np.float32)).to(torch.bfloat16)
                   for H in (Hq, Hkv, Hkv, Hq))
    o, lse = ref.attention_ref(q, k, v, causal=True, return_lse=True)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    got = _bf16_body_emulation(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=2e-2, rtol=2e-2)
        assert float((g.float() - w.float()).abs().max()) > 0      # the roundings do show


# ---------------------------------------------------------------------------
# decode_attention's launch plan and path_lookup's block geometry (pure
# Python, so they are tested here; the kernels follow them on the card)
# ---------------------------------------------------------------------------
def _decode_coverage(S, length, warps, blocks):
    """How often csrc/decode_attention.cu's loops visit each position: block
    blk of a (sequence, KV head) takes [blk * span, min(+span, length)),
    span a whole number of 32-position chunks, and its warp w the chunks
    from lo + 32 w in steps of 32 * warps."""
    seen = np.zeros(max(S, 1), np.int64)
    span = -(-(-(-S // 32)) // blocks) * 32
    length = min(length, S)
    for blk in range(blocks):
        lo, hi = blk * span, min(blk * span + span, length)
        for w in range(warps):
            for base in range(lo + 32 * w, hi, 32 * warps):
                seen[base:min(base + 32, hi)] += 1
    return seen


@pytest.mark.parametrize("B,Hkv,G,S,D,elt,want", [
    (4, 2, 2, 512, 64, 4, (8, 4, True)),        # wikikv-router serving, f32: 8 blocks, split 4 ways
    (8, 2, 2, 512, 64, 4, (8, 4, True)),        # the smoke's 8-lane shape
    (8, 2, 2, 4096, 64, 4, (16, 8, True)),      # the smoke's long cache: 128 blocks, one wave
    (8, 2, 2, 4096, 64, 2, (16, 8, True)),
    (4, 8, 6, 512, 128, 2, (8, 4, True)),       # dbrx-132b decode, bf16
    (4, 8, 6, 512, 128, 4, (8, 4, True)),
    (6, 2, 8, 4096, 128, 2, (8, 11, True)),     # the card tests' three-call split shape
    (1, 2, 2, 4096, 64, 4, (8, 32, True)),      # the card tests' graph of the split path
    (3, 2, 2, 100, 64, 4, (8, 1, False)),       # 4 chunks: one block, no split
    (1, 1, 1, 4096, 16, 4, (8, 32, True)),
    (2, 4, 2, 300, 32, 4, (8, 2, True)),        # ragged S: 10 chunks, 2 blocks of 5
    (64, 8, 8, 4096, 128, 2, (10, 1, False)),   # B*Hkv fills the card: no split; 48 KB caps warps
    (66, 2, 8, 1024, 128, 2, (8, 1, False)),    # the card tests' unsplit 132: 4 chunks a warp
    (1, 1, 4, 2048, 64, 4, (8, 16, True)),
    (1, 1, 4, 2049, 64, 4, (8, 16, True)),      # one chunk more: 5 a block
    (1, 1, 1, 1, 16, 4, (8, 1, False)),
    (2, 1, 8, 0, 128, 2, (8, 1, False)),        # an empty cache
    (4, 2, 7, 512, 64, 2, (8, 4, True)),        # internvl2-1b decode (14 / 2 heads), bf16
    (4, 16, 1, 448, 64, 2, (8, 2, True)),       # whisper-medium decode (16 / 16 heads)
    (64, 8, 7, 4096, 128, 2, (12, 1, False)),   # group 7 at D = 128: 48 KB caps 12 warps
    (64, 8, 7, 4096, 64, 2, (16, 1, False)),    # and at D = 64, 16
])
def test_decode_plan(B, Hkv, G, S, D, elt, want):
    from repro_torch.kernels.decode_attention import (BLOCK_CHUNKS, MAX_WARPS, SMEM_MAX,
                                                      decode_plan)
    warps, blocks, split = got = decode_plan(B, Hkv, G, S, D, elt)
    assert got == want
    assert 1 <= warps <= MAX_WARPS <= 32
    assert 4 * (G * D + warps * G * (D + 2)) <= SMEM_MAX       # the block's partials
    assert split == (blocks > 1)
    assert not split or (blocks * B * Hkv <= 132 and -(-S // 32) >= blocks * BLOCK_CHUNKS)
    for length in sorted({0, 1, 31, 32, 33, S // 2, S - 1, S, S + 5}):
        seen = _decode_coverage(S, length, warps, blocks)
        live = min(max(length, 0), S)
        assert (seen[:live] == 1).all() and (seen[live:] == 0).all()


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("elt", [4, 2])
def test_decode_lane_layout_covers_each_v_element_once(D, elt):
    """P.V in csrc/decode_attention.cu: R = D/4 lanes share a V row, 4 head
    dims each (one 16-byte load in f32, one 8-byte load in bf16, aligned
    in a row of D*elt bytes); load i of a chunk gives lane l row
    i*(32/R) + l//R, piece l % R."""
    vn = 4
    R = D // vn
    assert 32 % R == 0 and vn * elt in (8, 16) and (D * elt) % (vn * elt) == 0
    seen = np.zeros((32, D), np.int64)
    for i in range(R):
        for lane in range(32):
            row, piece = i * (32 // R) + lane // R, lane % R
            seen[row, piece * vn:(piece + 1) * vn] += 1
    assert (seen == 1).all()


def _mirror_lookup(keys, queries, pin_keys, pin_pos, geometry):
    """csrc/path_lookup.cu's search, one query at a time in numpy: the
    pinned level, the staged top level and the 32-way fence steps (each
    probe lane by lane, the count of probes <= q as the ballot gives it),
    then the tile."""
    _, top_stride, n_top, _, _ = geometry
    n = len(keys)
    n_fences = -(-n // 128)
    fences = keys[::128]

    def step32(col, lo, hi, q):
        while hi > lo:
            step = (hi - lo + 31) >> 5
            k = sum(1 for lane in range(32)
                    if lo + lane * step < hi and col[lo + lane * step] <= q)
            lo, hi = (lo, lo) if k == 0 else (lo + (k - 1) * step + 1,
                                             min(hi, lo + k * step))
        return lo, hi

    out = []
    for q in queries:
        hit = np.flatnonzero(pin_keys == q)
        if hit.size:
            out.append(int(pin_pos[hit[0]]))
            continue
        if n == 0:
            out.append(-1)
            continue
        lo, hi = 0, n_fences
        if n_top:
            tl, _ = step32(fences[::top_stride][:n_top], 0, n_top, q)
            lo, hi = (0, 0) if tl == 0 else ((tl - 1) * top_stride + 1,
                                             min(tl * top_stride, n_fences))
        lo, _ = step32(fences, lo, hi, q)
        tile = min(max(lo - 1, 0), n_fences - 1)
        start = max(0, min(tile * 128, n - 128))
        found = np.flatnonzero(keys[start:start + 128] == q)
        out.append(int(start + found[0]) if found.size else -1)
    return np.array(out, np.int32)


@pytest.mark.parametrize("n_q,N,n_pin,want", [
    (4096, 1052800, 24, (512, 32, 258, 24, 2352)),   # the Q1 wave at 2^20 paths
    (1024, 1052800, 24, (128, 32, 258, 24, 2352)),   # Q2/Q3 waves
    (256, 1052800, 24, (32, 32, 258, 24, 2352)),     # Q4C
    (4096, 300_000, 24, (512, 32, 74, 24, 880)),
    (65536, 300_000, 24, (8192, 32, 74, 24, 880)),   # many waves of blocks
    (33, 4096, 8, (5, 32, 0, 8, 96)),                # 32 fences: no top level
    (33, 4097, 8, (5, 32, 2, 8, 112)),               # 33 fences: a top level of 2
    (1, 128, 0, (1, 32, 0, 0, 0)),
    (8, 0, 0, (1, 32, 0, 0, 0)),                     # an empty table
    (16, 1 << 27, 300, (2, 1024, 1024, 256, 11264)),  # 2^20 fences: stride 32^2
])
def test_path_lookup_geometry(n_q, N, n_pin, want):
    from repro_torch.kernels.path_lookup import PIN_MAX, TOP_MAX, WARPS, lookup_geometry
    blocks, top_stride, n_top, n_pin_staged, smem = got = lookup_geometry(n_q, N, n_pin)
    assert got == want
    assert (blocks - 1) * WARPS < n_q <= blocks * WARPS        # one query a warp
    n_fences = -(-N // 128)
    assert n_top <= TOP_MAX and (n_top == 0) == (n_fences <= 32)
    assert n_top == 0 or (n_top - 1) * top_stride < n_fences <= n_top * top_stride
    assert top_stride in (32, 32 ** 2, 32 ** 3)
    assert n_pin_staged == min(n_pin, PIN_MAX) and smem <= 48 * 1024


@pytest.mark.parametrize("N", [0, 50, 128, 4095, 4096, 4097, 131_073, 300_000])
@pytest.mark.parametrize("n_pin", [0, 8, 24, 300])
def test_path_lookup_kernel_search_matches_plain(N, n_pin):
    """The kernel's search, mirrored in numpy, against the plain version:
    hits in every tile, pinned hits (the staged and the unstaged part past
    PIN_MAX), misses below, between and above the keys, on the padded
    table (INT64_MAX sentinels) and the unpadded one."""
    from repro_torch.kernels.path_lookup import lookup_geometry
    rs = np.random.RandomState(N + n_pin)
    khi, klo = _key_table(rs, N) if N else (np.zeros(0, np.uint32),) * 2
    n = len(khi)
    real = key64(khi, klo)
    pin_rows = rs.choice(n, size=min(n_pin, n), replace=False).astype(np.int32)
    ph, pl, pp = pad_pinned(khi[pin_rows], klo[pin_rows], pin_rows)
    pin_keys, pin_pos = key64(ph, pl), pp
    qs = [real[rs.randint(0, n, size=200)] if n else np.zeros(0, np.int64),
          real[::128], real[127::128], real[pin_rows],
          np.array([np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max - 1], np.int64)]
    if n > 1:
        qs.append(real[:-1] // 2 + real[1:] // 2 + 1)    # between neighbours: misses
    queries = np.concatenate(qs)[:600]
    for keys in (key64(*pad_keys(khi, klo)), real):
        want = ref.path_lookup_pinned_ref(torch.from_numpy(keys), torch.from_numpy(queries),
                                          torch.from_numpy(pin_keys),
                                          torch.from_numpy(pin_pos)).numpy()
        geometry = lookup_geometry(len(queries), len(keys), len(pin_keys))
        got = _mirror_lookup(keys, queries, pin_keys, pin_pos, geometry)
        assert np.array_equal(got, want)
