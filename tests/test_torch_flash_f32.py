"""The float32 bodies of flash_attention and flash_attention_bwd on the CPU:
their numerical design and their launch geometry, which are the parts of
them that run without a card.

The bodies take every product on the tensor cores in 3xTF32 (csrc/tf32.cuh):
each operand x split into hi = tf32(x) (rounded to nearest, ties away, as
``cvt.rna.tf32.f32``) and lo = tf32(x - hi), a product taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation.  A numpy emulation
of that arithmetic, with the kernels' online softmax over key tiles in f32
and exp2, runs the forward and the backward at the router's training
shape, kimi-k2's ragged (m) shape, (k f32) and (a S=113), and is held to
the JAX package's ``attention_ref`` and its ``jax.vjp`` within F32_TOL (the
tolerance of tests/test_kernels.py).  The same emulation with one TF32
product a product (TF32 alone keeps ~3 decimal digits) misses it, so the
comparison can fail.

The geometry: ``key_split`` (the forward's key split), ``bwd_geometry``'s
head split of the f32 body and ``dq_split`` (the backward's dQ split),
pure functions of the shape and the SM count, as the kernels read them.  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

F32_TOL = dict(atol=3e-5, rtol=3e-5)
LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)

# (tag, B, Hq, Hkv, Sq, Skv, D, causal): the router's training shape, the
# smoke's (m f32), (k f32) and (a S=113) rows
SHAPES = [("router", 8, 4, 2, 128, 128, 64, True),
          ("m f32", 1, 8, 1, 300, 1037, 112, True),
          ("k f32", 1, 16, 16, 128, 64, 64, False),
          ("a S=113", 1, 4, 2, 113, 113, 64, True)]


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as a float32: cvt.rna.tf32.f32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def product(a, b, passes):
    """a @ b over the last two axes as the kernels take it: 3 tensor-core
    products (small terms first) of the TF32 halves, f32 accumulation; or
    with ``passes=1`` one product of the rounded operands."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return np.matmul(ah, bh)
    al, bl = tf32(a - ah), tf32(b - bh)
    d = np.matmul(al, bh)
    d = d + np.matmul(ah, bl)
    return d + np.matmul(ah, bh)


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(B, Hq, Sq, D), f(B, Hkv, Skv, D), f(B, Hkv, Skv, D), f(B, Hq, Sq, D)


def forward(q, k, v, causal, passes, bk):
    """The forward body's arithmetic: key tiles of ``bk``, scores times
    scale * log2 e, the finite mask, a running (m, l, acc) in f32 with exp2,
    out = acc / l and lse = (m + log2 l) ln 2."""
    B, Hq, Sq, D = q.shape
    G, Skv = Hq // k.shape[1], k.shape[2]
    kf, vf = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    scale_log2 = np.float32(1.0 / np.sqrt(D)) * LOG2E
    pos = np.arange(Sq) + (Skv - Sq)
    m = np.full((B, Hq, Sq), NEG, np.float32)
    l = np.zeros((B, Hq, Sq), np.float32)
    acc = np.zeros((B, Hq, Sq, D), np.float32)
    for k0 in range(0, Skv, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        x = product(q, kt.swapaxes(-1, -2), passes) * scale_log2
        keys = np.arange(k0, k0 + kt.shape[2])
        ok = keys[None, :] <= pos[:, None] if causal else np.ones((Sq, len(keys)), bool)
        x = np.where(ok, x, NEG)
        m_new = np.maximum(m, x.max(-1))
        alpha = np.exp2(m - m_new)
        p = np.where(ok, np.exp2(x - m_new[..., None]), np.float32(0)).astype(np.float32)
        l = l * alpha + p.sum(-1, dtype=np.float32)
        acc = acc * alpha[..., None] + product(p, vt, passes)
        m = m_new
    out = acc / np.where(l == 0, np.float32(1), l)[..., None]
    return out.astype(np.float32), ((m + np.log2(l)) * np.float32(np.log(2))).astype(np.float32)


def backward(q, k, v, o, lse, do, causal, passes):
    """The backward body's arithmetic: delta = rowsum(dO O), P = exp2(s
    scale log2 e - lse log2 e) (masked 0), dS = P (dO V^T - delta), dV =
    P^T dO, dK = scale dS^T Q, dQ = scale dS K, the group's heads summed
    into their KV head in f32."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kf, vf = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    scale = np.float32(1.0 / np.sqrt(D))
    delta = (do * o).sum(-1, dtype=np.float32)
    s = product(q, kf.swapaxes(-1, -2), passes)
    p = np.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None]).astype(np.float32)
    if causal:
        ok = np.arange(Skv)[None, :] <= (np.arange(Sq) + (Skv - Sq))[:, None]
        p = np.where(ok, p, np.float32(0))
    ds = p * (product(do, vf.swapaxes(-1, -2), passes) - delta[..., None])
    dq = product(ds, kf, passes) * scale
    dk = (product(ds.swapaxes(-1, -2), q, passes) * scale).reshape(B, Hkv, G, Skv, D).sum(2)
    dv = product(p.swapaxes(-1, -2), do, passes).reshape(B, Hkv, G, Skv, D).sum(2)
    return dq, dk.astype(np.float32), dv.astype(np.float32)


def _jax_reference(q, k, v, do, causal):
    """The JAX package's attention_ref, its rows' log-sum-exp, and jax.vjp's
    gradients."""
    out, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    G, D = q.shape[1] // k.shape[1], q.shape[-1]
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), G, axis=1)) / np.sqrt(D)
    if causal:
        Sq, Skv = q.shape[2], k.shape[2]
        s = jnp.where(jnp.arange(Skv)[None] <= (jnp.arange(Sq) + Skv - Sq)[:, None], s, -1e30)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _within(got, want) -> bool:
    return bool(np.all(np.abs(got - want) <= F32_TOL["atol"] + F32_TOL["rtol"] * np.abs(want)))


@pytest.mark.parametrize("tag,B,Hq,Hkv,Sq,Skv,D,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_three_tf32_products_hold_the_f32_tolerance(tag, B, Hq, Hkv, Sq, Skv, D, causal):
    """3xTF32 forward (out and lse) and backward (dq, dk, dv) within
    F32_TOL of the JAX package; one TF32 product a product misses it."""
    q, k, v, do = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv + D)
    want_o, want_lse, want_g = _jax_reference(q, k, v, do, causal)
    bk = fa.f32_key_tile(D)
    out, lse = forward(q, k, v, causal, 3, bk)
    np.testing.assert_allclose(out, want_o, **F32_TOL)
    np.testing.assert_allclose(lse, want_lse, **F32_TOL)
    grads = backward(q, k, v, out, lse, do, causal, 3)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_g):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)
    # one TF32 product: the output and every gradient miss the tolerance
    out1, lse1 = forward(q, k, v, causal, 1, bk)
    assert not _within(out1, want_o)
    grads1 = backward(q, k, v, out1, lse1, do, causal, 1)
    assert not any(_within(g, w) for g, w in zip(grads1, want_g))


def test_tf32_rounding():
    """tf32() keeps 10 mantissa bits, rounding to nearest with ties away
    from zero, and x - tf32(x) is exact, so hi + lo carries x to ~2^-22."""
    x = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11, -(1 + 2.0 ** -11),
                  1 + 2.0 ** -12, 3.14159265], np.float32)
    want = np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9, -(1 + 2.0 ** -10), 1.0,
                     3.140625], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    assert not (tf32(x).view(np.uint32) & np.uint32(0x1FFF)).any()
    r = np.random.RandomState(0).standard_normal(10000).astype(np.float32)
    hi = tf32(r)
    lo = tf32(r - hi)
    assert np.abs((r.astype(np.float64) - hi - lo) / r).max() < 2.0 ** -21
    assert np.abs((r.astype(np.float64) - hi) / r).max() > 2.0 ** -12


# ---------------------------------------------------------------------------
# the geometry: the forward's key split, the backward's f32 head and dQ splits
# ---------------------------------------------------------------------------
def _fwd_parts(B, Hq, Sq, Skv, D, causal, split):
    """The key tiles [lo, hi) each block of a forward launch walks, as
    csrc/flash_attention.cu decodes them: per query tile, parts =
    min(split, its tiles), part p from p n / parts."""
    bk, off = fa.f32_key_tile(D), Skv - Sq
    out = []
    for q0 in range(0, Sq, fa.BLOCK_Q):
        k_end = min(Skv, min(Sq, q0 + fa.BLOCK_Q) + off) if causal else Skv
        n = -(-k_end // bk)
        parts = max(1, min(split, n))
        out.append([(p * n // parts, (p + 1) * n // parts) for p in range(parts)])
    return out


@pytest.mark.parametrize("shape,n_sm,want", [
    ((1, 8, 300, 1037, 112, True), 132, 4),     # (m f32): 40 blocks, tiles of 32 keys
    ((1, 8, 300, 1037, 112, True), 40, 1),      # the grid fills 40 SMs
    ((1, 8, 300, 1037, 112, True), 41, 2),      # one SM more: the split switches on
    ((1, 8, 300, 1037, 112, True), 10 ** 4, 17),  # parts of two tiles at most
    ((8, 4, 128, 128, 64, True), 132, 1),       # the router's training forward: 1-2 tiles a block
    ((1, 16, 128, 64, 64, False), 132, 1),      # (k f32): one key tile
    ((1, 4, 113, 113, 64, True), 132, 1),       # (a S=113)
    ((1, 4, 7, 7, 64, True), 132, 1),           # (a S=7)
    ((1, 2, 64, 4096, 128, True), 132, 64),     # a chunk over a long context: parts of 2
    ((1, 2, 64, 4096, 128, False), 132, 64),
    ((16, 16, 4096, 4096, 64, True), 132, 1),   # a grid of many waves
])
def test_f32_forward_key_split(shape, n_sm, want):
    """The least c whose longest part is within one SM's share of the key
    tiles (or MIN_PART_TILES), 1 where the grid fills the card; the parts
    of every query tile cover its visible key tiles once."""
    B, Hq, Sq, Skv, D, causal = shape
    c = fa.key_split(B, Hq, Sq, Skv, D, causal, n_sm)
    assert c == want
    tiles = _fwd_parts(B, Hq, Sq, Skv, D, causal, c)
    n_t = [hi for *_, (_, hi) in tiles]
    longest = max(hi - lo for parts in tiles for lo, hi in parts)
    share = B * Hq * sum(n_t) / n_sm
    for parts in tiles:
        assert [lo for lo, _ in parts][0] == 0
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        assert all(hi > lo for lo, hi in parts)
    if c > 1:
        assert B * Hq * -(-Sq // fa.BLOCK_Q) < n_sm
        assert longest <= max(share, fa.MIN_PART_TILES)
        assert -(-max(n_t) // (c - 1)) > max(share, fa.MIN_PART_TILES)
        assert fa.fwd_workspace_floats(B, Hq, Sq, D, c) == \
            B * Hq * -(-Sq // 64) * c * (D // 8 + 1) * 512
    else:
        assert fa.fwd_workspace_floats(B, Hq, Sq, D, c) == 0


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_f32_backward_body(D):
    """The float32 backward takes S and dP on wgmma where the hi and lo
    halves of its resident and streamed tiles fit an SM's shared memory
    (227 KB: up to head_dim 64; tf32.cuh's tiles pad 112 to 128 columns)."""
    columns = D if D < 32 else -(-D // 32) * 32   # tf32.cuh Atoms<D>::DP
    tile = 64 * columns * 4
    smem = 2 * tile + 2 * 2 * tile + 2 * 2 * 64 * 4 + 1024 + 4 * tile
    assert fa.f32_bwd_wgmma(D) is (smem <= 227 * 1024)
    assert fa.f32_bwd_wgmma(D) is (D <= 64)


@pytest.mark.parametrize("Sq", [1, 37, 300])
def test_f32_forward_key_split_without_keys(Sq):
    """A non-causal call with queries and no keys has no key tile to cut:
    the split is 1 (the wrapper returns zeros before any launch)."""
    assert fa.key_split(1, 4, Sq, 0, 64, False, 132) == 1
    assert fa.key_split(1, 4, Sq, 0, 112, False, 10 ** 4) == 1


def test_f32_forward_key_split_within_a_slot_of_tickets():
    """A split forward draws one ticket a (sequence, query head, query
    tile) from its stream's slot: a grid of more never splits."""
    n = fa.TICKETS_A_SLOT
    assert fa.key_split(1, n, 64, 4096, 64, True, 10 ** 6) > 1
    assert fa.key_split(1, n + 1, 64, 4096, 64, True, 10 ** 6) == 1


@pytest.mark.parametrize("shape,n_sm,want", [
    ((1, 8, 1, 300, 1037, True), 132, 8),       # (m): 136 key-tile blocks of one head
    ((8, 4, 2, 128, 128, True), 132, 2),        # the router's training: 64 where 32 ran
    ((8, 4, 2, 128, 128, True), 84, 2),
    ((8, 4, 2, 128, 128, True), 43, 2),
    ((8, 4, 2, 128, 128, True), 42, 1),         # one SM fewer: the split switches off
    ((1, 16, 16, 200, 77, False), 132, 1),      # (ragged Sq > Skv): group 1
    ((1, 16, 16, 128, 64, False), 132, 1),      # (k f32)
    ((1, 4, 2, 113, 113, True), 132, 2),        # (a S=113)
])
def test_f32_backward_head_split(shape, n_sm, want):
    """The f32 body's head split is the bf16 body's rule at 64-row tiles:
    at these shapes it equals the bf16 geometry's split, and the f32
    geometry keeps 64 rows on the eight-warp body."""
    B, Hq, Hkv, Sq, Skv, causal = shape
    geo = fa.bwd_geometry(B, Hq, Hkv, Sq, Skv, False, n_sm, causal)
    assert geo.head_split == want
    assert geo.warpgroups == 0 and geo.rows == fa.BWD_ROWS
    assert geo.key_blocks == B * Hkv * -(-Skv // 64) * want
    assert geo.query_blocks == B * Hq * -(-Sq // 64)
    assert geo.key_block_tiles == -(-(Hq // Hkv) // want) * -(-Sq // 64)
    bf = fa.bwd_geometry(B, Hq, Hkv, Sq, Skv, True, n_sm, causal)
    if bf.warpgroups == 1:
        assert bf.head_split == want


def test_f32_backward_workspace_holds_the_split_partials():
    """With a head split the f32 call's scratch holds lse2 and delta and a
    128-thread block of (dK, dV) partials for every key-tile block: the
    kernel's D floats a thread (D / 8 float4s of each) fit in the room of
    the tile's columns."""
    for D in fa.HEAD_DIMS:
        geo = fa.bwd_geometry(8, 4, 2, 128, 128, False, 132, True)
        assert geo.head_split == 2
        rows = 2 * 8 * 4 * 128
        floats = fa.bwd_workspace_floats(8, 4, 128, D, geo)
        assert floats - rows >= geo.key_blocks * 128 * D


@pytest.mark.parametrize("shape,n_sm,want", [
    ((1, 8, 1, 300, 1037, True), 132, 3),       # (m): 120 query-tile blocks of 5-6 key tiles
    ((1, 8, 1, 300, 1037, True), 82, 1),        # one SM fewer than the switch: unsplit
    ((1, 8, 1, 300, 1037, True), 83, 2),        # head split 4: key-tile blocks of 10 tiles
    ((1, 8, 1, 300, 1037, True), 105, 2),
    ((1, 8, 1, 300, 1037, True), 106, 3),       # head split 8
    ((8, 4, 2, 128, 128, True), 132, 1),        # the router's training
    ((1, 16, 16, 200, 77, False), 132, 1),      # (ragged Sq > Skv)
    ((1, 16, 16, 128, 64, False), 132, 1),      # (k f32)
    ((1, 4, 2, 113, 113, True), 132, 1),        # (a S=113)
    ((1, 4, 2, 63, 1037, True), 132, 9),        # a chunk over a long context: parts of 2
])
def test_f32_backward_dq_split(shape, n_sm, want):
    """The f32 body's dQ split d: 1 where the longest query-tile block, 3
    products a key tile over its n key tiles, costs no more than one SM's
    share of the grid; else the least d for which ceil(n / d) of them cost
    no more than the longest key-tile block (4 products a query tile) or
    MIN_PART_TILES tiles; the parts of every query tile, as the kernel
    decodes them, cover its visible key tiles once."""
    B, Hq, Hkv, Sq, Skv, causal = shape
    d = fa.dq_split(B, Hq, Hkv, Sq, Skv, n_sm, causal)
    assert d == want
    geo = fa.bwd_geometry(B, Hq, Hkv, Sq, Skv, False, n_sm, causal)
    n = geo.query_block_tiles
    off = Skv - Sq
    G, n_qt = Hq // Hkv, -(-Sq // fa.BWD_ROWS)
    key_cost = 4 * G * sum(n_qt - (max(0, k0 - off) // 64 if causal else 0)
                           for k0 in range(0, Skv, 64))
    query_tiles = [-(-(min(Skv, min(Sq, q0 + 64) + off) if causal else Skv) // 64)
                   for q0 in range(0, Sq, 64)]
    share = (B * Hkv * key_cost + B * Hq * 3 * sum(query_tiles)) / n_sm
    limit = max(4 * geo.key_block_tiles, 3 * fa.MIN_PART_TILES)
    assert max(query_tiles) == n
    if 3 * n <= share:
        assert d == 1
    else:
        assert 3 * -(-n // d) <= limit
    if d > 1:
        assert 3 * n > share and 3 * -(-n // (d - 1)) > limit
    for n_t in query_tiles:
        parts = max(1, min(d, n_t))
        cuts = [(p * n_t // parts, (p + 1) * n_t // parts) for p in range(parts)]
        assert cuts[0][0] == 0 and cuts[-1][1] == n_t
        assert all(a[1] == b[0] and b[1] > b[0] for a, b in zip(cuts, cuts[1:]))


def test_f32_backward_dq_split_within_a_slot_of_tickets():
    """A split backward draws two tickets a (sequence, KV head, key tile)
    and one a (sequence, query head, query tile) from its stream's slot:
    where they would not fit, the dQ split stays 1."""
    assert fa.dq_split(1, 2, 1, 64, 4096, 132, True) == 32
    # 2 * 512 key-tile tickets alone fill the slot
    assert fa.dq_split(1, 2, 1, 64, 512 * 64, 132, True) == 1


@pytest.mark.parametrize("d", [1, 2, 17])
def test_f32_backward_workspace_holds_the_dq_partials(d):
    """With a dQ split of d parts the scratch adds every part's 64 x D
    floats for each (sequence, query head, query tile)."""
    for D in fa.HEAD_DIMS:
        geo = fa.bwd_geometry(1, 8, 1, 300, 1037, False, 132, True)
        base = fa.bwd_workspace_floats(1, 8, 300, D, geo)
        assert fa.bwd_workspace_floats(1, 8, 300, D, geo, d) - base == \
            (0 if d == 1 else 8 * 5 * d * 64 * D)


def test_f32_backward_head_split_within_a_slot_of_tickets():
    """The f32 body draws two tickets a (sequence, KV head, key tile) pair,
    one for dV and one for dK: half the pairs of the bf16 body fit a
    stream's slot."""
    n = fa.TICKETS_A_SLOT
    fits = fa.bwd_geometry(1, 16, 2, 64, n // 4 * 64, False, 10 ** 6)
    assert fits.head_split == 8
    assert fa.bwd_geometry(1, 16, 2, 64, (n // 4 + 1) * 64, False, 10 ** 6).head_split == 1
    assert fa.bwd_geometry(1, 16, 2, 64, (n // 4 + 1) * 64, True, 10 ** 6).head_split == 8
