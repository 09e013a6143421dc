"""On the card only: each of the port's CUDA kernels against its
plain PyTorch version, at small shapes and at the main path's (the
backward kernels of the training path too, and the router's and a
reduced dbrx's train step against the CPU's), reduced jamba and xlstm
through the ServingEngine against the CPU and batched against alone,
and the
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


def train_launches(cfg) -> dict:
    """Launches of each kernel in one train step (``ops.LAUNCHES``'s names),
    counted from the config: every attention call (an encoder block's, a
    decoder block's causal self-attention and its cross-attention), every
    norm (two a block with an FFN, one an xLSTM block, two more for a
    qk-norm, an enc-dec decoder block's ``norm_x``, the final norm once for
    each stack) and every MoE layer, forward and backward alike; a dense
    prefix layer (kimi-k2's) is an attention block with an FFN."""
    from repro_torch.models import transformer as T
    kinds = ["attn"] * cfg.n_dense_prefix + list(cfg.block_pattern) * cfg.n_periods
    n_attn = kinds.count("attn") * (2 if cfg.is_encdec else 1) + cfg.n_enc_layers
    n_norm = (sum(2 if k in ("attn", "mamba") else 1 for k in kinds) + 1
              + 2 * cfg.qk_norm * kinds.count("attn")
              + (cfg.n_layers + 2 * cfg.n_enc_layers + 1 if cfg.is_encdec else 0))
    n_moe = cfg.n_periods * sum(T._slot_is_moe(cfg, s) for s in range(len(cfg.block_pattern)))
    return {"flash_attention": n_attn, "flash_attention_bwd": n_attn, "rmsnorm": n_norm,
            "rmsnorm_bwd": n_norm, "moe_router": n_moe, "moe_router_bwd": n_moe}


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


#: the head_dim layout's slices at the zoo's decode shapes: (B, Hq, Hkv,
#: S, D, ranks): qwen3 at 2 and 16 ranks, dbrx's group 6, kimi-k2's Dl of
#: 7, internvl2's Dl of 4 (group 7), the dry run's decode_32k slice of
#: qwen3 (B = 8 a "data" rank of 16x16) and the router (f32 only)
SPLIT_SHAPES = [(4, 16, 8, 4096, 128, 2), (4, 16, 8, 4096, 128, 16), (4, 48, 8, 4096, 128, 16),
                (4, 64, 8, 4096, 112, 16), (4, 14, 2, 4096, 64, 16), (8, 16, 8, 32768, 128, 16),
                (4, 4, 2, 512, 64, 2)]


def split_decode(q, k, v, lens, ranks: int):
    """decode_scores on each rank's head_dim slice, the slices' scores
    summed (the all-reduce), decode_combine on each slice, the outputs'
    columns joined: (output, per-slice scores, summed scores)."""
    D = q.shape[-1]
    cols = [slice(r * D // ranks, (r + 1) * D // ranks) for r in range(ranks)]
    parts = [ops.decode_scores(q[..., c].contiguous(), k[..., c].contiguous(), lens,
                               sm_scale=D ** -0.5) for c in cols]
    s = torch.stack(parts).sum(0)
    return (torch.cat([ops.decode_combine(s, v[..., c].contiguous(), lens) for c in cols], -1),
            parts, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [(dt, sh) for sh in SPLIT_SHAPES for dt in DTYPES
                                         if sh != SPLIT_SHAPES[-1] or dt == "float32"],
                         ids=lambda t: "x".join(map(str, t)) if isinstance(t, tuple) else t)
def test_cuda_decode_split_matches_plain(cuda, dtype, shape):
    """Each slice's decode_scores and decode_combine against their plain
    versions on the same inputs (one launch a call), and the joined output
    against the fused decode_attention kernel and its plain version;
    lengths 0 (zeros), 1, a full cache and between (the router in f32, as
    it decodes)."""
    B, Hq, Hkv, S, D, ranks = shape
    dt = getattr(torch, dtype)
    lens = ([0, 1, S, S // 2 + 77] * 2)[:B]
    q, k, v, ln = _decode_inputs(cuda, dt, B, Hq, Hkv, S, D, lens)
    n0 = dict(ops.LAUNCHES)
    got, parts, s = split_decode(q, k, v, ln, ranks)
    assert ops.LAUNCHES["decode_scores"] == n0["decode_scores"] + ranks
    assert ops.LAUNCHES["decode_combine"] == n0["decode_combine"] + ranks
    Dl = D // ranks
    for r, part in enumerate(parts):
        c = slice(r * Dl, (r + 1) * Dl)
        want = ref.decode_scores_ref(q[..., c], k[..., c], ln, sm_scale=D ** -0.5)
        torch.testing.assert_close(part, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ops.decode_combine(s, v[..., c].contiguous(), ln).float(),
                                   ref.decode_combine_ref(s, v[..., c], ln).float(), **_tol(dtype))
    assert all(torch.all(got[b] == 0) for b, n in enumerate(lens) if n == 0)
    torch.testing.assert_close(got.float(), ops.decode_attention(q, k, v, ln).float(),
                               **_tol(dtype))
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, k, v, ln).float(),
                               **_tol(dtype))


@pytest.mark.cuda
def test_cuda_decode_split_one_kernel_node_per_call(cuda):
    """decode_scores and decode_combine captured in a CUDA graph: one
    kernel node a call and no other node, decode_combine on both plans
    (split over blocks at B*Hkv = 8, one block at 528 x 2 over 512
    positions, after a warm-up call has made the workspace); the replay
    matches the plain versions."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_split import combine_plan, combine_span_min
    plans = set()
    for B, Hkv, S, lens in ((4, 2, 4096, [1, 100, 4096, 2000]), (528, 2, 512, [512, 3] * 264)):
        q, k, v, ln = _decode_inputs(cuda, torch.bfloat16, B, 6 * Hkv, Hkv, S, 8, lens)
        plans.add(combine_plan(B, Hkv, S, combine_span_min(6, 8, 2), build.sm_count(0)) > 1)
        s = ops.decode_scores(q, k, ln, sm_scale=0.1)
        ops.decode_combine(s, v, ln)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            s = ops.decode_scores(q, k, ln, sm_scale=0.1)
            outs = [ops.decode_combine(s, v, ln) for _ in range(2)]
        assert build.graph_nodes(g) == (3, 3)
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(s, ref.decode_scores_ref(q, k, ln, sm_scale=0.1),
                                   atol=1e-4, rtol=1e-4)
        for got in outs:
            torch.testing.assert_close(got.float(), ref.decode_combine_ref(s, v, ln).float(),
                                       **_tol("bfloat16"))
    assert plans == {False, True}


#: lengths at the redesigned kernels' edges: empty, 1, around 8 (a 16-byte
#: run of bf16 rows at Dl 8), a combine chunk (32) and a combine chunk of
#: whole rows (128), decode_scores' tiles (64, 256, 1024); with each case's
#: combine span (``combine_span_min``) and the whole cache added
EDGE_LENGTHS = [0, 1, 7, 8, 9, 31, 33, 63, 65, 127, 129, 255, 257, 1023, 1025]


def _combine_on(monkeypatch, nblk, s, v, ln):
    """decode_combine on a plan of ``nblk`` blocks a (sequence, KV head)."""
    from repro_torch.kernels import decode_split as dsp
    monkeypatch.setattr(dsp, "combine_plan", lambda *a, **kw: nblk)
    try:
        return ops.decode_combine(s, v, ln)
    finally:
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 6, 7, 9, 12, 16])
@pytest.mark.parametrize("Dl", [4, 7, 8, 64, 100, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_split_edges(cuda, monkeypatch, dtype, Dl, G):
    """decode_scores and decode_combine at Dl 4 and 7 (rows through the
    shared ring), 8, 64 and 128 (whole 16-byte pieces in registers: a row a
    piece or several, decode_combine's lanes taking whole rows at a group
    of 1) and 100 (a wide row through the ring), groups 1, 6, 7, 9, 12 and
    16 (9 and 12: a group that is no bound of its own, below the 16 the
    instance holds), over
    EDGE_LENGTHS and one less, one more than a combine span and than two
    (the last block holding one position): each against its plain
    version, and two calls equal bit for bit; decode_combine on one block,
    on its own plan (split) and on MAX_BLOCKS blocks (more blocks than
    live spans)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_split import (MAX_BLOCKS, combine_plan, combine_span_min,
                                                  combine_spans)
    dt = getattr(torch, dtype)
    span = combine_span_min(G, Dl, dt.itemsize)
    S = 3 * span + 64
    lens = EDGE_LENGTHS + [span - 1, span, span + 1, 2 * span + 1, S - 1, S]
    B, Hkv = len(lens), 2
    q, k, v, ln = _decode_inputs(cuda, dt, B, G * Hkv, Hkv, S, Dl, lens)
    s = ops.decode_scores(q, k, ln, sm_scale=Dl ** -0.5)
    torch.testing.assert_close(s, ref.decode_scores_ref(q, k, ln, sm_scale=Dl ** -0.5),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(s, ops.decode_scores(q, k, ln, sm_scale=Dl ** -0.5))
    plan = combine_plan(B, Hkv, S, span, build.sm_count(0))
    spans = [combine_spans(n, plan, span) for n in lens]
    assert plan > 1 and any(len(sp) > 1 and sp[-1][1] - sp[-1][0] == 1 for sp in spans)
    want = ref.decode_combine_ref(s, v, ln).float()
    for nblk in (1, plan, MAX_BLOCKS):
        got = _combine_on(monkeypatch, nblk, s, v, ln)
        torch.testing.assert_close(got.float(), want, **_tol(dtype))
        assert torch.all(got[0] == 0)
        assert torch.equal(got, _combine_on(monkeypatch, nblk, s, v, ln))


@pytest.mark.cuda
@pytest.mark.parametrize("Dl", [7, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_split_unaligned_operands(cuda, monkeypatch, dtype, Dl):
    """Operands that start off a 16-byte boundary (views at an element's
    offset) over an odd S = 4001: decode_scores reads K through the ring
    and writes its scores one by one, decode_combine copies the granules
    around each run; both match their plain versions on one block and
    split over 8 and MAX_BLOCKS."""
    from repro_torch.kernels.decode_split import MAX_BLOCKS
    dt = getattr(torch, dtype)
    B, G, Hkv, S = 4, 6, 2, 4001
    lens = [4001, 1, 3000, 33]

    def shifted(*shape):
        flat = torch.randn(int(np.prod(shape)) + 1, dtype=dt, device=cuda)
        t = flat[1:].view(*shape)
        assert t.data_ptr() % 16 and t.is_contiguous()
        return t
    q, k, v = shifted(B, G * Hkv, Dl), shifted(B, Hkv, S, Dl), shifted(B, Hkv, S, Dl)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    s = ops.decode_scores(q, k, ln, sm_scale=0.3)
    torch.testing.assert_close(s, ref.decode_scores_ref(q, k, ln, sm_scale=0.3),
                               atol=1e-4, rtol=1e-4)
    s_off = torch.empty(s.numel() + 1, dtype=torch.float32, device=cuda)[1:].view(s.shape)
    s_off.copy_(s)
    want = ref.decode_combine_ref(s, v, ln).float()
    for nblk in (1, 8, MAX_BLOCKS):
        torch.testing.assert_close(_combine_on(monkeypatch, nblk, s_off, v, ln).float(), want,
                                   **_tol(dtype))


@pytest.mark.cuda
def test_cuda_decode_split_refuses_what_it_lacks(cuda):
    """Under grad, a float16 cache, a group of 32, a slice of 129 columns
    and tensors on the CPU each raise before any launch."""
    q, k, v, ln = _decode_inputs(cuda, torch.float32, 2, 4, 2, 64, 8, [3, 64])
    n0 = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.decode_scores(q.clone().requires_grad_(True), k, ln, sm_scale=1.0)
    with pytest.raises(ValueError, match="unsupported"):
        ops.decode_scores(q.half(), k.half(), ln, sm_scale=1.0)
    with pytest.raises(ValueError, match="unsupported"):
        ops.decode_scores(torch.randn(2, 64, 8, device=cuda), k, ln, sm_scale=1.0)
    with pytest.raises(ValueError, match="unsupported"):
        ops.decode_combine(torch.zeros(2, 4, 64, device=cuda),
                           torch.randn(2, 2, 64, 129, device=cuda), ln)
    from repro_torch.kernels.decode_split import decode_scores
    with pytest.raises(ValueError, match="CUDA"):
        decode_scores(q.cpu(), k.cpu(), ln.cpu(), sm_scale=1.0)
    assert dict(ops.LAUNCHES) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_decode_attention_split_calls_of_more_pairs_after_fewer(cuda, dtype):
    """Split calls over 2, 64, 8 and 64 (sequence, KV head) pairs in a row
    on one workspace: each matches the plain version.  A call's partials
    must not land on the tickets of a later call with more pairs (whisper
    decodes 64 pairs after the router's 8: when tickets and partials
    shared one buffer, the second call read stale partials as tickets)."""
    from repro_torch.kernels.decode_attention import decode_plan
    dt = getattr(torch, dtype)
    for B, Hq, Hkv, S, D, lens in ((1, 4, 2, 4096, 64, [4000]),
                                   (4, 16, 16, 448, 64, [1, 90, 225, 433]),
                                   (4, 4, 2, 512, 64, [1, 97, 311, 512]),
                                   (4, 16, 16, 448, 64, [448, 2, 100, 300])):
        assert decode_plan(B, Hkv, Hq // Hkv, S, D, dt.itemsize)[2]
        q, k, v, ln = _decode_inputs(cuda, dt, B, Hq, Hkv, S, D, lens)
        torch.testing.assert_close(ops.decode_attention(q, k, v, ln).float(),
                                   ref.decode_attention_ref(q, k, v, ln).float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
def test_cuda_decode_attention_group_7_in_a_captured_graph(cuda, dtype, D):
    """internvl2's group of 7 (14 query heads over 2 KV heads) at every
    head_dim, on both launch plans (split at its decode shape, B = 4 over
    512 positions; one block per (sequence, KV head) at 66 x 2): three
    calls captured in a CUDA graph are three kernel nodes and no other,
    and the replay matches the plain version."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_plan
    dt = getattr(torch, dtype)
    plans = set()
    for B, S, lens in ((4, 512, [1, 103, 257, 497]), (66, 256, [256, 100, 1] * 22)):
        plans.add(decode_plan(B, 2, 7, S, D, dt.itemsize)[2])
        q, k, v, ln = _decode_inputs(cuda, dt, B, 14, 2, S, D, lens)
        ops.decode_attention(q, k, v, ln)              # makes the split path's workspace
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
        want = ref.decode_attention_ref(q, k, v, ln).float()
        for got in outs:
            torch.testing.assert_close(got.float(), want, **_tol(dtype))
    assert plans == {False, True}


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
             (1, 132, 66, 127, 127, 16, True),
             # the 192-query tile at head_dim 64 and below: ragged in every head
             (2, 66, 6, 257, 300, 16, True), (1, 132, 12, 191, 191, 32, False),
             (1, 140, 14, 385, 385, 64, True)]
    tiles = set()
    for B, Hq, Hkv, Sq, Skv, D, causal in cases:
        tiles.add(query_tile(B, Hq, Sq, D=D))
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
    assert tiles == {64, 128, 192}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_attention_kernels_at_head_dim_112(cuda, dtype):
    """kimi-k2's head_dim of 112 (64 query heads over 8 KV heads), which
    the bf16 bodies run in tiles padded to 128 columns: flash_attention
    and its backward at a causal ragged shape, a non-causal one and
    group 8 at 1000 x 1000 (two consumer warpgroups, several ring
    stages); decode_attention at group 8 on both launch plans.  Each
    equals its plain version, one launch a call, and the backward gives
    the same bits on a second call."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.decode_attention import decode_plan
    dt = getattr(torch, dtype)
    D = 112
    for B, Hq, Hkv, Sq, Skv, causal in ((1, 16, 2, 1000, 1000, True), (2, 8, 1, 77, 200, True),
                                        (1, 8, 8, 130, 257, False), (1, 64, 8, 128, 128, True)):
        q = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        k = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        v = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        do = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        n0 = ops.LAUNCHES["flash_attention"]
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        assert ops.LAUNCHES["flash_attention"] == n0 + 1
        want_o, want_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
        torch.testing.assert_close(o.float(), want_o.float(), **_tol(dtype))
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        n0 = ops.LAUNCHES["flash_attention_bwd"]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            torch.testing.assert_close(a.float(), w.float(), **_bwd_tol(dtype))
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    plans = set()
    for B, S, lens in ((4, 4096, [4096, 1, 2000, 33]), (20, 300, [300, 0, 31, 32, 33] * 4)):
        plans.add(decode_plan(B, 8, 8, S, D, dt.itemsize)[2])
        q, k, v, ln = _decode_inputs(cuda, dt, B, 64, 8, S, D, lens)
        n0 = ops.LAUNCHES["decode_attention"]
        got = ops.decode_attention(q, k, v, ln)
        assert ops.LAUNCHES["decode_attention"] == n0 + 1
        torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, k, v, ln).float(),
                                   **_tol(dtype))
    assert plans == {False, True}


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 2, 8, 48, device=cuda)            # head_dim 48
    with pytest.raises(ValueError):
        ops.attention(q, q[:, :1], q[:, :1])
    q = torch.randn(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.attention(q, q, q)
    q = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError):                      # Sq > Skv, causal
        ops.attention(q, q[:, :, :4], q[:, :, :4])
    q = q.to(torch.bfloat16)                             # the bf16 body's max: a positive scale
    for scale in (0.0, -0.125):
        with pytest.raises(ValueError, match="positive sm_scale"):
            ops.attention(q, q, q, sm_scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
def test_cuda_flash_attention_more_queries_than_keys_and_cross_decode(cuda, dtype, D):
    """Non-causal attention with more queries than keys (whisper's decoder
    longer than its frames), and one query over 1500 keys (a decode
    step's cross-attention), with q, k and v the strided views that
    ``layers.cross_attn_apply`` makes, at every head_dim in both bodies:
    one launch a call, equal to the plain version."""
    dt = getattr(torch, dtype)
    for B, Hq, Hkv, Sq, Skv in ((1, 16, 16, 128, 64), (2, 4, 2, 300, 129), (1, 14, 2, 257, 1),
                                (2, 16, 16, 1, 1500), (4, 4, 4, 448, 1500)):
        x = torch.randn(B, Sq, Hq * D, dtype=dt, device=cuda)
        e = torch.randn(B, Skv, 2 * Hkv * D, dtype=dt, device=cuda)
        q = x.reshape(B, Sq, Hq, D).transpose(1, 2)
        k = e[..., :Hkv * D].reshape(B, Skv, Hkv, D).transpose(1, 2)
        v = e[..., Hkv * D:].reshape(B, Skv, Hkv, D).transpose(1, 2)
        n0 = ops.LAUNCHES["flash_attention"]
        got = ops.attention(q, k, v, causal=False)
        assert ops.LAUNCHES["flash_attention"] == n0 + 1
        torch.cuda.synchronize()
        want = ref.attention_ref(q, k, v, causal=False)
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cuda_recurrent_forward_and_serve_match_cpu(cuda, arch):
    """Reduced jamba (mamba, attention and MoE slots) and xlstm (mLSTM and
    sLSTM) in f32: the forward, the loss, 8 serve steps and the decode
    state after them on the card against the same weights on the CPU,
    with the launches of each
    kernel the path runs counted exactly.  jamba within 3e-5; xlstm within
    1e-3, the tolerance tests/test_torch_recurrent.py holds it to against
    JAX, because its 16 layers amplify rounding."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    cfg = get_config(arch).reduced()
    tol = dict(atol=3e-5, rtol=3e-5) if arch.startswith("jamba") else dict(atol=1e-3, rtol=1e-3)
    kinds = list(cfg.block_pattern) * cfg.n_periods
    n_attn = kinds.count("attn")
    n_moe = cfg.n_periods * sum(T._slot_is_moe(cfg, s) for s in range(len(cfg.block_pattern)))
    n_norm = sum(2 if k in ("attn", "mamba") else 1 for k in kinds) + 1
    params = M.init_params(cfg, seed=6, device="cpu")
    card_params = M._to(params, cuda)
    rs = np.random.RandomState(6)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, 48)).astype(np.int32))
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    ops.reset_launches()
    logits = M.make_prefill_step(cfg)(card_params, on_card)
    assert dict(ops.LAUNCHES) == {**dict.fromkeys(ops.LAUNCHES, 0), "rmsnorm": n_norm,
                                  "flash_attention": n_attn, "moe_router": n_moe}
    torch.testing.assert_close(logits.cpu(), M.make_prefill_step(cfg)(params, batch), **tol)
    torch.testing.assert_close(M.make_eval_step(cfg)(card_params, on_card).cpu(),
                               M.make_eval_step(cfg)(params, batch), **tol)
    serve = M.make_serve_step(cfg)
    B = 3
    st_card = T.init_decode_state(cfg, B, 32, cuda)
    st_cpu = T.init_decode_state(cfg, B, 32, "cpu")
    tk = toks[0, :B].clone()
    lens = torch.tensor([0, 3, 7], dtype=torch.int32)
    for _ in range(8):
        ops.reset_launches()
        n_card, l_card, st_card = serve(card_params, st_card,
                                        {"tokens": tk.to(cuda), "lengths": lens.to(cuda)})
        assert dict(ops.LAUNCHES) == {**dict.fromkeys(ops.LAUNCHES, 0), "rmsnorm": n_norm,
                                      "decode_attention": n_attn, "moe_router": n_moe}
        n_cpu, l_cpu, st_cpu = serve(params, st_cpu, {"tokens": tk, "lengths": lens})
        torch.testing.assert_close(l_card.cpu()[:, :cfg.vocab], l_cpu[:, :cfg.vocab], **tol)
        assert torch.equal(n_card.cpu(), n_cpu)
        tk, lens = n_cpu, lens + 1
    for got, want in zip(leaves(st_card), leaves(st_cpu)):      # caches and recurrent states
        torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_cuda_encdec_and_vision_forward_and_serve_match_cpu(cuda, arch):
    """Reduced whisper (a non-causal encoder of 24 frames, a decoder of 40
    tokens whose cross-attention takes more queries than keys) and
    internvl2 (8 patch embeddings before the text) in f32: the forward,
    the loss, 8 serve steps (whisper's with the encoder's output) and the
    caches after them on the card against the same weights on the CPU
    within 3e-5, with the launches of each kernel the path runs counted
    exactly."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    cfg = get_config(arch).reduced()
    Ld, Le = cfg.n_layers, cfg.n_enc_layers
    if cfg.is_encdec:    # encoder blocks, the final norm of each stack; cross in every decoder block
        fwd = {"rmsnorm": 2 * Le + 1 + 3 * Ld + 1, "flash_attention": Le + 2 * Ld}
        step = {"rmsnorm": 3 * Ld + 1, "flash_attention": Ld, "decode_attention": Ld}
    else:
        fwd = {"rmsnorm": 2 * Ld + 1, "flash_attention": Ld}
        step = {"rmsnorm": 2 * Ld + 1, "decode_attention": Ld}
    params = M.init_params(cfg, seed=7, device="cpu")
    card_params = M._to(params, cuda)
    rs = np.random.RandomState(7)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, 40)).astype(np.int32))
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rs.randn(2, 24, cfg.d_model).astype(np.float32))
    else:
        batch["prefix_embeds"] = torch.from_numpy(
            rs.randn(2, cfg.n_prefix_embeds, cfg.d_model).astype(np.float32))
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    tol = dict(atol=3e-5, rtol=3e-5)
    ops.reset_launches()
    logits = M.make_prefill_step(cfg)(card_params, on_card)
    assert dict(ops.LAUNCHES) == {**dict.fromkeys(ops.LAUNCHES, 0), **fwd}
    torch.testing.assert_close(logits.cpu(), M.make_prefill_step(cfg)(params, batch), **tol)
    torch.testing.assert_close(M.make_eval_step(cfg)(card_params, on_card).cpu(),
                               M.make_eval_step(cfg)(params, batch), **tol)
    serve = M.make_serve_step(cfg)
    B = 2
    st_card = T.init_decode_state(cfg, B, 32, cuda)
    st_cpu = T.init_decode_state(cfg, B, 32, "cpu")
    x_card, x_cpu = {}, {}
    if cfg.is_encdec:
        with torch.inference_mode():
            x_card["enc_out"] = T._encode(card_params, on_card["frames"], cfg)
            x_cpu["enc_out"] = T._encode(params, batch["frames"], cfg)
        torch.testing.assert_close(x_card["enc_out"].cpu(), x_cpu["enc_out"], **tol)
    tk = toks[:, 0].clone()
    lens = torch.tensor([0, 5], dtype=torch.int32)
    for _ in range(8):
        ops.reset_launches()
        n_card, l_card, st_card = serve(card_params, st_card, {"tokens": tk.to(cuda),
                                                               "lengths": lens.to(cuda), **x_card})
        assert dict(ops.LAUNCHES) == {**dict.fromkeys(ops.LAUNCHES, 0), **step}
        n_cpu, l_cpu, st_cpu = serve(params, st_cpu, {"tokens": tk, "lengths": lens, **x_cpu})
        torch.testing.assert_close(l_card.cpu()[:, :cfg.vocab], l_cpu[:, :cfg.vocab], **tol)
        assert torch.equal(n_card.cpu(), n_cpu)
        tk, lens = n_cpu, lens + 1
    for got, want in zip(leaves(st_card), leaves(st_cpu)):
        torch.testing.assert_close(got.cpu(), want, **tol)


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


# ---------------------------------------------------------------------------
# the training path: the backward kernels and the autograd Functions
# ---------------------------------------------------------------------------
def _bwd_tol(dtype):
    # a gradient sums Sq * group (dK, dV) or Skv (dQ) products in f32 in
    # another order than the plain version: 1e-4 in f32; bf16 outputs keep
    # tests/test_kernels.py's bf16 tolerance
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
def test_cuda_flash_attention_bwd_matches_plain(cuda, dtype, D):
    """Every head_dim x dtype, causal and not, Sq = Skv and Sq < Skv (the
    queries the last Sq positions), ragged tiles, groups 1, 2, 6 and 8;
    the kernel and the plain version read the same o and lse (the
    forward's, whose lse is held to the plain version's too)."""
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    cases = [(1, 2, 2, 37, 37, True), (2, 4, 2, 64, 64, True), (1, 6, 1, 70, 130, True),
             (1, 8, 1, 129, 129, False), (2, 16, 2, 33, 100, False), (1, 12, 2, 1, 65, True),
             (1, 16, 2, 128, 128, True)]
    for B, Hq, Hkv, Sq, Skv, causal in cases:
        q = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        k = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        v = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        _, want_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        do = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        n0 = ops.LAUNCHES["flash_attention_bwd"]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
        torch.cuda.synchronize()
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), **_bwd_tol(dtype))
    # deterministic: no atomics, the same bits every call
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, seed, strided=False):
    """bf16 inputs of the backward from a seed, the forward kernel's o and
    lse (its lse held to the plain one), and the plain gradients.  With
    ``strided`` q, k, v and do hold the same values as transposed views of
    (B, S, H, D) tensors, as the attention layer hands them over."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(seed)

    def make(H, S):
        t = torch.randn((B, H, S, D), generator=g).to(cuda, torch.bfloat16)
        return t.transpose(1, 2).contiguous().transpose(1, 2) if strided else t

    q, k, v, do = make(Hq, Sq), make(Hkv, Skv), make(Hkv, Skv), make(Hq, Sq)
    o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
    _, want_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    return (q, k, v, o, lse, do), ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Sq, Skv, D, causal): several ring stages in both roles,
    # two consumer warpgroups a block, groups 2 and 6
    (1, 16, 8, 1000, 1000, 128, True),
    (2, 12, 2, 1000, 1000, 128, True),
    # ragged: the last key block's second warpgroup holds no key (1037 keys
    # in blocks of 128), the last query block's second 8 of its 64 queries
    (2, 16, 8, 200, 1037, 128, True),
    # whisper's non-causal cross-attention shape, D = 64
    (1, 16, 16, 448, 1500, 64, False),
    # one consumer warpgroup a block, ragged tails, D = 32 and 16
    (1, 4, 2, 100, 300, 32, True),
    (1, 6, 1, 77, 77, 16, False),
])
def test_cuda_flash_attention_bwd_bf16_wgmma_body(cuda, case):
    """The bf16 body (TMA + wgmma, after the delta pre-pass) at shapes that
    cross several stages of the ring in both roles, with one and two
    consumer warpgroups a block, against the plain version at the bf16
    tolerance; the same bits on a second call, and with q, k, v and do
    handed over as strided views (read in place by the tensor maps)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sq, Skv, D, causal = case
    geo = fa.bwd_geometry(B, Hq, Hkv, Sq, Skv, True, build.sm_count(cuda.index or 0))
    assert geo.warpgroups == (1 if D < 64 else 2)
    args, want = _bwd_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, seed=sum(case))
    n0 = ops.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(*args, causal=causal)
    assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape and a.is_contiguous()
        torch.testing.assert_close(a.float(), w.float(), **_bwd_tol("bfloat16"))
    again = fa.flash_attention_bwd(*args, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    sargs, swant = _bwd_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, seed=sum(case), strided=True)
    assert all(fa.tma_strides(t) is not None for t in (sargs[0], sargs[1], sargs[2], sargs[5]))
    sgot = fa.flash_attention_bwd(*sargs, causal=causal)
    for a, w in zip(sgot, swant):
        torch.testing.assert_close(a.float(), w.float(), **_bwd_tol("bfloat16"))
    # the same values laid out otherwise: the same bits
    assert all(torch.equal(a, b) for a, b in zip(sgot, got))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [6, 7, 8])
def test_cuda_flash_attention_bwd_head_split(cuda, G, causal, D):
    """The bf16 backward with the group's heads split over key-tile blocks
    (groups 6, 7 and 8, ragged 200 x 1037 over one and two KV heads, and a
    grid of two consumer warpgroups a block): against the plain version at
    the bf16 tolerance; two calls and two replays of a captured graph
    equal bit for bit (the partials are summed in part order and the
    tickets left 0); two kernel nodes a call."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    n_sm = build.sm_count(cuda.index or 0)
    for B, Hkv, Sq, Skv in ((1, 1, 200, 1037), (1, 2, 200, 1037), (1, 2, 2048, 2048)):
        Hq = G * Hkv
        geo = fa.bwd_geometry(B, Hq, Hkv, Sq, Skv, True, n_sm, causal)
        assert geo.head_split > 1
        args, want = _bwd_case(cuda, B, Hq, Hkv, Sq, Skv, D, causal, seed=G + Sq + D)
        n0 = ops.LAUNCHES["flash_attention_bwd"]
        got = fa.flash_attention_bwd(*args, causal=causal)
        assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            torch.testing.assert_close(a.float(), w.float(), **_bwd_tol("bfloat16"))
        again = fa.flash_attention_bwd(*args, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            outs = [fa.flash_attention_bwd(*args, causal=causal) for _ in range(2)]
        assert build.graph_nodes(g) == (4, 4)
        g.instantiate()
        for _ in range(2):
            for out in outs:
                for t in out:
                    t.fill_(float("nan"))
            g.replay()
            torch.cuda.synchronize()
            for out in outs:
                assert all(torch.equal(a, b) for a, b in zip(out, got))
    assert geo.warpgroups == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["dbrx", "internvl2"])
def test_cuda_flash_attention_bwd_head_split_at_the_train_shapes(cuda, shape):
    """dbrx-132b's (1, 48/8, 1024, 128) and internvl2-1b's (1, 14/2,
    4096, 64) causal training shapes, each with a head split of 3: the
    plain version's gradients at the bf16 tolerance, and dq, dk and dv bit
    for bit over two calls and two graph replays."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, S, D = {"dbrx": (1, 48, 8, 1024, 128), "internvl2": (1, 14, 2, 4096, 64)}[shape]
    assert fa.bwd_geometry(B, Hq, Hkv, S, S, True, build.sm_count(cuda.index or 0)).head_split == 3
    args, want = _bwd_case(cuda, B, Hq, Hkv, S, S, D, True, seed=S + D)
    got = fa.flash_attention_bwd(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **_bwd_tol("bfloat16"))
    del want
    assert all(torch.equal(a, b) for a, b in zip(fa.flash_attention_bwd(*args), got))
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        out = fa.flash_attention_bwd(*args)
    assert build.graph_nodes(g) == (2, 2)
    g.instantiate()
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, got))


@pytest.mark.cuda
def test_cuda_flash_attention_head_dim_64_pipelined(cuda):
    """The bf16 forward at D = 64: one tile at a time at the 64-query tile,
    and at the 128- and 192-query tiles the pipelined schedule (S of tile
    i issued with P V of tile i-1, the consumer warpgroups in turns);
    ragged lengths, Sq < Skv and Sq > Skv, one key tile and many, causal
    and not, groups 1, 7 and 8: against the plain version at the bf16
    tolerance, its lse to 1e-4, and the same bits on a second call."""
    from repro_torch.kernels import flash_attention as fa
    cases = [(1, 14, 2, 1037, 1037, True), (1, 14, 2, 200, 1037, True),
             (1, 4, 4, 1500, 448, False), (1, 8, 1, 1, 1500, False), (1, 16, 2, 64, 127, True),
             (1, 16, 16, 448, 1500, False), (2, 16, 16, 1037, 1037, True),
             (4, 16, 16, 1500, 1500, False), (1, 64, 8, 129, 300, True),
             (2, 32, 4, 300, 300, True), (1, 14, 2, 4096, 4096, True),
             (2, 66, 6, 1037, 1037, True), (1, 140, 20, 193, 1500, False)]
    tiles = set()
    for B, Hq, Hkv, Sq, Skv, causal in cases:
        tiles.add(fa.query_tile(B, Hq, Sq, D=64))
        q = torch.randn(B, Hq, Sq, 64, dtype=torch.bfloat16, device=cuda)
        k = torch.randn(B, Hkv, Skv, 64, dtype=torch.bfloat16, device=cuda)
        v = torch.randn(B, Hkv, Skv, 64, dtype=torch.bfloat16, device=cuda)
        got, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        want, want_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
        torch.testing.assert_close(got.float(), want.float(), **_tol("bfloat16"))
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        assert torch.equal(fa.flash_attention(q, k, v, causal=causal), got)
    assert tiles == {64, 128, 192}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 32, 64, 112, 128])
def test_cuda_flash_attention_bwd_more_queries_than_keys(cuda, dtype, D):
    """The backward at non-causal Sq > Skv (whisper's cross-attention with
    a decoder longer than its frames) at every head_dim x dtype, groups 1,
    2, 7 and 16, ragged 1037 x 200, Sq = 2 Skv and one key: equal to the
    plain version, the same bits on a replay, two kernel nodes a call (the
    delta pre-pass and the body) in a captured graph.  Causal Sq > Skv
    raises."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    for B, Hq, Hkv, Sq, Skv in ((1, 4, 4, 1037, 200), (2, 4, 2, 256, 128), (1, 14, 2, 300, 77),
                                (1, 16, 1, 130, 64), (2, 2, 2, 65, 1)):
        q = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        k = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        v = torch.randn(B, Hkv, Skv, D, dtype=dt, device=cuda)
        do = torch.randn(B, Hq, Sq, D, dtype=dt, device=cuda)
        o, lse = fa.flash_attention(q, k, v, causal=False, with_lse=True)
        _, want_lse = ref.attention_ref(q, k, v, causal=False, return_lse=True)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        n0 = ops.LAUNCHES["flash_attention_bwd"]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
        assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=False)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            torch.testing.assert_close(a.float(), w.float(), **_bwd_tol(dtype))
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            outs = [fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False) for _ in range(2)]
        assert build.graph_nodes(g) == (4, 4)
        g.instantiate()
        g.replay()
        torch.cuda.synchronize()
        for out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, got))
    with pytest.raises(ValueError, match="Sq=.* > Skv"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)


# (B, Hq, Hkv, Sq, Skv): the f32 bodies' tile edges (1, 63, 64, 65, 127,
# 129 queries or keys against tiles of 64, and 32 keys in the forward at
# D = 112 and 128), groups 1, 2, 6, 7 and 8, Sq < Skv ragged, and (non-causal
# only) Sq > Skv
F32_EDGE_SHAPES = [(1, 1, 1, 1, 1), (1, 2, 2, 63, 63), (1, 2, 1, 64, 65), (2, 6, 1, 65, 129),
                   (1, 7, 1, 127, 127), (1, 8, 1, 129, 300), (1, 4, 2, 63, 1037),
                   (1, 8, 1, 1, 129)]
F32_LONG_Q_SHAPES = [(1, 2, 1, 129, 63), (1, 7, 1, 65, 1), (2, 8, 8, 127, 64)]


def _forced_bwd_geometry(split):
    """``bwd_geometry`` with its head split forced to min(split, G), the
    rest of the geometry following it."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.bwd_geometry

    def geometry(B, Hq, Hkv, Sq, Skv, bf16, n_sm=132, causal=True):
        geo = real(B, Hq, Hkv, Sq, Skv, bf16, n_sm, causal)
        G = Hq // Hkv
        c = min(split, G)
        return geo._replace(head_split=c, key_blocks=B * Hkv * -(-Skv // geo.rows) * c,
                            key_block_tiles=-(-G // c) * -(-Sq // fa.BWD_ROWS))
    return geometry


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,wgmma", [(16, True), (16, False), (32, True), (32, False), (64, True),
                                     (64, False), (112, False), (128, False)])
def test_cuda_flash_attention_f32_bodies_at_the_tile_edges(cuda, D, wgmma, causal, monkeypatch):
    """The float32 forward and backward (3xTF32 on the tensor cores) at the
    tile edges, every head_dim, groups 1-8, ragged Sq < Skv and (not
    causal) Sq > Skv, each unsplit and with the forward's key split and
    the backward's head split and dQ split forced through their pure
    functions, the backward's S and dP on wgmma or on mma.sync as forced
    through ``f32_bwd_wgmma`` (wgmma up to head_dim 64, where its tiles
    fit): the
    output and lse against ``ref.attention_ref``, dq, dk and dv against
    ``ref.attention_bwd_ref`` at the f32 tolerances, and the same bits on
    a second call."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    real_split, real_dq_split = fa.key_split, fa.dq_split
    monkeypatch.setattr(fa, "f32_bwd_wgmma", lambda *a, **kw: wgmma)
    shapes = F32_EDGE_SHAPES + ([] if causal else F32_LONG_Q_SHAPES)
    seen = set()
    for i, (B, Hq, Hkv, Sq, Skv) in enumerate(shapes):
        g = torch.Generator(device="cpu").manual_seed(1000 * D + i)
        q, do = (torch.randn((B, Hq, Sq, D), generator=g).to(cuda) for _ in range(2))
        k, v = (torch.randn((B, Hkv, Skv, D), generator=g).to(cuda) for _ in range(2))
        want_o, want_lse = ref.attention_ref(q, k, v, causal=causal, return_lse=True)
        for fsplit, hsplit in ((1, 1), (3, Hq // Hkv)):
            monkeypatch.setattr(fa, "key_split", lambda *a, c=fsplit, **kw: c)
            monkeypatch.setattr(fa, "bwd_geometry", _forced_bwd_geometry(hsplit))
            monkeypatch.setattr(fa, "dq_split", lambda *a, c=fsplit, **kw: c)
            o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
            torch.testing.assert_close(o, want_o, **_tol("float32"))
            torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
            assert torch.equal(fa.flash_attention(q, k, v, causal=causal), o)
            n0 = ops.LAUNCHES["flash_attention_bwd"]
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            assert ops.LAUNCHES["flash_attention_bwd"] == n0 + 1
            want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
            for a, w in zip(got, want):
                assert a.dtype == w.dtype and a.shape == w.shape
                torch.testing.assert_close(a, w, **_bwd_tol("float32"))
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            seen.add((fsplit, min(hsplit, Hq // Hkv)))
    monkeypatch.setattr(fa, "key_split", real_split)
    monkeypatch.setattr(fa, "dq_split", real_dq_split)
    assert (1, 1) in seen and (3, 8) in seen and (3, 1) in seen
    assert build.F32_LAUNCHES["flash_attention_bwd"] >= len(seen)


@pytest.mark.cuda
def test_cuda_flash_attention_f32_without_keys(cuda):
    """A non-causal float32 or bfloat16 call with queries and no keys: the
    forward gives zeros and an lse of +inf (every row's l is 0) and the
    backward zero dq, with no launch; causal, it raises."""
    from repro_torch.kernels import flash_attention as fa
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 4, 37, 64), device=cuda).to(dt)
        k = v = torch.empty((1, 2, 0, 64), device=cuda, dtype=dt)
        n0 = dict(ops.LAUNCHES)
        o, lse = fa.flash_attention(q, k, v, causal=False, with_lse=True)
        assert torch.equal(o, torch.zeros_like(q)) and bool(torch.isinf(lse).all())
        assert torch.equal(fa.flash_attention(q, k, v, causal=False), torch.zeros_like(q))
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, q, causal=False)
        assert torch.equal(dq, torch.zeros_like(q)) and dk.shape == dv.shape == k.shape
        assert dict(ops.LAUNCHES) == n0
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("D,wgmma", [(64, True), (64, False), (112, False)])
def test_cuda_flash_attention_f32_split_in_a_captured_graph(cuda, D, wgmma, monkeypatch):
    """The f32 forward with its key split (kimi-k2's 8 heads over 300 ragged
    queries: ``key_split`` gives 4 at D = 112, 5 at 64) and the backward
    with its head split and dQ split (8 and 3, and the router's training
    shape: 2 and 1; its forward unsplit at D = 64), each two calls captured in a
    CUDA graph: one kernel node a forward call and two a backward call,
    and two replays equal to an eager call bit for bit (the parts merged in
    part order, the tickets left 0); the backward's S and dP on wgmma or
    on mma.sync, forced."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "f32_bwd_wgmma", lambda *a, **kw: wgmma)
    n_sm = build.sm_count(cuda.index or 0)
    for B, Hq, Hkv, S_q, S_kv, fsplit, hsplit, dsplit in (
            (1, 8, 1, 300, 1037, {64: 5, 112: 4}[D], 8, 3),
            (8, 4, 2, 128, 128, {64: 1, 112: 2}[D], 2, 1)):
        assert fa.key_split(B, Hq, S_q, S_kv, D, True, 132) == fsplit
        assert fa.bwd_geometry(B, Hq, Hkv, S_q, S_kv, False, 132, True).head_split == hsplit
        assert fa.dq_split(B, Hq, Hkv, S_q, S_kv, 132, True) == dsplit
        assert fa.key_split(B, Hq, S_q, S_kv, D, True, n_sm) > 1 or fsplit == 1
        g = torch.Generator(device="cpu").manual_seed(S_q + D)
        q, do = (torch.randn((B, Hq, S_q, D), generator=g).to(cuda) for _ in range(2))
        k, v = (torch.randn((B, Hkv, S_kv, D), generator=g).to(cuda) for _ in range(2))
        o, lse = fa.flash_attention(q, k, v, with_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
        want_o, want_lse = ref.attention_ref(q, k, v, return_lse=True)
        torch.testing.assert_close(o, want_o, **_tol("float32"))
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        for a, w in zip(grads, ref.attention_bwd_ref(q, k, v, o, lse, do)):
            torch.testing.assert_close(a, w, **_bwd_tol("float32"))
        torch.cuda.synchronize()
        for fn, nodes, want in ((lambda: fa.flash_attention(q, k, v, with_lse=True), 1, (o, lse)),
                                (lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 2, grads)):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                outs = [fn() for _ in range(2)]
            assert build.graph_nodes(graph) == (2 * nodes, 2 * nodes)
            graph.instantiate()
            for _ in range(2):
                for out in outs:
                    for t in out:
                        t.fill_(float("nan"))
                graph.replay()
                torch.cuda.synchronize()
                for out in outs:
                    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_rmsnorm_bwd_matches_plain(cuda, dtype):
    """Rows the forward's vector body takes (64 ... 6144, aligned) and its
    scalar body (D = 130, a misaligned base, a non-contiguous dy), with an
    f32 scale, one in x's dtype and none; dscale summed over 65,536 rows
    in two passes, the same bits every call."""
    from repro_torch.kernels import rmsnorm as rn
    dt = getattr(torch, dtype)
    cases = [((1024, 256), "f32"), ((4096, 2048), "x"), ((65536, 128), "x"), ((8, 6144), "x"),
             ((7, 130), "f32"), ((3, 5, 64), None), ((33, 16), "x"), ((4, 256), None)]
    for shape, scaled in cases:
        x = torch.randn(shape, dtype=dt, device=cuda)
        dy = torch.randn(shape, dtype=dt, device=cuda)
        s = {"f32": torch.randn(shape[-1], device=cuda),
             "x": torch.randn(shape[-1], dtype=dt, device=cuda), None: None}[scaled]
        n0 = ops.LAUNCHES["rmsnorm_bwd"]
        dx, ds = rn.rmsnorm_bwd(x, s, dy)
        assert ops.LAUNCHES["rmsnorm_bwd"] == n0 + 1
        wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
        assert dx.dtype == x.dtype and dx.shape == x.shape
        torch.testing.assert_close(dx.float(), wx.float(), **_bwd_tol(dtype))
        if s is None:
            assert ds is None
        else:
            assert ds.dtype == s.dtype
            rows = x.numel() // shape[-1]
            # a column sum over `rows` terms: its rounding grows with sqrt(rows)
            torch.testing.assert_close(ds.float(), ws.float(), rtol=2e-2,
                                       atol=1e-4 * rows ** 0.5 * (100 if dtype == "bfloat16" else 1))
            assert torch.equal(rn.rmsnorm_bwd(x, s, dy)[1], ds)
    s = torch.randn(130, dtype=dt, device=cuda)
    x = torch.randn(64 * 130 + 1, dtype=dt, device=cuda)[1:].view(64, 130)     # misaligned
    dy = torch.randn(130, 64, dtype=dt, device=cuda).t()                      # non-contiguous
    dx, ds = rn.rmsnorm_bwd(x, s, dy)
    wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
    torch.testing.assert_close(dx.float(), wx.float(), **_bwd_tol(dtype))
    torch.testing.assert_close(ds.float(), ws.float(), **_bwd_tol(dtype))


@pytest.mark.cuda
def test_cuda_backward_kernels_in_a_captured_graph(cuda):
    """Captured in a CUDA graph, three calls of flash_attention_bwd make
    six kernel nodes in f32 and in bf16 (the delta pre-pass and the body),
    and of rmsnorm_bwd three with or without a scale (dscale's
    column sums are taken by the blocks that arrive last), and no other
    node; the replay matches an eager call bit for bit."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    q = torch.randn(2, 4, 128, 64, device=cuda)
    k = torch.randn(2, 2, 128, 64, device=cuda)
    v = torch.randn(2, 2, 128, 64, device=cuda)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    do = torch.randn_like(o)
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    ob, lseb = fa.flash_attention(qb, kb, vb, with_lse=True)
    x = torch.randn(512, 256, device=cuda)
    dy = torch.randn_like(x)
    s = torch.randn(256, device=cuda)
    xb, dyb, sb = (t.to(torch.bfloat16) for t in (x, dy, s))
    for fn, calls, nodes in ((lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 3, 6),
                             (lambda: fa.flash_attention_bwd(qb, kb, vb, ob, lseb, dob), 3, 6),
                             (lambda: rn.rmsnorm_bwd(x, None, dy), 3, 3),
                             (lambda: rn.rmsnorm_bwd(x, s, dy), 3, 3),
                             (lambda: rn.rmsnorm_bwd(xb, sb, dyb), 3, 3)):
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            outs = [fn() for _ in range(calls)]
        assert build.graph_nodes(g) == (nodes, nodes)
        g.instantiate()
        g.replay()
        g.replay()          # the arrival counters are left 0 for the next replay
        torch.cuda.synchronize()
        for out in outs:
            for a, b in zip(out, fn()):
                assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_rmsnorm_bwd_on_two_streams_at_once(cuda):
    """rmsnorm_bwd with a scale launched on two streams at once, many
    times over: each stream has its own arrival counters, so neither
    counts the other's blocks, and every dscale is the single-stream
    result bit for bit."""
    from repro_torch.kernels import rmsnorm as rn
    x = [torch.randn(4096, 2048, device=cuda, dtype=torch.bfloat16) for _ in range(2)]
    dy = [torch.randn_like(t) for t in x]
    s = torch.randn(2048, device=cuda, dtype=torch.bfloat16)
    want = [rn.rmsnorm_bwd(x[i], s, dy[i]) for i in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i in range(2):
            with torch.cuda.stream(streams[i]):
                outs[i].append(rn.rmsnorm_bwd(x[i], s, dy[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for dx, ds in outs[i]:
            assert torch.equal(dx, want[i][0]) and torch.equal(ds, want[i][1])


@pytest.mark.cuda
def test_cuda_kernels_without_a_backward_raise_under_grad(cuda):
    """decode_attention has no backward kernel: with an input that
    requires grad under grad mode it raises, naming it; under no_grad it
    launches as for serving.  The kernel wrappers of flash, rmsnorm and
    moe_router refuse such an input too (ops routes it through the
    Function)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import rmsnorm as rn
    q = torch.randn(2, 4, 64, device=cuda, requires_grad=True)
    kc = torch.randn(2, 2, 32, 64, device=cuda)
    ln = torch.tensor([5, 32], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="decode_attention has no backward"):
        ops.decode_attention(q, kc, kc, ln)
    with torch.no_grad():
        assert ops.decode_attention(q, kc, kc, ln).shape == (2, 4, 64)
    x = torch.randn(4, 1, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(x, x, x)
    with pytest.raises(RuntimeError, match="requires grad"):
        rn.rmsnorm(x)
    logits = torch.randn(16, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad; call kernels.ops"):
        mr.moe_router(logits, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        w = torch.rand(16, 2, device=cuda, requires_grad=True)
        mr.moe_router_bwd(None, w, torch.zeros(16, 2, dtype=torch.int32, device=cuda),
                          torch.ones(16, 2, device=cuda), n_experts=8)
    # through ops the Functions carry the gradient
    y = ops.attention(x, x, x)
    assert y.grad_fn is not None and ops.rmsnorm(x, None).grad_fn is not None
    assert ops.moe_router(logits, 2)[0].grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("renormalize", [True, False])
def test_cuda_moe_router_under_grad_runs_both_kernels(cuda, renormalize):
    """Under grad ``ops.moe_router`` on the card is the Function: one
    moe_router launch forward, one moe_router_bwd launch backward, the
    weights and the logits' gradient equal to the plain versions' (and to
    autograd of the plain forward), the ids carrying no gradient, and no
    plain version run."""
    g = torch.Generator().manual_seed(4)
    for T, E, k in ((4096, 16, 4), (37, 384, 8), (5, 16, 2)):
        x = (torch.randn(T, E, generator=g) * 2).to(cuda).requires_grad_(True)
        dw = torch.randn(T, k, generator=g).to(cuda)
        ops.reset_launches()
        w, idx = ops.moe_router(x, k, renormalize=renormalize)
        (dz,) = torch.autograd.grad(w, x, dw)
        assert dict(ops.LAUNCHES) == {**dict.fromkeys(ops.LAUNCHES, 0), "moe_router": 1,
                                      "moe_router_bwd": 1}
        assert not idx.requires_grad
        xp = x.detach().clone().requires_grad_(True)
        pw, pidx = ref.moe_router_ref(xp, k, renormalize=renormalize)
        assert torch.equal(idx, pidx)
        torch.testing.assert_close(w.detach(), pw.detach(), atol=1e-6, rtol=0)
        (want,) = torch.autograd.grad(pw, xp, dw)
        plain = ref.moe_router_bwd_ref(x.detach(), w.detach(), idx, dw,
                                       renormalize=renormalize)
        torch.testing.assert_close(dz, plain, atol=3e-5, rtol=3e-5)
        torch.testing.assert_close(dz, want, atol=3e-5, rtol=3e-5)


ROUTER_BWD_E = [1, 2, 3, 4, 5, 16, 17, 32, 33, 384, 700, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("renormalize", [True, False])
def test_cuda_moe_router_bwd_matches_plain_in_a_captured_graph(cuda, renormalize):
    """moe_router_bwd at E in ROUTER_BWD_E (rows of 16-byte multiples and
    not: odd E and E = 2 mod 4 take 4- and 8-byte stores), k at 1 and
    min(E, 32), T in {0, 1, 4099}, on normal, tie-laden and all-equal
    logits (the forward's ids, so ties stay as it broke them) and with a
    non-contiguous ``dweights`` view, against its plain version; without
    renormalize a gradient of 1 on the first chosen slot gives
    dz = p (1 - p) there from the forward's own weight, to the bit (p is
    recomputed in the forward's order).  Three calls captured in a CUDA
    graph make three kernel nodes and no other node, and the replay gives
    the same gradient bit for bit."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_router as mr
    g = torch.Generator().manual_seed(5)
    for E in ROUTER_BWD_E:
        for k in sorted({1, min(E, 32)}):
            for T in (0, 1, 4099):
                x = torch.randn(T, E, generator=g) * 2
                for kind, logits in (("normal", x), ("ties", torch.round(x * 2) / 2),
                                     ("equal", torch.zeros_like(x))):
                    logits = logits.to(cuda)
                    w, idx = mr.moe_router(logits, k, renormalize=renormalize)
                    dw = torch.randn(T, k, generator=g).to(cuda)
                    if kind == "ties":            # a strided view of every other column
                        dw = torch.randn(T, 2 * k, generator=g).to(cuda)[:, ::2]
                        assert dw.is_contiguous() == (T * k <= 1)
                    lg = None if renormalize else logits
                    n0 = ops.LAUNCHES["moe_router_bwd"]
                    got = mr.moe_router_bwd(lg, w, idx, dw, renormalize=renormalize, n_experts=E)
                    assert ops.LAUNCHES["moe_router_bwd"] == n0 + (T > 0)
                    want = ref.moe_router_bwd_ref(logits, w, idx, dw, renormalize=renormalize)
                    assert got.shape == (T, E) and got.dtype == torch.float32
                    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)
                    if not renormalize and T:
                        one = torch.zeros(T, k, device=cuda)
                        one[:, 0] = 1
                        p0 = mr.moe_router_bwd(lg, w, idx, one, renormalize=False,
                                               n_experts=E).gather(1, idx[:, :1].long())
                        assert torch.equal(p0, w[:, :1] * (1 - w[:, :1])), (E, k, T, kind)
                if T == 0:
                    continue
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph):
                    outs = [mr.moe_router_bwd(lg, w, idx, dw, renormalize=renormalize,
                                              n_experts=E) for _ in range(3)]
                assert build.graph_nodes(graph) == (3, 3)
                graph.instantiate()
                graph.replay()
                torch.cuda.synchronize()
                for out in outs:
                    assert torch.equal(out, got)
    with pytest.raises(ValueError):                      # k > 32
        mr.moe_router_bwd(None, torch.rand(2, 33, device=cuda),
                          torch.zeros(2, 33, dtype=torch.int32, device=cuda),
                          torch.rand(2, 33, device=cuda), n_experts=64)
    with pytest.raises(ValueError):                      # no logits without renormalize
        mr.moe_router_bwd(None, w, idx, dw, renormalize=False, n_experts=E)


@pytest.mark.cuda
def test_cuda_moe_router_bwd_entry_refuses_a_geometry_it_has_no_instance_for(cuda):
    """The C entry, reached through ctypes with a hand-packed argument
    buffer, launches router_bwd_geometry's geometry and refuses with
    cudaErrorInvalidValue (1) lanes, pieces, warps or blocks other than
    that geometry's, more warps than the instance's most, and a missing
    logits pointer without renormalize; a refused call writes nothing."""
    from repro_torch.kernels import moe_router as mr
    T, E, k = 40, 16, 4
    x = torch.randn(T, E, device=cuda)
    w, idx = mr.moe_router(x, k)
    dw = torch.randn(T, k, device=cuda)
    dz = torch.full((T, E), 7.0, device=cuda)
    entry = mr._entry("moe_router_bwd_launch")
    stream = torch.cuda.current_stream().cuda_stream

    def call(geometry, renormalize=1, logits=0):
        return entry(mr._PACK_BWD(logits, w.data_ptr(), idx.data_ptr(), dw.data_ptr(),
                                  dz.data_ptr(), T, E, k, renormalize, *geometry, stream))
    L, P, W, blocks = mr.router_bwd_geometry(T, E, k)
    for bad in ((8, P, W, blocks), (2, P, W, blocks), (L, 2, W, blocks), (L, P, 0, blocks),
                (L, P, 33, blocks), (L, P, W, blocks + 1), (L, P, W, blocks - 1),
                (L, P, 64, 1)):
        assert call(bad) == 1, bad
    assert call((L, P, W, blocks), renormalize=0) == 1        # no logits pointer
    torch.cuda.synchronize()
    assert bool((dz == 7.0).all())
    assert call((L, P, W, blocks)) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(dz, ref.moe_router_bwd_ref(x, w, idx, dw), atol=3e-5, rtol=3e-5)
    # a wide row of 8 pieces has an instance of at most 8 warps a block
    T, E, k = 64, 1024, 8
    x = torch.randn(T, E, device=cuda)
    w, idx = mr.moe_router(x, k)
    dw = torch.randn(T, k, device=cuda)
    dz = torch.empty(T, E, device=cuda)
    assert call((32, 8, 16, 4)) == 1 and call((32, 8, 8, 8)) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(dz, ref.moe_router_bwd_ref(x, w, idx, dw), atol=3e-5, rtol=3e-5)


def _serve_tokens(eng, requests):
    """{rid: generated token ids} of ``requests`` run through ``eng``."""
    out, step = {}, eng.step

    def logged_step():
        lanes = {id(r): i for i, r in enumerate(eng.slots) if r is not None}
        done = step()
        for r in done:
            out[r.rid] = list(eng._gen[lanes[id(r)]])
        return done
    eng.step = logged_step
    eng.run(requests)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cuda_recurrent_serving_engine_matches_cpu(cuda, arch):
    """Reduced jamba and xlstm in f32 through the ServingEngine over a
    DeviceEngine on the card, B = 4 over 6 requests: each request's tokens
    equal the CPU run's, and the card's B = 1 runs on a fresh engine
    each; the decode steps launched the model's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig
    from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models import model as M
    from repro_torch.runtime.serving import Request, ServingEngine
    docs, qs = generate_authtrace(AuthTraceConfig(n_docs=48, n_questions=6, seed=5))
    pipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle())
    pipe.bootstrap(docs)
    for i in range(0, len(docs), 16):
        pipe.ingest(docs[i:i + 16])
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=2, device="cpu")
    card = M._to(params, cuda)
    tok = HashTokenizer(vocab_size=cfg.vocab).fit([d["text"] for d in docs])
    dev_eng = DeviceEngine.from_store(pipe.store, device=cuda)

    def reqs():
        return [Request(rid=f"q{i}", query=q.text, max_new_tokens=4) for i, q in enumerate(qs)]

    def serve(p, store, batch, device, rs):
        return _serve_tokens(ServingEngine(cfg, p, tok, store, HeuristicOracle(),
                                           batch_size=batch, max_len=48, device=device), rs)
    ops.reset_launches()
    on_card = serve(card, dev_eng, 4, cuda, reqs())
    assert ops.LAUNCHES["rmsnorm"] > 0 and ops.LAUNCHES["path_lookup"] > 0
    assert (ops.LAUNCHES["moe_router"] > 0) == (cfg.moe is not None)
    on_cpu = serve(params, pipe.store, 4, "cpu", reqs())
    alone = {}
    for r in reqs():
        alone.update(serve(card, dev_eng, 1, cuda, [r]))
    assert len(on_card) == 6 and all(len(t) == 4 for t in on_card.values())
    assert on_card == on_cpu
    assert alone == on_card


@pytest.mark.cuda
def test_cuda_dbrx_train_step_matches_cpu(cuda):
    """A reduced f32 dbrx (MoE in every layer): the loss and every
    gradient on the card (flash, rmsnorm and moe_router Functions: one
    moe_router_bwd per layer) against the CPU's autograd of the plain
    versions, within 1e-4 relative to each leaf's largest gradient, the
    router's included; then 3 train steps, parameters within 3 lr."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves
    cfg = get_config("dbrx-132b").reduced(n_layers=3, d_model=128, vocab=1000)
    params = M.init_params(cfg, seed=5, device="cpu")
    card = M._to(params, cuda)
    rs = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, 77)).astype(np.int32))
        labels = torch.roll(toks, -1, dims=1)
        labels[:, -1] = -1
        batches.append({"tokens": toks, "labels": labels})
    ops.reset_launches()
    loss, grads = M.loss_and_grads(card, {k: v.to(cuda) for k, v in batches[0].items()}, cfg)
    assert ops.LAUNCHES["moe_router"] == ops.LAUNCHES["moe_router_bwd"] == cfg.n_layers
    assert ops.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    want_loss, want = M.loss_and_grads(params, batches[0], cfg)
    torch.testing.assert_close(loss.cpu(), want_loss, atol=3e-5, rtol=3e-5)
    assert float(grads["body"]["slot0"]["moe"]["router"].abs().max()) > 0
    for g, w in zip(leaves(grads), leaves(want)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    opt_cfg = AdamWConfig(lr=1e-3)
    step = M.make_train_step(cfg, opt_cfg, total_steps=10)
    cp, cs, hp, hs = card, adamw_init(card, opt_cfg), params, adamw_init(params, opt_cfg)
    for b in batches:
        cp, cs, caux = step(cp, cs, {k: v.to(cuda) for k, v in b.items()})
        hp, hs, haux = step(hp, hs, b)
        torch.testing.assert_close(caux["loss"].cpu(), haux["loss"], atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves(cp), leaves(hp)):
        torch.testing.assert_close(a.cpu(), b, atol=3e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_router_train_step_matches_cpu(cuda):
    """A reduced f32 router: the loss and every gradient on the card (the
    flash and rmsnorm Functions and their backward kernels: one
    flash_attention_bwd per layer, 4 rmsnorm_bwd per layer and one for the
    final norm) against the CPU's autograd of the plain versions, within
    1e-4 relative to each leaf's largest gradient; then 3 train steps,
    parameters within 3 lr (tests/torch_train_common.py's reason)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves
    cfg = get_config("wikikv-router").reduced(n_layers=3, d_model=128, vocab=1000)
    params = M.init_params(cfg, seed=5, device="cpu")
    card = M._to(params, cuda)
    rs = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, 77)).astype(np.int32))
        labels = torch.roll(toks, -1, dims=1)
        labels[:, -1] = -1
        batches.append({"tokens": toks, "labels": labels})
    ops.reset_launches()
    loss, grads = M.loss_and_grads(card, {k: v.to(cuda) for k, v in batches[0].items()}, cfg)
    assert ops.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    assert ops.LAUNCHES["rmsnorm_bwd"] == 4 * cfg.n_layers + 1
    want_loss, want = M.loss_and_grads(params, batches[0], cfg)
    torch.testing.assert_close(loss.cpu(), want_loss, atol=3e-5, rtol=3e-5)
    for g, w in zip(leaves(grads), leaves(want)):
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    opt_cfg = AdamWConfig(lr=1e-3)
    step = M.make_train_step(cfg, opt_cfg, total_steps=10)
    cp, cs, hp, hs = card, adamw_init(card, opt_cfg), params, adamw_init(params, opt_cfg)
    for b in batches:
        cp, cs, caux = step(cp, cs, {k: v.to(cuda) for k, v in b.items()})
        hp, hs, haux = step(hp, hs, b)
        torch.testing.assert_close(caux["loss"].cpu(), haux["loss"], atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves(cp), leaves(hp)):
        torch.testing.assert_close(a.cpu(), b, atol=3e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_cuda_selective_scan_matches_cpu(cuda, with_h0):
    """The scan's autograd Function on the card: y, h_last and every
    input's gradient (u, Δ, B, C, A_log, D and the carried state) against
    the CPU's, across chunk boundaries (300 steps in chunks of 256, and
    of 64), in f32 within 1e-4 of each gradient's largest."""
    from repro_torch.models import ssm as S
    g = torch.Generator().manual_seed(8)
    B, T_, Din, N = 2, 300, 64, 16
    u = torch.randn(B, T_, Din, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, T_, Din, generator=g) - 2.0)
    Bm, Cm = torch.randn(B, T_, N, generator=g), torch.randn(B, T_, N, generator=g)
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)).repeat(Din, 1)
    D_skip = torch.randn(Din, generator=g)
    h0 = torch.randn(B, Din, N, generator=g) * 0.5 if with_h0 else None
    dy, dh = torch.randn(B, T_, Din, generator=g), torch.randn(B, Din, N, generator=g)
    ins = [t for t in (u, dt, Bm, Cm, A_log, D_skip, h0) if t is not None]

    def run(dev, chunk):
        leaves_ = [t.to(dev).requires_grad_(True) for t in ins]
        a = leaves_ + [None] * (7 - len(leaves_))
        y, h = S._ssm_core(*a[:6], h0=a[6], chunk=chunk)
        assert type(h.grad_fn).__name__ == "_SelectiveScanBackward"
        grads = torch.autograd.grad((y, h), leaves_, (dy.to(dev), dh.to(dev)))
        return [t.detach().cpu() for t in (y, h, *grads)]
    for chunk in (256, 64):
        for got, want in zip(run(cuda, chunk), run("cpu", chunk)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def _train_batches(cfg, rs, n, S_, frames=None):
    out = []
    for _ in range(n):
        toks = torch.from_numpy(rs.randint(0, cfg.vocab, size=(2, S_)).astype(np.int32))
        labels = torch.roll(toks, -1, dims=1)
        labels[:, -1] = -1
        b = {"tokens": toks, "labels": labels}
        if cfg.is_encdec:
            b["frames"] = torch.from_numpy(rs.randn(2, frames, cfg.d_model).astype(np.float32))
        if cfg.frontend == "vision_stub":
            b["prefix_embeds"] = torch.from_numpy(
                rs.randn(2, cfg.n_prefix_embeds, cfg.d_model).astype(np.float32))
        out.append(b)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch,frames", [("jamba-v0.1-52b", None), ("xlstm-350m", None),
                                         ("whisper-medium", 40), ("whisper-medium", 160),
                                         ("internvl2-1b", None)],
                         ids=["jamba", "xlstm", "whisper-40-frames", "whisper-160-frames",
                              "internvl2"])
def test_cuda_every_family_train_step_matches_cpu(cuda, arch, frames):
    """Reduced jamba, xlstm, whisper (40 frames under 64 tokens: the
    cross-attention's backward at Sq > Skv; and 160) and internvl2 in
    f32: the loss and every gradient on the card — one backward kernel a
    forward call of flash_attention, rmsnorm and moe_router, counted from
    the config, the scan through its Function — against the CPU's
    autograd of the plain versions, within 1e-4 of each leaf's largest
    gradient; then 3 train steps, losses within 1e-4 and parameters within
    3 lr.  xlstm's layers amplify rounding (tests/torch_train_common.py):
    it is held to twice the card's own witness, the largest change of its
    gradients, losses and parameters under two 1e-7 perturbations of the
    embedding table."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=5, device="cpu")
    batches = _train_batches(cfg, np.random.RandomState(5), 3, 64, frames)
    opt_cfg = AdamWConfig(lr=1e-3)
    step = M.make_train_step(cfg, opt_cfg, total_steps=10)

    def on(dev, b):
        return {k: v.to(dev) for k, v in b.items()}

    def run(p, dev):
        """The first batch's loss and grads, then 3 steps: losses, params."""
        p = M._to(p, dev)
        loss, grads = M.loss_and_grads(p, on(dev, batches[0]), cfg)
        s_, losses = adamw_init(p, opt_cfg), []
        for b in batches:
            p, s_, aux = step(p, s_, on(dev, b))
            losses.append(float(aux["loss"]))
        return float(loss), [g.cpu() for g in leaves(grads)], losses, [x.cpu() for x in leaves(p)]

    ops.reset_launches()
    loss_c, grads_c, losses_c, params_c = run(params, cuda)
    # one loss_and_grads and three steps
    want = {**dict.fromkeys(ops.LAUNCHES, 0),
            **{k: 4 * n for k, n in train_launches(cfg).items()}}
    assert dict(ops.LAUNCHES) == want
    loss_h, grads_h, losses_h, params_h = run(params, "cpu")
    rel, loss_tol, param_tol = 1e-4, [1e-4 * abs(x) for x in losses_h], [3e-3] * len(params_h)
    if arch == "xlstm-350m":
        g_w, l_w, p_w = 0.0, [0.0] * 3, [0.0] * len(params_h)
        for i in range(2):
            noise = torch.from_numpy(np.random.RandomState(100 + i).randn(
                *params["embed"].shape).astype(np.float32))
            _, g2, l2, p2 = run(dict(params, embed=params["embed"] * (1 + 1e-7 * noise)), cuda)
            g_w = max(g_w, max(float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(g2, grads_c)))
            l_w = [max(w, abs(a - b)) for w, a, b in zip(l_w, l2, losses_c)]
            p_w = [max(w, float((a - b).abs().max())) for w, a, b in zip(p_w, p2, params_c)]
        assert g_w <= 1e-2
        rel = max(rel, 2 * g_w)
        loss_tol = [max(a, 2 * b) for a, b in zip(loss_tol, l_w)]
        param_tol = [max(a, 2 * b) for a, b in zip(param_tol, p_w)]
    assert abs(loss_c - loss_h) <= 3e-5 * abs(loss_h)
    for g, w in zip(grads_c, grads_h):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=rel * float(w.abs().max()))
    for a, b, tol in zip(losses_c, losses_h, loss_tol):
        assert abs(a - b) <= tol, (losses_c, losses_h, loss_tol)
    for a, b, tol in zip(params_c, params_h, param_tol):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.cuda
def test_cuda_meshed_prefill_and_serve_on_one_nccl_rank_equal_the_unmeshed(cuda):
    """``make_prefill_step(cfg, mesh)`` and ``make_serve_step(cfg, mesh)`` on
    a one-rank NCCL mesh (every gather a copy) against the unmeshed
    steps, reduced qwen3 and dbrx in f32: logits bit for bit, tokens
    equal, the same launches of every kernel."""
    import dataclasses
    import socket

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import shard
    from repro_torch.launch.mesh import dp_axes, dp_size, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import map_like
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    # the MoE's index_add_ combine sums with float atomics in any order
    # unless PyTorch's deterministic algorithms are on
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_host_mesh(1, 1)
        for arch in ("qwen3-1.7b", "dbrx-132b"):
            cfg = get_config(arch).reduced()
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8))
            params = M.init_params(cfg, seed=2, device=cuda)
            shards = M.shard_params(params, cfg, mesh)
            toks = torch.randint(0, cfg.vocab, (3, 40), generator=torch.Generator().manual_seed(2),
                                 dtype=torch.int32).to(cuda)
            runs = []
            for m, p in ((None, params), (mesh, shards)):
                state = T.init_decode_state(cfg, 3, 64, cuda)
                if m is not None:
                    specs = M.decode_state_specs(cfg, 3, dp=dp_axes(m), dp_size=dp_size(m),
                                                 tp_size=1)
                    state = map_like(lambda t, s: shard(t, s, m), state, specs)
                ops.reset_launches()
                logits = M.make_prefill_step(cfg, m)(p, {"tokens": toks})
                serve = M.make_serve_step(cfg, m)
                tok, lengths, out = toks[:, 0].contiguous(), torch.zeros(3, dtype=torch.int32,
                                                                          device=cuda), []
                for _ in range(6):
                    tok, lg, state = serve(p, state, {"tokens": tok, "lengths": lengths})
                    out.append((tok, lg))
                    lengths = lengths + 1
                torch.cuda.synchronize()
                runs.append((logits, out, dict(ops.LAUNCHES)))
            (la, oa, ca), (lb, ob, cb) = runs
            assert torch.equal(la, lb), arch
            assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(oa, ob))
            assert ca == cb and ca["flash_attention"] > 0 and ca["decode_attention"] > 0
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_fake_trace_equals_the_plain_trace(cuda):
    """A reduced cell traced on fake "cuda" tensors (the kernels' shape
    rules) counts what the same cell traced on fake "cpu" tensors (the
    plain versions) counts: cost, collectives and memory, on a (2, 2)
    fake mesh, for dbrx's train step and qwen3's serve step; no kernel
    is launched."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    D.start_fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for arch, kind in (("dbrx-132b", "train"), ("qwen3-1.7b", "decode")):
            cfg = get_config(arch).reduced()
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8))
            shape = M.ShapeSpec(kind, 64, 4, kind)
            before = dict(ops.LAUNCHES)
            card = D.trace_cell(cfg, shape, mesh, "cuda")
            assert dict(ops.LAUNCHES) == before
            plain = D.trace_cell(cfg, shape, mesh, "cpu")
            for key in ("cost", "collectives", "memory", "ops"):
                assert card[key] == plain[key], (arch, key)
    finally:
        dist.destroy_process_group()
