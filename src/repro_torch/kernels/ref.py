"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in ordinary tensor
operations; the CPU path of ``ops`` runs them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  Counterparts of
``repro/kernels/ref.py``'s ``attention_ref``, ``chunked_attention_ref``,
``rmsnorm_ref``, ``decode_attention_ref``, ``moe_router_ref``,
``path_lookup_ref``, ``path_lookup_pinned_ref`` and ``prefix_search_ref``.
The JAX package has no backward kernel (``jax.value_and_grad``
differentiates its jnp references); the port's backward kernels are held
against ``attention_bwd_ref``, ``rmsnorm_bwd_ref`` and
``moe_router_bwd_ref``, explicit formulas of the same gradients.  The
float math is f32, or f64 for f64 inputs (``torch.autograd.gradcheck``).

Digest tables hold one int64 per key, ``((hi << 32) | lo) ^ (1 << 63)``:
torch has no ordering on uint32, and flipping the sign bit makes the
signed int64 order equal the unsigned digest order.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the finite mask value of the reference kernels


def _acc(t: torch.Tensor) -> torch.Tensor:
    """The compute type of the plain versions: f64 stays f64, else f32."""
    return t if t.dtype == torch.float64 else t.float()


def _causal_mask(Sq: int, Skv: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: query i (at position i + Skv - Sq) sees key j <= it."""
    q_pos = torch.arange(Sq, device=device) + (Skv - Sq)
    return q_pos[:, None] >= torch.arange(Skv, device=device)[None, :]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: float | None = None,
                  return_lse: bool = False):
    """Full softmax attention with GQA (query head h reads KV head
    h // group).  q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  The queries
    are the last Sq positions of the Skv context.  Scores in f32 times the
    scale, the finite -1e30 mask; returns (B, Hq, Sq, D) in q.dtype, and
    with ``return_lse`` also the rows' log-sum-exp of the scaled scores
    (B, Hq, Sq) in f32, which the backward reads."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    kf = _acc(k).repeat_interleave(group, dim=1)
    vf = _acc(v).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), kf) * scale
    if causal:
        mask = _causal_mask(Sq, Skv, q.device)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).to(torch.promote_types(s.dtype, torch.float32))
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                      sm_scale: float | None = None):
    """The gradients (dq, dk, dv) of ``attention_ref`` given its output
    ``o``, its ``lse`` and the output's gradient ``do``, as the backward
    kernel computes them: P = exp(s * scale - lse) with masked keys at 0,
    delta = rowsum(do * o), dS = P * (do v^T - delta), dq = scale * dS k,
    dk = scale * dS^T q and dv = P^T do, the group's query heads summed
    into their KV head.  Each gradient in its input's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf, dof = _acc(q), _acc(do)
    kf = _acc(k).repeat_interleave(group, dim=1)
    vf = _acc(v).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    if causal:
        p = torch.where(_causal_mask(Sq, Skv, q.device)[None, None], p, torch.zeros_like(p))
    delta = (dof * _acc(o)).sum(dim=-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, group, Skv, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Skv, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, sm_scale: float | None = None,
                          chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` positions
    (peak memory O(Sq * chunk)), as the JAX twin computes it: q is scaled
    in q.dtype first, the queries fold to (B, Hkv, G, Sq, D) against the
    un-repeated chunk, products accumulate in f32 and p is cast to q.dtype
    before the P.V product.  Skv must be a multiple of the chunk."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    c = min(chunk, Skv)
    if Skv % c:
        raise ValueError(f"chunked_attention_ref: Skv={Skv} is not a multiple of {c}")
    seq_off = Skv - Sq
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, Hkv, group, Sq, D).float()
    q_pos = torch.arange(Sq, device=q.device) + seq_off
    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, group, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, group, Sq, D), dtype=torch.float32, device=q.device)
    for ci in range(Skv // c):
        kb = k[:, :, ci * c:(ci + 1) * c].float()
        vb = v[:, :, ci * c:(ci + 1) * c].float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kb)
        if causal:
            k_pos = ci * c + torch.arange(c, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p.to(q.dtype).float(), vb)
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor | None,
                eps: float = 1e-6) -> torch.Tensor:
    xf = _acc(x)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if scale is not None:
        y = y * _acc(scale)
    return y.to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor | None, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradients (dx, dscale) of ``rmsnorm_ref`` given the output's
    gradient ``dy``: with r = rsqrt(mean(x^2) + eps) and g = dy * scale,
    dx = r * (g - x * r^2 * mean(g * x)) and dscale = sum over rows of
    dy * x * r; dx in x's dtype, dscale in the scale's (None without a
    scale)."""
    xf, dyf = _acc(x), _acc(dy)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    g = dyf * _acc(scale) if scale is not None else dyf
    dx = r * (g - xf * (r * r) * (g * xf).mean(dim=-1, keepdim=True))
    dscale = None
    if scale is not None:
        dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0).to(scale.dtype)
    return dx.to(x.dtype), dscale


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Single-token GQA decode attention against a padded KV cache.

    q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,).  Returns
    (B, Hq, D) in q.dtype.  Follows the kernel rather than the JAX
    reference's jnp form: the scale multiplies the f32 scores (the JAX
    reference scales q in q.dtype first), positions at or past the length
    are masked, and an all-masked row gives zeros (l == 0 -> 1)."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, group, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = pos[None, None, None, :] < lengths.to(torch.int64)[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    out = out / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(B, Hq, D).to(q.dtype)


def moe_router_ref(logits: torch.Tensor, k: int, *,
                   renormalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused softmax + top-k gate.  logits: (T, E).  Returns (weights
    (T, k) f32, indices (T, k) int32).

    As the Pallas kernel computes it: in f32, the softmax as
    ``exp(x - max) / sum``, then k rounds that take the largest remaining
    probability, ties to the lowest expert id (the first match, as
    ``lax.top_k`` orders them; PyTorch's top-k promises no order among
    ties), and mask it.  Selection is on the probabilities, not the
    logits.  With ``renormalize`` the k weights are divided by their sum.
    The ids are chosen on detached probabilities and the weights gathered
    at them, so autograd's gradient reaches the chosen probabilities
    alone, as ``jax.lax.top_k``'s does (an arg-max's would split among
    ties)."""
    x = _acc(logits)
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    E = p.shape[-1]
    cols = torch.arange(E, device=p.device)
    left, ids = p.detach(), []
    for _ in range(k):
        best = left.amax(dim=-1)
        idx = torch.where(left == best[..., None], cols, E).amin(dim=-1)
        ids.append(idx)
        left = left.masked_fill(cols == idx[..., None], NEG_INF)
    idx = torch.stack(ids, dim=-1)
    w = p.gather(-1, idx)
    if renormalize:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, idx.to(torch.int32)


def moe_router_bwd_ref(logits: torch.Tensor | None, weights: torch.Tensor, idx: torch.Tensor,
                       dweights: torch.Tensor, *, renormalize: bool = True,
                       n_experts: int | None = None) -> torch.Tensor:
    """The gradient (T, E) of ``moe_router_ref``'s logits given the
    weights' gradient ``dweights`` (T, k), from the maths, not from
    autograd; the ids (the forward's, so ties stay as it broke them)
    carry no gradient.  With g = dweights and K a row's chosen ids:

    * ``renormalize``: the weights are the softmax of the chosen logits
      alone, so dz_j = w_j (g_j - sum_K w_i g_i) on K and 0 elsewhere.
      Only the shape of ``logits`` is read; it may be None, with
      ``n_experts`` giving E.
    * without it: p = softmax(logits) recomputed, and
      dz_j = p_j ([j in K] g_j - sum_K p_i g_i) for every j."""
    g = _acc(dweights)
    ids = idx.long()
    E = logits.shape[-1] if logits is not None else n_experts
    if renormalize:
        w = _acc(weights)
        s = (w * g).sum(dim=-1, keepdim=True)
        dz = torch.zeros(g.shape[:-1] + (E,), dtype=g.dtype, device=g.device)
        return dz.scatter_(-1, ids, w * (g - s))
    x = _acc(logits)
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    pk = p.gather(-1, ids)
    s = (pk * g).sum(dim=-1, keepdim=True)
    return (-p * s).scatter_(-1, ids, pk * (g - s))


def path_lookup_ref(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Batched GET over the sorted int64 digest table: the position of each
    query (lower bound) or -1, as int32.  A vectorized binary search,
    ceil(log2 N) + 1 steps for the whole batch."""
    n = keys.shape[0]
    if n == 0:
        return torch.full(queries.shape, -1, dtype=torch.int32, device=queries.device)
    lo = torch.zeros(queries.shape, dtype=torch.int64, device=queries.device)
    hi = torch.full(queries.shape, n, dtype=torch.int64, device=queries.device)
    for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 1):
        mid = (lo + hi) // 2
        lt = keys[mid.clamp(0, n - 1)] < queries
        lo = torch.where(lt, mid + 1, lo)
        hi = torch.where(lt, hi, mid)
    idx = lo.clamp(0, n - 1)
    hit = keys[idx] == queries
    return torch.where(hit, idx, torch.full_like(idx, -1)).to(torch.int32)


def path_lookup_pinned_ref(keys: torch.Tensor, queries: torch.Tensor,
                           pin_keys: torch.Tensor, pin_pos: torch.Tensor
                           ) -> torch.Tensor:
    """A query equal to a pinned key resolves to its staged position; the
    rest fall through to the binary search."""
    base = path_lookup_ref(keys, queries)
    eq = pin_keys[None, :] == queries[:, None]
    hit = eq.any(dim=1)
    pos = torch.where(eq, pin_pos[None, :].to(torch.int64),
                      torch.zeros((), dtype=torch.int64, device=eq.device)).sum(dim=1)
    return torch.where(hit, pos.to(torch.int32), base)


def prefix_search_one_ref(tokens: torch.Tensor, prefix: torch.Tensor,
                          prefix_len: torch.Tensor) -> torch.Tensor:
    """Bitmap of rows whose packed path starts with ``prefix`` (segment-
    aware).  tokens: (N, L) uint8; prefix: (L,) uint8; prefix_len: 0-d."""
    L = tokens.shape[1]
    pos = torch.arange(L, device=tokens.device)
    plen = prefix_len.to(torch.int64)
    within = pos < plen
    starts = ((tokens == prefix[None, :]) | ~within[None, :]).all(dim=1)
    nxt = tokens[:, plen.clamp(max=L - 1)]
    last = prefix[(plen - 1).clamp(min=0, max=L - 1)]
    boundary_ok = (last == ord("/")) | (nxt == 0) | (nxt == ord("/"))
    return starts & (boundary_ok | (plen >= L))


def prefix_search_ref(tokens: torch.Tensor, prefixes: torch.Tensor,
                      prefix_lens: torch.Tensor) -> torch.Tensor:
    """(N, L) x (Q, L) x (Q,) -> (N, Q) bool, one prefix at a time."""
    if prefixes.shape[0] == 0:
        return torch.zeros((tokens.shape[0], 0), dtype=torch.bool, device=tokens.device)
    cols = [prefix_search_one_ref(tokens, prefixes[i], prefix_lens[i])
            for i in range(prefixes.shape[0])]
    return torch.stack(cols, dim=1)
