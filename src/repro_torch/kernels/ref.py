"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, in ordinary tensor
operations; the CPU path of ``ops`` runs them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.  Counterparts of
``repro/kernels/ref.py``'s ``rmsnorm_ref``, ``decode_attention_ref``,
``path_lookup_ref``, ``path_lookup_pinned_ref`` and ``prefix_search_ref``.

Digest tables hold one int64 per key, ``((hi << 32) | lo) ^ (1 << 63)``:
torch has no ordering on uint32, and flipping the sign bit makes the
signed int64 order equal the unsigned digest order.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # the finite mask value of the reference kernels


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor | None,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


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
