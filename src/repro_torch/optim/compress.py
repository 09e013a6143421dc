"""Error-feedback int8 gradient compression for the data-parallel reduce
(port of ``repro/optim/compress.py``).

Each gradient leaf, plus the residual carried from the previous step, is
flattened, padded to blocks of 256 and quantised to int8 with one f32
absmax scale a block; the new residual is what the quantisation lost, so
the compression stays unbiased over steps.  Nothing calls it yet: the
reduce it serves comes with the distribution slice.
"""
from __future__ import annotations

import torch

from ..tree import map_like

_BLOCK = 256


def _quant_leaf(g: torch.Tensor, r: torch.Tensor | None):
    gf = g.float()
    if r is not None:
        gf = gf + r
    n = gf.numel()
    flat = gf.reshape(-1)
    pad = (-n) % _BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)[:, None]).to(torch.int8)
    deq = (q.float() * scale[:, None]).reshape(-1)[:n].reshape(g.shape)
    return {"q": q, "scale": scale, "shape": tuple(g.shape)}, gf - deq


def compress_grads(grads, residuals=None):
    """Returns (compressed tree, new residuals tree); a compressed leaf is
    ``{"q": (blocks, 256) int8, "scale": (blocks,) f32, "shape": tuple}``."""
    if residuals is None:
        pairs = map_like(lambda g: _quant_leaf(g, None), grads)
    else:
        pairs = map_like(_quant_leaf, grads, residuals)
    return (map_like(lambda _, p: p[0], grads, pairs),
            map_like(lambda _, p: p[1], grads, pairs))


def decompress_grads(comp):
    """The f32 gradients of a compressed tree."""
    if isinstance(comp, dict) and "q" in comp:
        n = 1
        for d in comp["shape"]:
            n *= d
        flat = (comp["q"].float() * comp["scale"][:, None]).reshape(-1)
        return flat[:n].reshape(comp["shape"])
    if isinstance(comp, dict):
        return {k: decompress_grads(v) for k, v in comp.items()}
    return type(comp)(decompress_grads(v) for v in comp)
