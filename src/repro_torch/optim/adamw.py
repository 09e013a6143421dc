"""AdamW with optionally quantized first/second moments (port of
``repro/optim/adamw.py``): functions on tensor trees, not
``torch.optim.AdamW``, so the state has the reference's layout
``{"m", "v", "step"}`` and a checkpoint crosses the packages.

``state_dtype``:

  "float32"  — reference Adam
  "bfloat16" — 2× smaller; update math still in f32
  "int8"     — per-row (last-axis) absmax int8 moments for leaves of at
               least ``_QUANT_MIN`` elements and two axes, the second
               moment stored in the sqrt domain; smaller leaves keep f32.

The update math is f32 whatever the storage, as the reference's is, with
weight decay on every leaf.  Leaves of at least ``scan_update_min``
elements and two or more axes update a block of rows (last-axis vectors,
``scan_update_min / 16`` elements) at a time, bounding the f32 temporaries
to one block; the reference maps over the stacked leaves' leading axis
(``lax.map``), and either way the update is elementwise (per row for
int8), so the numbers are the same.  ``adamw_update`` returns new
tensors and leaves its arguments as they were.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import leaves, map_like

#: leaves smaller than this keep f32 moments (quantization overhead
#: dominates below it)
_QUANT_MIN = 1 << 16


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"   # float32 | bfloat16 | int8
    #: leaves bigger than this (elements) update a block of rows at a
    #: time, bounding f32 temp memory
    scan_update_min: int = 1 << 28


def _q_init(x: torch.Tensor) -> dict:
    """Per-row (last-axis) absmax int8: ``q`` keeps the param's shape."""
    return {"q": torch.zeros(x.shape, dtype=torch.int8, device=x.device),
            "scale": torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)}


def _q_quant(val: torch.Tensor, *, root: bool = False, row_max=None) -> dict:
    """``root=True`` stores the moment in the sqrt domain: the update
    consumes ``sqrt(v)``, so quantizing the root bounds the error on the
    quantity actually used.  ``row_max``, where given, takes each row's
    absmax to the whole row's (a sharded step's rows are cut)."""
    vf = val.float()
    if root:
        vf = torch.sqrt(vf)
    amax = vf.abs().amax(dim=-1)
    scale = (amax if row_max is None else row_max(amax)) / 127.0
    q = torch.round(vf / torch.clamp(scale, min=1e-12)[..., None]).to(torch.int8)
    return {"q": q, "scale": scale}


def _q_dequant(st: dict, *, root: bool = False) -> torch.Tensor:
    x = st["q"].float() * st["scale"][..., None]
    return x * x if root else x


def _leaf_quantized(p: torch.Tensor) -> bool:
    return p.numel() >= _QUANT_MIN and p.dim() >= 2


def adamw_init(params, cfg: AdamWConfig, full=None) -> dict:
    """Zero moments like ``params``.  ``full``: a tree like ``params`` of
    the whole leaves (``meta`` tensors will do) when ``params`` are a
    rank's shards, so that a leaf's int8 moments follow the whole leaf's
    size, as the reference's (and the checkpoint's) do."""
    if cfg.state_dtype == "int8":
        def init_leaf(p, whole):
            if _leaf_quantized(whole):
                return _q_init(p)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        m = map_like(init_leaf, params, params if full is None else full)
        v = map_like(init_leaf, params, params if full is None else full)
    else:
        dt = getattr(torch, cfg.state_dtype)
        m = map_like(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
        v = map_like(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}


def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0, row_max=None):
    """Returns (new_params, new_state).  ``lr_scale`` is a float or a 0-d
    float32 tensor (``cosine_schedule``'s).  Update math in f32
    regardless of storage dtype, with the reference's float32 rounding of
    the step's scalars (the bias corrections and the lr).  ``row_max``: a
    tree like ``params`` of None or, for a shard whose rows are cut,
    the function that takes a row's absmax to the whole row's (an int8
    moment's scale; ``models.model.make_train_step`` on a mesh)."""
    with torch.no_grad():
        step = state["step"] + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=t.device)
        state_dt = torch.float32 if cfg.state_dtype == "int8" else getattr(torch, cfg.state_dtype)

        def upd(p, g, m_st, v_st, rmax=None):
            gf = g.float()
            quant = isinstance(m_st, dict)
            if quant:
                m_prev = _q_dequant(m_st)
                v_prev = _q_dequant(v_st, root=True)
            else:
                m_prev = m_st.float()
                v_prev = v_st.float()
            m_new = cfg.b1 * m_prev + (1 - cfg.b1) * gf
            v_new = cfg.b2 * v_prev + (1 - cfg.b2) * gf * gf
            mh = m_new / bc1
            vh = v_new / bc2
            pf = p.float()
            pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf)
            if quant:
                return (pf.to(p.dtype), _q_quant(m_new, row_max=rmax),
                        _q_quant(v_new, root=True, row_max=rmax))
            return pf.to(p.dtype), m_new.to(state_dt), v_new.to(state_dt)

        def upd_leaf(p, g, m, v, rmax=None):
            # update huge leaves a block of rows (last-axis vectors) at a
            # time: bounds the f32 dequant/update temporaries to one block
            # (the reference maps over the leading, period axis; one
            # dbrx layer's expert stacks or its untied embedding, 1.06 B
            # and 0.62 B elements, are single leaves with no such axis)
            if p.dim() < 2 or p.numel() < cfg.scan_update_min:
                return upd(p, g, m, v, rmax)
            last = p.shape[-1]
            step_rows = max(1, cfg.scan_update_min // 16 // last)
            new = (torch.empty(p.shape, dtype=p.dtype, device=p.device),
                   _empty_like(m, state_dt), _empty_like(v, state_dt))
            rows = [_rows(t, last) for t in (p, g, m, v)]
            dst = [_rows(t, last) for t in new]
            for r in range(0, p.numel() // last, step_rows):
                part = [_block(t, r, r + step_rows) for t in rows]
                for d, out in zip(dst, upd(*part, rmax)):
                    _put(d, r, r + step_rows, out)
            return new

        if row_max is None:
            out = map_like(upd_leaf, params, grads, state["m"], state["v"])
        else:
            out = map_like(upd_leaf, params, grads, state["m"], state["v"], row_max)
        new_p = map_like(lambda _, o: o[0], params, out)
        new_m = map_like(lambda _, o: o[1], params, out)
        new_v = map_like(lambda _, o: o[2], params, out)
    return new_p, {"m": new_m, "v": new_v, "step": step}


def _rows(st, last: int):
    """A leaf, or a quantized moment's planes, as rows of ``last``
    elements (views of a contiguous tensor)."""
    if isinstance(st, dict):
        return {"q": st["q"].reshape(-1, last), "scale": st["scale"].reshape(-1)}
    return st.reshape(-1, last)


def _block(st, r0: int, r1: int):
    return {k: x[r0:r1] for k, x in st.items()} if isinstance(st, dict) else st[r0:r1]


def _empty_like(st, dtype):
    if isinstance(st, dict):
        return {k: torch.empty(x.shape, dtype=x.dtype, device=x.device) for k, x in st.items()}
    return torch.empty(st.shape, dtype=dtype, device=st.device)


def _put(dst, r0: int, r1: int, part) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k][r0:r1] = part[k]
    else:
        dst[r0:r1] = part
