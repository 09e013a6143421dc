"""Move parameters from the JAX package into the port.

``params_from_jax(tree)`` takes the JAX parameter pytree (dicts and lists
whose leaves are numpy arrays, or any array type numpy can read; stacked
per period on axis 0 as ``repro/models/transformer.py::_stack_periods``
builds them) and returns the same tree of torch tensors.  Weights keep
the JAX (d_in, d_out) layout, so ``x @ W`` is the same product in both
packages.  This module imports nothing of JAX: the caller converts.

A bfloat16 leaf arrives as numpy's ``ml_dtypes.bfloat16``, which torch
cannot read; its bits cross as int16 and are reinterpreted as
``torch.bfloat16`` (the same bits, no float round trip).

``opt_state_from_jax(state)`` moves an AdamW state the same way: its
``{"m", "v", "step"}`` layout is the reference's, int8 moments included
(``{"q", "scale"}`` leaves), so the port's ``adamw_update`` continues a
trajectory the JAX package began.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def params_from_jax(tree, device=None):
    """Same tree structure, numpy leaves -> torch tensors on ``device``
    (``cuda`` unless given)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        return _leaf(np.array(t)).to(dev)
    return conv(tree)


def _leaf(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def opt_state_from_jax(state, device=None):
    """The JAX package's ``adamw_init``/``adamw_update`` state (numpy
    leaves) as the port's: the same tree, ``step`` a 0-d int32 tensor,
    int8 moments as ``{"q": int8, "scale": float32}`` tensors, on
    ``device`` (``cuda`` unless given)."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"opt_state_from_jax: keys {sorted(state)}; need m, v and step")
    out = params_from_jax(state, device)
    out["step"] = out["step"].to(torch.int32).reshape(())
    return out
