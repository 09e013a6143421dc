"""Move parameters from the JAX package into the port.

``params_from_jax(tree)`` takes the JAX parameter pytree (dicts and lists
whose leaves are numpy arrays, or any array type numpy can read; stacked
per period on axis 0 as ``repro/models/transformer.py::_stack_periods``
builds them) and returns the same tree of torch tensors.  Weights keep
the JAX (d_in, d_out) layout, so ``x @ W`` is the same product in both
packages.  This module imports nothing of JAX: the caller converts.
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
        return torch.from_numpy(np.array(t)).to(dev)
    return conv(tree)
