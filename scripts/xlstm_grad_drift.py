#!/usr/bin/env python3
"""How far reduced xlstm-350m's f32 gradients drift, and why (CPU only).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_grad_drift.py [S]

On the reduced xlstm-350m (16 layers, d_model 64) with parameters from
JAX's ``init_params`` and a batch of B = 2 sequences of S tokens (24 by
default), prints, each relative to a gradient leaf's largest entry and
maxed over the leaves: the JAX package's f32 gradients against the
port's, each of the two against the port's code run in float64, and the
port's own f32 gradients moved by 1e-7 perturbations of the embedding
table (four seeded draws: the witness of its sensitivity that
tests/test_torch_train_xlstm.py measures).  A drift of the JAX-port distance
to the witness's order, with each block alone within 3e-5
(tests/test_torch_ssm.py), is amplification by the random layers, not a
fault.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import xlstm as X
from repro_torch.tree import leaves, map_like


def worst(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max()
                     / np.abs(np.asarray(y, np.float64)).max()) for x, y in zip(a, b))


def port_grads_f64(params, batch, cfg):
    """The port's own code in float64: every ``.float()`` cast and the
    xLSTM state inits widened for the call."""
    cfg64 = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
    saved = torch.Tensor.float, X.mlstm_state_init_raw, X.slstm_state_init
    torch.Tensor.float = lambda self: self.double()
    X.mlstm_state_init_raw = lambda *a: tuple(t.double() for t in saved[1](*a))
    X.slstm_state_init = lambda *a: tuple(t.double() for t in saved[2](*a))
    try:
        return M.loss_and_grads(map_like(lambda t: t.double(), params), batch, cfg64)[1]
    finally:
        torch.Tensor.float, X.mlstm_state_init_raw, X.slstm_state_init = saved


def main(argv) -> int:
    S = int(argv[0]) if argv else 24
    cfg_j, cfg = jget_config("xlstm-350m").reduced(), get_config("xlstm-350m").reduced()
    jparams = JM.init_params(cfg_j, seed=1)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rs = np.random.RandomState(2)
    toks = rs.randint(0, cfg.vocab, size=(2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    jb = {"tokens": jax.numpy.asarray(toks), "labels": jax.numpy.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jg = [np.asarray(x) for x in jax.tree.leaves(
        jax.grad(lambda p: JT.loss_fn(p, jb, cfg_j))(jparams))]
    tg = [g.numpy() for g in leaves(M.loss_and_grads(params, tb, cfg)[1])]
    g64 = [g.numpy() for g in leaves(port_grads_f64(params, tb, cfg))]
    witness = []
    for i in range(4):
        noise = np.random.RandomState(100 + i).randn(*params["embed"].shape).astype(np.float32)
        moved = dict(params, embed=params["embed"] * (1 + 1e-7 * torch.from_numpy(noise)))
        witness.append(worst([g.numpy() for g in leaves(M.loss_and_grads(moved, tb, cfg)[1])],
                             tg))
    print(json.dumps({"seq": S, "jax_vs_port": worst(tg, jg), "jax_f32_vs_port_f64": worst(jg, g64),
                      "port_f32_vs_port_f64": worst(tg, g64), "witness_draws_1e-7": witness}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
