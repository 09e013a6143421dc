"""ModelOracle: a zoo LM standing behind the Oracle interface (port of
``repro/runtime/model_oracle.py``).

Replaces the paper's DeepSeek-V4-Flash with any dense architecture of the
registry.  The lexical fallbacks of HeuristicOracle remain the *semantic*
layer; the LM supplies classification and coverage signals from its
next-token loss:

  classify_query — the regex fast path first (ENUMERATE), then the route
                   whose description has the lowest continuation NLL
                   given the query (LOOKUP or AGGREGATE);
  needs_deeper   — coverage from the NLL of the query conditioned on the
                   page prefix, calibrated by its unconditional NLL;
  everything else delegates to the heuristic layer.

Every NLL is one ``loss_fn`` evaluation (the full-sequence forward, so the
flash-attention kernel once per attention layer on the card).  The tokens
go to the model's device and the host reads one float per NLL.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.oracle import ROUTE_ENUMERATE, HeuristicOracle
from ..data.tokenizer import HashTokenizer
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig


class ModelOracle(HeuristicOracle):
    """``params`` must live on ``device`` (``cuda`` unless given)."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: HashTokenizer,
                 seed: int = 0, device=None):
        super().__init__(seed=seed)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        self._loss = M.make_eval_step(cfg)

    def _nll(self, prefix: str, target: str) -> float:
        ids = self.tok.encode(f"{prefix} {target}")
        tgt_len = len(self.tok.encode(target, add_special=False))
        labels = np.full((len(ids) - 1,), -1, np.int32)
        labels[-tgt_len:] = ids[-tgt_len:]
        batch = {"tokens": torch.tensor([ids[:-1]], dtype=torch.int32, device=self.device),
                 "labels": torch.from_numpy(labels)[None, :].to(self.device)}
        return float(self._loss(self.params, batch))

    def classify_query(self, q):
        self.calls["classify_query"] += 1
        # regex fast path (paper: <5 ms layer) …
        cls = super().classify_query(q)
        if cls == ROUTE_ENUMERATE:
            return cls
        # … then the distilled-classifier path: lowest continuation NLL
        candidates = {
            "LOOKUP": "this asks about one specific page",
            "AGGREGATE": "this asks to combine several pages",
        }
        scores = {k: self._nll(q, v) for k, v in candidates.items()}
        return min(scores, key=scores.get)

    def needs_deeper(self, q, content, theta: float = 0.34) -> bool:
        self.calls["needs_deeper"] += 1
        if not content.strip():
            return True
        # coverage ∝ −NLL(query | page prefix); calibrate against the
        # unconditional NLL so theta keeps the paper's [0,1] semantics
        cond = self._nll(content[:512], q)
        uncond = self._nll("", q)
        coverage = max(0.0, min(1.0, (uncond - cond) / max(uncond, 1e-6) + 0.5))
        return coverage < theta
