"""Straggler mitigation for synchronous data-parallel training.

At pod scale, synchronous SGD waits for the slowest participant.  The
policy here is *deadline-based contribution skipping*: a step has a
deadline D = μ + k·σ over a rolling window of recent step times; a worker
(or microbatch shard) that would exceed the deadline contributes a zero
gradient for the step and the surviving gradients are rescaled by
``world / survivors`` — an unbiased estimator under random stragglers
(the Backup-Workers recipe of Chen et al., adapted to deterministic
deadlines instead of replica redundancy).

This module is deliberately *host-side logic over measurements* (the
decision layer); the gradient rescale itself is one multiply inside the
train step.  Tests drive it with synthetic timing traces; the real-signal
integration point is ``TrainLoop.step()``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class StragglerPolicy:
    window: int = 50
    k_sigma: float = 3.0
    min_survivors_frac: float = 0.75
    _times: deque = field(default_factory=lambda: deque(maxlen=50))
    skipped_total: int = 0

    def observe(self, step_time_s: float) -> None:
        self._times.append(step_time_s)

    def deadline(self) -> float | None:
        if len(self._times) < max(8, self._times.maxlen // 5):
            return None
        xs = list(self._times)
        mu = sum(xs) / len(xs)
        var = sum((x - mu) ** 2 for x in xs) / len(xs)
        return mu + self.k_sigma * (var ** 0.5)

    def decide(self, worker_times: list[float]) -> tuple[list[bool], float]:
        """Given per-worker projected step times, return (keep mask,
        gradient rescale).  Never drops below min_survivors_frac — beyond
        that the step must wait (correctness over latency)."""
        d = self.deadline()
        n = len(worker_times)
        if d is None:
            return [True] * n, 1.0
        keep = [t <= d for t in worker_times]
        survivors = sum(keep)
        min_surv = max(int(n * self.min_survivors_frac), 1)
        if survivors < min_surv:
            # keep the fastest min_surv workers instead
            order = sorted(range(n), key=lambda i: worker_times[i])
            keep = [False] * n
            for i in order[:min_surv]:
                keep[i] = True
            survivors = min_surv
        self.skipped_total += n - survivors
        return keep, n / survivors
