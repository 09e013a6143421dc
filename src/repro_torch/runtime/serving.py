"""Serving engine: continuous-batching decode over the WikiKV substrate.

Port of ``repro/runtime/serving.py``.  The online tier, composed
end-to-end: request → NAV(q,B) over the (tensorized) wiki → evidence →
generation through the LM's decode loop (continuous batching: new
requests join the batch at any step, finished ones retire and free their
slot).

Storage operations batch exactly like tokens do: every admitted request
runs its navigation as a *session generator* against the shared
``BatchPlanner``, and ``step()`` drains ONE planner batch per decode
step — enqueue writes, advance sessions, flush, refresh, finish — then
every decoding lane advances one token.  The storage substrate is a host
``PathStore``/``ShardedPathStore`` or a device ``QueryEngine``
(``core.engine.DeviceEngine``) whose Q1–Q4 run in the port's kernels.

The decode tokens and lengths live on the model's device; the host reads
them once per step.  The KV cache is updated in place.  ``snapshot()``
commits a durable store and ``reopen_store`` reopens its directory in a
later process with the same epoch.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import torch

from .. import obs
from ..core.cache import TieredCache
from ..core.engine import BatchPlanner, HostEngine, QueryEngine
from ..core.navigate import Navigator, UnitBudget
from ..core.oracle import Oracle
from ..data.tokenizer import EOS, HashTokenizer
from ..device import resolve_device
from ..models import model as M
from ..models import transformer as T
from ..models.config import ModelConfig


@dataclass
class Request:
    rid: str
    query: str
    budget_units: int = 400
    max_new_tokens: int = 32
    # filled by the engine:
    answer: str = ""
    nav_results: list = field(default_factory=list)
    trace: object = None
    latency_s: float = 0.0
    done: bool = False


class ServingEngine:
    """Slots-based continuous batching: ``batch_size`` decode lanes; each
    lane holds one active request.  A lane's lifecycle is
    navigating → decoding → retired: while navigating, the lane's session
    contributes storage ops to the per-step planner batch; once its
    navigation completes it prefills and joins token decoding.

    ``device`` places the LM (``cuda`` unless given); ``params`` must
    already live there (``models.model.init_params(..., device=...)`` or
    ``bridge.params_from_jax``).

    Every family but the encoder-decoder is served, the recurrent ones
    (mamba, mLSTM, sLSTM) included.  The port's prefill differs from the
    reference's loop, which steps every lane through the decode path for
    each prompt token and never resets the prefilled lane: a recurrent
    lane would start from the previous request's state, and every other
    lane's state would advance once per prompt token (an attention lane is
    unharmed: its cache is masked by length and the same position is
    rewritten).  Here ``_prefill`` first writes the lane's initial state
    (``transformer.reset_lanes``) and each prompt token's step passes a
    ``write`` mask of that lane alone; a decode step passes the decoding
    lanes.  A recurrent state outside the mask keeps its value; KV caches
    keep the reference's rule (every lane writes at its own length, and
    its next real step rewrites that position).  So a request served in a
    batch gets the tokens it gets served alone, which is what the
    reference gives at ``batch_size=1`` with a fresh engine per request.

    With MoE slots that holds while no expert can overflow its capacity.
    Under ``moe._capacity`` an expert takes at least 4 tokens a step, and
    a token takes at most one slot of an expert, so at ``batch_size`` <= 4
    nothing is ever dropped; above 4 another lane's token may take the
    slot, exactly as in the reference.

    An encoder-decoder is refused: a request carries text only, so there
    is no audio to encode into the decoder's ``enc_out`` (the reference's
    ``_prefill`` and ``step`` never pass one, and its decoder runs
    without its encoder).  internvl2 is served as the reference serves
    it: text only."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: HashTokenizer,
                 store, oracle: Oracle,
                 cache: TieredCache | None = None,
                 batch_size: int = 4, max_len: int = 512,
                 write_batch: int = 8, device=None):
        self.device = resolve_device(device)
        if cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.name}: ServingEngine does not serve an encoder-decoder: a request "
                "carries no audio, so there is no encoder output (enc_out) for its decoder")
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        if isinstance(store, QueryEngine):
            self.engine = store
        else:
            self.engine = HostEngine(store)
        self.planner = BatchPlanner(self.engine)
        self.nav = Navigator(self.planner, oracle, cache=cache)
        self.oracle = oracle
        self.batch_size = batch_size
        self.max_len = max_len
        # online write path: queued admissions/unlinks drain into the
        # planner at most ``write_batch`` per decode step, so writes batch
        # at token cadence and never starve the read wave
        self.write_batch = write_batch
        self._write_q: deque[tuple[str, str, object]] = deque()
        self._serve = M.make_serve_step(cfg)
        self.state = T.init_decode_state(cfg, batch_size, max_len, self.device)
        self.lengths = torch.zeros((batch_size,), dtype=torch.int32, device=self.device)
        self.tokens = torch.zeros((batch_size,), dtype=torch.int32, device=self.device)
        self.slots: list[Optional[Request]] = [None] * batch_size
        self._remaining = [0] * batch_size
        self._gen: list[list[int]] = [[] for _ in range(batch_size)]
        # storage phase state per lane: (session generator, t0) or None
        self._nav: list = [None] * batch_size
        self._decoding = [False] * batch_size
        # the decoding lanes as a (B,) bool on the device, rebuilt after a
        # change of _decoding; row i of the identity is lane i alone
        self._write: Optional[torch.Tensor] = None
        self._lane = torch.eye(batch_size, dtype=torch.bool, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit a request into a free lane.  Navigation starts on the
        next ``step()``; the lane joins decoding when its session ends."""
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                self._nav[i] = (self.nav.session(req.query,
                                                 UnitBudget(req.budget_units)),
                                time.perf_counter())
                self._set_decoding(i, False)
                # correlation id: the most recently admitted session (the
                # ctx is global; per-lane attribution rides span args)
                obs.set_context(session=req.rid)
                return True
        return False

    # ------------------------------------------------------------------
    def _finish_nav(self, slot: int, value, t0: float) -> None:
        """Session ended: score evidence, prefill the lane, arm decode."""
        req = self.slots[slot]
        results, trace = value
        req.nav_results = results
        req.trace = trace
        req.latency_s = time.perf_counter() - t0
        # fold the request's navigation latency into the shared histogram
        # (stats_snapshot percentiles; trace off ⇒ no-op)
        obs.histogram("serving.request_nav_ms").record(req.latency_s * 1e3)
        obs.counter("serving.requests_nav_done").inc()
        evidence = [r.text for r in results if r.text]
        req.answer = self.oracle.answer(req.query, evidence)
        self._prefill(slot, req)

    def _prefill(self, slot: int, req: Request) -> None:
        """Prefill the lane with the evidence-conditioned prompt."""
        prompt = f"question: {req.query} evidence: {req.answer}"
        ids = self.tok.encode(prompt)[: self.max_len - req.max_new_tokens - 1]
        # sequential prefill through the decode path from the lane's
        # initial state: only this lane's recurrent states take the steps
        # (every lane writes its cache at its own length, and only this
        # lane's length advances)
        T.reset_lanes(self.state, self.cfg, [slot])
        write = self._lane[slot]
        self.lengths[slot] = 0
        for t in ids:
            toks = self.tokens.clone()
            toks[slot] = t
            _, _, self.state = self._serve(
                self.params, self.state,
                {"tokens": toks, "lengths": self.lengths, "write": write})
            self.lengths[slot] += 1
        self.tokens[slot] = int(ids[-1]) if ids else 1
        self._remaining[slot] = req.max_new_tokens
        self._gen[slot] = []
        self._set_decoding(slot, True)

    def _set_decoding(self, slot: int, on: bool) -> None:
        if self._decoding[slot] != on:
            self._decoding[slot] = on
            self._write = None

    # ------------------------------------------------------------------
    # online writes: enqueue now, ride the next step's planner wave
    # ------------------------------------------------------------------
    def submit_admit(self, path: str, rec) -> None:
        """Queue a §IV-C admission; applied ≤ write_batch per step."""
        self._write_q.append(("admit", path, rec))

    def submit_unlink(self, path: str) -> None:
        """Queue a reverse-order unlink; applied ≤ write_batch per step."""
        self._write_q.append(("unlink", path, None))

    def pending_writes(self) -> int:
        return len(self._write_q) + self.planner.pending_writes()

    def _enqueue_write_batch(self) -> None:
        """Move one write batch from the queue into the planner so it
        executes in this step's flush (after the step's reads — the wave
        ordering that keeps reads pinned to the step-start epoch)."""
        for _ in range(min(self.write_batch, len(self._write_q))):
            kind, path, rec = self._write_q.popleft()
            if kind == "admit":
                self.planner.admit(path, rec)
            else:
                self.planner.unlink(path)

    # ------------------------------------------------------------------
    def _step_storage(self) -> None:
        """Advance every navigating lane to its next storage dependency,
        then drain ONE planner batch — reads plus one write batch — for
        all of them together.  The closing ``refresh()`` commits this
        step's writes to the read view, so a decode step is one wave:
        epoch staleness is bounded by Δ = 1 step."""
        with obs.span("serving.wave",
                      lanes=sum(1 for s in self._nav if s is not None)):
            self._enqueue_write_batch()
            finished: list[tuple[int, object, float]] = []
            for i, nav_state in enumerate(self._nav):
                if nav_state is None:
                    continue
                gen, t0 = nav_state
                try:
                    next(gen)
                except StopIteration as e:
                    finished.append((i, e.value, t0))
                    self._nav[i] = None
            self.planner.flush()
            self.engine.refresh()
            for slot, value, t0 in finished:
                self._finish_nav(slot, value, t0)
        if obs.enabled():
            # waves the device view lags behind the write log (0 when the
            # refresh cadence is every-wave)
            obs.gauge("serving.epoch_lag").set(
                getattr(self.engine, "_deferred_waves", 0))
            every = obs.stats_every()
            if every and self.planner.flushes % every == 0:
                self._stats_log()

    def step(self) -> list[Request]:
        """One serving step: one storage batch (reads + one write batch)
        + one decode step for every decoding lane; returns retired
        requests."""
        if (not any(s is not None for s in self.slots)
                and not self.pending_writes()):
            return []
        self._step_storage()
        if not any(self._decoding):
            return []
        if self._write is None:
            self._write = torch.tensor(self._decoding, dtype=torch.bool, device=self.device)
        write = self._write
        nxt, _, self.state = self._serve(
            self.params, self.state,
            {"tokens": self.tokens, "lengths": self.lengths, "write": write})
        self.tokens = nxt
        self.lengths += write.int()
        # the one device read of the step: next tokens and lengths together
        nxt_host, len_host = torch.stack([nxt, self.lengths]).cpu().tolist()
        done: list[Request] = []
        for i, req in enumerate(self.slots):
            if req is None or not self._decoding[i]:
                continue
            self._gen[i].append(nxt_host[i])
            self._remaining[i] -= 1
            if (self._remaining[i] <= 0 or nxt_host[i] == EOS
                    or len_host[i] >= self.max_len - 1):
                gen_text = self.tok.decode(self._gen[i])
                # generation refines the evidence answer; the evidence
                # answer itself stays authoritative for AC scoring
                req.answer = (req.answer + " " + gen_text).strip()
                req.done = True
                done.append(req)
                self.slots[i] = None
                self._set_decoding(i, False)
        return done

    # ------------------------------------------------------------------
    # live stats surface
    # ------------------------------------------------------------------
    def stats_snapshot(self) -> dict:
        """JSON-able live telemetry: per-op latency percentiles out of the
        shared histograms, planner queue depth + dedup ratios, refresh
        patch-vs-rebuild accounting, durable bloom/cache rates, and the
        serving write queue.  Top-level keys are the reference's stable
        schema."""
        return obs.build_snapshot(
            self.engine, self.planner,
            extra={"pending_writes": self.pending_writes(),
                   "lanes_active": sum(1 for s in self.slots
                                       if s is not None)})

    def _stats_log(self) -> None:
        """Periodic structured stats line (``REPRO_STATS_EVERY`` waves)."""
        import json
        import logging
        snap = self.stats_snapshot()
        logging.getLogger("repro_torch.serving").info(
            "stats wave=%d %s", snap["waves"], json.dumps(snap))

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Quiesce the write path and commit the durable tier: drain the
        queued write batches through planner waves, refresh (commits the
        epoch), then flush the store so every committed record is in the
        WAL/segments.  After this returns, the store directory can be
        reopened — ``ServingEngine.reopen_store`` — with zero
        re-ingestion and the same epoch.  On a volatile store this is
        just a planner drain (flush/commit no-op)."""
        while self.pending_writes():
            self._enqueue_write_batch()
            self.planner.flush()
            self.engine.refresh(force=True)
        self.planner.flush()
        # force=True overrides a device refresh cadence > 1: the snapshot
        # must observe every drained write, not eventual k-wave visibility
        self.engine.refresh(force=True)
        store = getattr(self.engine, "store", None)
        if store is not None and hasattr(store, "flush"):
            store.flush()
        return {"epoch": self.engine.epoch,
                "paths": store.count() if store is not None else 0}

    @staticmethod
    def reopen_store(root: str, n_shards: int | None = None, **kw):
        """Reopen a durable store directory written by a previous
        process (crash recovery included): recovers manifest + segments,
        replays the WAL's committed waves, and returns a
        ``PathStore``/``ShardedPathStore`` ready to hand to
        ``ServingEngine`` (the engine then restores the committed
        epoch)."""
        from ..storage import open_durable_store
        return open_durable_store(root, n_shards=n_shards, **kw)

    def run(self, requests: list[Request]) -> list[Request]:
        """Drive a queue through the continuous-batching loop; also
        drains any queued online writes before returning, so accepted
        admissions are never silently left uncommitted."""
        pending = list(requests)
        finished: list[Request] = []
        while (pending or any(s is not None for s in self.slots)
                or self.pending_writes()):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            finished.extend(self.step())
        return finished
