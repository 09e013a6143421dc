"""Training loop: train step + checkpointing + fault tolerance glue (port
of ``repro/runtime/train_loop.py``).

Composes the model's train step (grad + AdamW, the backward kernels on
the card), the resumable data pipeline, the checkpoint manager (async,
atomic) and the straggler policy.  ``run()`` is crash-restartable: on
start it restores the latest checkpoint (params, opt state, data
position) if one exists.  A step is timed up to the read-back of its
loss, as the reference's ``float(aux["loss"])`` ends its step.

With a ``mesh`` (``launch/mesh.py``) each rank holds its shards of the
params and the AdamW state and runs the sharded step on the global
batch, which every rank draws alike from the seeded pipeline; a save
all-gathers the leaves and rank 0 writes them, and a restore gives each
rank its blocks (``checkpoint.restore_elastic``), so a run resumes on a
mesh of another size.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..checkpoint.manager import CheckpointManager, restore_elastic
from ..data.pipeline import DataPipeline
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_init
from ..tree import map_like
from .straggler import StragglerPolicy


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep: int = 3
    async_checkpoint: bool = True
    log_every: int = 10


@dataclass
class TrainMetrics:
    steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


class TrainLoop:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 loop_cfg: TrainLoopConfig, pipeline: DataPipeline,
                 device=None, seed: int = 0, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.loop_cfg = loop_cfg
        self.pipeline = pipeline
        self.ckpt = CheckpointManager(loop_cfg.checkpoint_dir,
                                      keep=loop_cfg.keep)
        self.straggler = StragglerPolicy()
        self.metrics = TrainMetrics()

        self.params = M.init_params(cfg, seed=seed, device=self.device)
        if mesh is None:
            self.opt_state = adamw_init(self.params, opt_cfg)
        else:
            self.params = M.shard_params(self.params, cfg, mesh)
            self.opt_state = adamw_init(self.params, opt_cfg, full=M.abstract_params(cfg))
        self._step = M.make_train_step(cfg, opt_cfg,
                                       total_steps=loop_cfg.total_steps, mesh=mesh)
        self.step_no = 0

    # ------------------------------------------------------------------
    def maybe_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.mesh is None:
            step, tree, pipe = self.ckpt.restore({"params": self.params, "opt": self.opt_state})
        else:
            abstract = M.abstract_params(self.cfg)
            like = {"params": abstract, "opt": adamw_init(abstract, self.opt_cfg)}
            step, tree, pipe = restore_elastic(self.ckpt, like, self.mesh, self._specs())
        self.params, self.opt_state = tree["params"], tree["opt"]
        if pipe is not None:
            self.pipeline.restore(pipe)
        self.step_no = step
        return True

    def _batch(self) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.next_batch().items()}

    def run(self, n_steps: int | None = None) -> TrainMetrics:
        self.maybe_restore()
        target = (self.step_no + n_steps if n_steps is not None
                  else self.loop_cfg.total_steps)
        while self.step_no < target:
            t0 = time.perf_counter()
            batch = self._batch()
            self.params, self.opt_state, aux = self._step(
                self.params, self.opt_state, batch)
            loss = float(aux["loss"])
            dt = time.perf_counter() - t0
            self.straggler.observe(dt)
            self.step_no += 1
            self.metrics.steps.append(self.step_no)
            self.metrics.losses.append(loss)
            self.metrics.step_times.append(dt)
            if self.step_no % self.loop_cfg.checkpoint_every == 0:
                self.save()
            if self.step_no % self.loop_cfg.log_every == 0:
                print(f"step {self.step_no:5d} loss {loss:.4f} "
                      f"({dt*1000:.0f} ms)", flush=True)
        self.ckpt.wait()
        return self.metrics

    def _specs(self) -> dict:
        specs = M.spec_tree(self.cfg)
        return {"params": specs, "opt": M.opt_spec_tree(specs, self.opt_cfg, self.cfg)}

    def save(self) -> None:
        tree = {"params": self.params, "opt": self.opt_state}
        if self.mesh is not None:
            import torch.distributed as dist

            from ..distributed.sharding import gather
            tree = map_like(lambda t, s: gather(t, s, self.mesh), tree, self._specs())
            if dist.get_rank() != 0:
                return
        self.ckpt.save(self.step_no, tree,
                       pipeline_state=self.pipeline.snapshot(),
                       blocking=not self.loop_cfg.async_checkpoint)
