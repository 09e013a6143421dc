"""Checkpoint save/restore (port of ``repro/checkpoint/manager.py``).

The on-disk layout is the reference's, so a checkpoint written by either
package restores in the other:

    <root>/step_<N>/
        meta.json            — step, tree structure, leaf count, shapes, dtypes
        data.npz             — the leaves as leaf_0, leaf_1, ... in
                               ``jax.tree.flatten`` order (dict keys sorted)
        pipeline.json        — data-pipeline position (epoch/index/seed)

* Atomicity: a save is written to ``step_N.tmp`` and committed with
  ``os.replace``, so a crash mid-save never corrupts the latest
  checkpoint.
* Retention: the ``keep`` newest checkpoints are kept; older ones are
  deleted only after the new save committed.
* Async: ``save(..., blocking=False)`` copies the leaves to the host in
  the caller's thread, then writes them in a worker thread while the
  train loop runs on.
* bfloat16: numpy has no bfloat16, and ``np.savez`` writes the reference's
  ``ml_dtypes`` bfloat16 leaves as their raw 2 bytes (``|V2``).  The port
  writes its bf16 leaves the same way and reads a ``|V2`` leaf back by
  reinterpreting those bytes as bfloat16, so it restores bf16 checkpoints
  of either package (the reference's own restore cannot:
  ``np.asarray(a, dtype=bfloat16)`` has no cast from ``|V2``).

* Elastic restore: leaves are stored whole, so ``restore_elastic`` puts a
  checkpoint onto a mesh of any rank count, each rank reading its block
  of every leaf by the leaf's spec (``models.model.spec_tree``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..tree import leaves, map_like, unflatten


def _to_host(t) -> np.ndarray:
    """A leaf as the numpy array ``data.npz`` holds: a bf16 tensor as its
    raw 2-byte values (``|V2``), as ``np.savez`` writes the reference's."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().to("cpu", copy=True)     # a host copy the caller cannot change
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _treedef(tree) -> str:
    """A readable structure string for meta.json (restore does not read it)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(t) for t in tree) + "]"
    return "*"


def _from_host(a: np.ndarray, like) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on its device."""
    a = np.ascontiguousarray(a).reshape(a.shape)    # (ascontiguousarray makes 0-d 1-d)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # raw bfloat16 bytes
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    # a fresh allocation, not numpy's buffer: a CPU matmul's rounding can
    # depend on its operands' alignment, and a resumed run must repeat the
    # uninterrupted one bit for bit
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype, copy=True)
    return t.clone()


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, pipeline_state: dict | None = None,
             blocking: bool = True) -> Path:
        self.wait()
        host_leaves = [_to_host(x) for x in leaves(tree)]
        treedef = _treedef(tree)
        if blocking:
            return self._write(step, host_leaves, treedef, pipeline_state)
        out = self.root / f"step_{step}"

        def work():
            try:
                self._write(step, host_leaves, treedef, pipeline_state)
            except BaseException as exc:    # re-raised by wait() in the caller
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return out

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint save failed") from err

    def _write(self, step, host_leaves, treedef, pipeline_state) -> Path:
        final = self.root / f"step_{step}"
        tmp = self.root / f"step_{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "data.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        meta = {
            "step": step,
            "treedef": treedef,
            "n_leaves": len(host_leaves),
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": ["bfloat16" if a.dtype.kind == "V" else str(a.dtype) for a in host_leaves],
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        if pipeline_state is not None:
            (tmp / "pipeline.json").write_text(json.dumps(pipeline_state))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: int | None = None) -> tuple[int, object, dict | None]:
        """Restore into the structure of ``like_tree``: each leaf takes
        the dtype and device of the leaf it replaces."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step}"
        with np.load(d / "data.npz") as data:
            stored = [data[f"leaf_{i}"] for i in range(len(data.files))]
        like_leaves = leaves(like_tree)
        if len(like_leaves) != len(stored):
            raise ValueError(
                f"checkpoint has {len(stored)} leaves, tree expects {len(like_leaves)}")
        for i, (a, like) in enumerate(zip(stored, like_leaves)):
            if isinstance(like, torch.Tensor) and tuple(a.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {i} has shape {a.shape}, the tree "
                                 f"expects {tuple(like.shape)}")
        tree = unflatten(like_tree, [_from_host(a, like) for a, like in zip(stored, like_leaves)])
        pipeline = None
        pf = d / "pipeline.json"
        if pf.exists():
            pipeline = json.loads(pf.read_text())
        return step, tree, pipeline


class _Spec:
    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = spec


def restore_elastic(manager: CheckpointManager, like_tree, mesh, pspecs,
                    step: int | None = None) -> tuple[int, object, dict | None]:
    """Elastic restore: ``(step, tree, pipeline)`` with each leaf of the
    checkpoint cut to this rank's block on ``mesh`` (a ``DeviceMesh`` of
    any size: leaves are stored whole) by its spec in ``pspecs``, a tree
    like ``like_tree`` with a tuple of mesh axes at each leaf
    (``spec_tree``, ``opt_spec_tree``).  ``like_tree`` gives the
    structure and dtypes (``meta`` tensors will do: ``abstract_params``);
    the blocks land on the mesh's device.  A rank outside the mesh
    raises."""
    from ..distributed.sharding import require_process_group, shard_slices
    require_process_group()
    if mesh.get_coordinate() is None:
        raise RuntimeError("restore_elastic: this rank is not in the mesh")
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    step = step if step is not None else manager.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {manager.root}")
    d = manager.root / f"step_{step}"
    like_leaves = leaves(like_tree)
    # each spec boxed, so that ``leaves`` keeps the tuple whole, in leaf order
    spec_leaves = [b.spec for b in leaves(map_like(lambda _, s: _Spec(s), like_tree, pspecs))]
    out = []
    with np.load(d / "data.npz") as data:
        if len(data.files) != len(like_leaves):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, tree expects "
                             f"{len(like_leaves)}")
        for i, (like, spec) in enumerate(zip(like_leaves, spec_leaves)):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {i} has shape {a.shape}, the tree "
                                 f"expects {tuple(like.shape)}")
            block = a[shard_slices(a.shape, spec, mesh)]
            out.append(_from_host(block, torch.empty((), dtype=like.dtype, device=device)))
    pipeline = None
    pf = d / "pipeline.json"
    if pf.exists():
        pipeline = json.loads(pf.read_text())
    return step, unflatten(like_tree, out), pipeline
