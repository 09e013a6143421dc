"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch wikikv-router \\
        --steps 200 --batch 8 --seq 128

Trains on the card (``--device cuda``, the default) through the port's
backward kernels, or on the CPU with ``--device cpu`` (the plain
versions; ``--reduced`` for a CPU-sized config).  Every text model
trains on the reference's text pipeline: the attention families, MoE
configs included (``--arch dbrx-132b --reduced --device cpu``; on the card
the router's gradient is the ``moe_router_bwd`` kernel), jamba and xlstm
(``--arch jamba-v0.1-52b --reduced --device cpu``).  An encoder-decoder
or a vision stub is refused: the text pipeline carries no ``frames`` or
``prefix_embeds``, and the reference's launcher, which never passes
them, cannot run them either (``make_train_step`` trains them given
such batches).

``--mesh host|single|multi`` runs the sharded step on a ``DeviceMesh``
over the ranks of a ``torch.distributed`` process group (NCCL on the
card, gloo on the CPU).  Under ``torchrun`` the group comes from its
environment; run alone, ``--mesh host`` starts a group of one rank at a
free ``tcp://localhost`` port:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --reduced --mesh host --steps 4

``host`` puts every rank on the "data" axis (the reference's
``make_host_mesh``); ``single`` and ``multi`` are the
production (16, 16) and (2, 16, 16) meshes, which raise unless the group
has 256 or 512 ranks.  Without ``--mesh`` the step is unmeshed.
"""
from __future__ import annotations

import argparse
import os
import socket

from repro_torch.configs import get_config
from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


def build_pipeline(vocab: int, seq_len: int, global_batch: int,
                   seed: int = 0):
    docs, _ = generate_authtrace(AuthTraceConfig(n_docs=200, seed=seed))
    tok = HashTokenizer(vocab_size=vocab).fit([d["text"] for d in docs])
    token_docs = [tok.encode(d["text"]) for d in docs]
    return DataPipeline(token_docs, seq_len=seq_len,
                        global_batch=global_batch, seed=seed), tok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="wikikv-router")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None, choices=["host", "single", "multi"],
                    help="the sharded step on a mesh over torch.distributed")
    ap.add_argument("--checkpoint-dir", default="checkpoints/train")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--opt-dtype", default="float32")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the launcher's text pipeline gives tokens and labels only; an "
            "encoder-decoder needs batch['frames'] and a vision stub batch['prefix_embeds'] "
            "(train it through models.model.make_train_step with such batches)")

    mesh = _mesh(args, device) if args.mesh else None
    pipeline, _ = build_pipeline(cfg.vocab, args.seq, args.batch)
    loop = TrainLoop(
        cfg,
        AdamWConfig(lr=3e-4, state_dtype=args.opt_dtype),
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_every=args.checkpoint_every,
                        checkpoint_dir=args.checkpoint_dir),
        pipeline, device=device, mesh=mesh)
    metrics = loop.run()
    print(f"final loss {metrics.losses[-1]:.4f} "
          f"(first {metrics.losses[0]:.4f}) over {len(metrics.losses)} steps")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return metrics


def _mesh(args, device):
    """The process group (torchrun's, or one rank at a free localhost
    port) and the mesh ``--mesh`` names."""
    import torch
    import torch.distributed as dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    if args.mesh == "host":
        return make_host_mesh(dist.get_world_size(), 1)
    return make_production_mesh(multi_pod=args.mesh == "multi")


if __name__ == "__main__":
    main()
