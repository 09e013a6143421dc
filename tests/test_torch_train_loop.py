"""The training loop and launcher on the CPU: the crash-restart of
``tests/test_checkpoint_runtime.py`` bit for bit, the loss falling with
asynchronous checkpoints, ``launch.train --device cpu --reduced`` (the
router, jamba and xlstm) and the launcher's pipeline equal to the
reference's."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------
def _mini_loop(tmp_path, steps, total=12, seed=0):
    cfg = get_config("wikikv-router").reduced(d_model=32, vocab=256, n_layers=2)
    docs = [list(range(4, 200))] * 4
    pipe = DataPipeline(docs, seq_len=16, global_batch=4, seed=2)
    loop = TrainLoop(cfg, AdamWConfig(lr=1e-3),
                     TrainLoopConfig(total_steps=total, checkpoint_every=4,
                                     checkpoint_dir=str(tmp_path),
                                     async_checkpoint=False, log_every=100),
                     pipe, device="cpu", seed=seed)
    loop.run(n_steps=steps)
    return loop


def test_train_loop_crash_restart(tmp_path):
    """Run 8 steps, 'crash', restart a fresh loop → it resumes from the
    step-8 checkpoint and continues to 12 with identical data order, and
    ends bit for bit where an uninterrupted run ends."""
    l1 = _mini_loop(tmp_path / "a", steps=8)
    assert l1.ckpt.latest_step() == 8
    l2 = _mini_loop(tmp_path / "a", steps=None)   # restores, runs to total
    assert l2.step_no == 12 and len(l2.metrics.losses) == 4
    assert l2.pipeline.state.index == 12 % l2.pipeline.steps_per_epoch or \
        l2.pipeline.state.epoch > 0
    whole = _mini_loop(tmp_path / "b", steps=12)
    assert whole.metrics.losses[8:] == l2.metrics.losses
    for a, b in zip(leaves(l2.params), leaves(whole.params)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(l2.opt_state), leaves(whole.opt_state)):
        assert torch.equal(a, b)


def test_train_loop_loss_falls_and_async_checkpoints(tmp_path):
    cfg = get_config("wikikv-router").reduced(d_model=32, vocab=256, n_layers=2)
    pipe = DataPipeline([list(range(4, 60)) * 3] * 4, seq_len=16, global_batch=4, seed=1)
    loop = TrainLoop(cfg, AdamWConfig(lr=3e-3),
                     TrainLoopConfig(total_steps=10, checkpoint_every=5,
                                     checkpoint_dir=str(tmp_path), log_every=100),
                     pipe, device="cpu")
    m = loop.run()
    assert loop.ckpt.all_steps() == [5, 10]
    assert m.losses[-1] < m.losses[0] and len(m.step_times) == 10
    assert all(t > 0 for t in m.step_times)


def test_launch_train_cpu_reduced(tmp_path, capsys):
    metrics = launch_train.main(["--device", "cpu", "--reduced", "--steps", "3",
                                 "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"])
    assert len(metrics.losses) == 3 and all(math.isfinite(x) for x in metrics.losses)
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "step_2" / "meta.json").exists()


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_launch_train_recurrent_cpu_reduced(arch, tmp_path, capsys):
    """The launcher trains the SSM and xLSTM families on the reference's
    text pipeline, as the reference's launcher does: finite losses, a
    checkpoint."""
    metrics = launch_train.main(["--arch", arch, "--device", "cpu", "--reduced", "--steps", "2",
                                 "--batch", "2", "--seq", "32", "--checkpoint-dir",
                                 str(tmp_path), "--checkpoint-every", "2"])
    assert len(metrics.losses) == 2 and all(math.isfinite(x) for x in metrics.losses)
    assert "final loss" in capsys.readouterr().out
    assert (tmp_path / "step_2" / "meta.json").exists()


def test_build_pipeline_is_the_references():
    from repro.launch.train import build_pipeline as j_build
    pipe, tok = launch_train.build_pipeline(512, seq_len=32, global_batch=4)
    jpipe, jtok = j_build(512, seq_len=32, global_batch=4)
    for _ in range(3):
        a, b = pipe.next_batch(), jpipe.next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
