"""The port's CheckpointManager: the reference's tests (round trip,
retention and atomicity, async) on torch trees, and checkpoints crossing
the packages: one written by the JAX ``CheckpointManager`` (an AdamW
state with int8 moments, bf16 parameters) restores in the port bit for
bit, and an f32 one written by the port restores in the JAX package.
The reference cannot restore a bf16 leaf at all; a test documents that
fault, with ``src/repro`` left as it is.  Leaves are compared exactly:
a checkpoint stores values, it computes nothing."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro.optim.adamw import adamw_update as j_adamw_update  # noqa: E402
from repro_torch.bridge import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _tree(x=1.0):
    return {"a": torch.full((4, 3), x), "b": {"c": torch.arange(5.0)}}


def test_checkpoint_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    cm.save(10, _tree(1.0))
    cm.save(20, _tree(2.0))
    step, tree, _ = cm.restore(_tree())
    assert step == 20 and float(tree["a"][0, 0]) == 2.0
    step, tree, _ = cm.restore(_tree(), step=10)
    assert float(tree["a"][0, 0]) == 1.0
    assert torch.equal(tree["b"]["c"], torch.arange(5.0))


def test_checkpoint_retention_and_atomicity(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(float(s)))
    assert cm.all_steps() == [3, 4]
    assert not list(tmp_path.glob("*.tmp"))     # no torn saves left behind
    # a torn save (a crash between the write and the commit) is not a checkpoint
    (tmp_path / "step_9.tmp").mkdir()
    assert cm.latest_step() == 4
    assert float(cm.restore(_tree())[1]["a"][0, 0]) == 4.0


def test_checkpoint_async(tmp_path):
    cm = CheckpointManager(tmp_path, keep=3)
    tree = _tree(5.0)
    cm.save(5, tree, pipeline_state={"epoch": 1, "index": 2, "seed": 3}, blocking=False)
    tree["a"].fill_(7.0)            # the leaves were copied before save returned
    cm.wait()
    assert cm.latest_step() == 5
    step, restored, pipe = cm.restore(_tree())
    assert float(restored["a"][0, 0]) == 5.0 and pipe == {"epoch": 1, "index": 2, "seed": 3}


def test_restore_refuses_a_tree_of_another_shape(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        cm.restore({"a": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="shape"):
        cm.restore({"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5)}})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_tree())


def _jax_state(state_dtype, param_dtype):
    """A reduced qwen3's parameters in ``param_dtype`` and an AdamW state
    with ``state_dtype`` moments after two updates, from the JAX package."""
    cfg = jget_config("qwen3-1.7b").reduced(d_model=128, n_layers=2, d_ff=512,
                                           param_dtype=param_dtype)
    params = JM.init_params(cfg, seed=0)
    opt_cfg = JAdamWConfig(lr=1e-2, state_dtype=state_dtype)
    opt = j_adamw_init(params, opt_cfg)
    for i in range(2):
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01 * (i + 1), p.dtype), params)
        params, opt = j_adamw_update(params, grads, opt, opt_cfg)
    return cfg, params, opt


@pytest.mark.parametrize("state_dtype,param_dtype", [("int8", "bfloat16"), ("float32", "float32"),
                                                     ("bfloat16", "bfloat16")])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, state_dtype, param_dtype):
    cfg_j, jparams, jopt = _jax_state(state_dtype, param_dtype)
    JCheckpointManager(tmp_path).save(7, {"params": jparams, "opt": jopt},
                                      pipeline_state={"epoch": 0, "index": 7, "seed": 0})
    # the port's like-tree: its own init at the same config, the same layout
    cfg = get_config("qwen3-1.7b").reduced(d_model=128, n_layers=2, d_ff=512,
                                          param_dtype=param_dtype)
    params = M.init_params(cfg, device="cpu")
    opt = adamw_init(params, AdamWConfig(state_dtype=state_dtype))
    step, tree, pipe = CheckpointManager(tmp_path).restore({"params": params, "opt": opt})
    assert step == 7 and pipe["index"] == 7
    want = {"params": params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"),
            "opt": opt_state_from_jax(jax.tree.map(np.asarray, jopt), device="cpu")}
    got_leaves, want_leaves = leaves(tree), leaves(want)
    assert len(got_leaves) == len(jax.tree.leaves({"params": jparams, "opt": jopt}))
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    if state_dtype == "int8":
        assert tree["opt"]["m"]["body"]["slot0"]["mlp"]["w_up"]["q"].dtype == torch.int8
    if param_dtype == "bfloat16":
        assert tree["params"]["embed"].dtype == torch.bfloat16
        meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
        assert "bfloat16" in meta["dtypes"]


def test_a_port_checkpoint_restores_in_jax(tmp_path):
    cfg = get_config("wikikv-router").reduced()
    params = M.init_params(cfg, seed=2, device="cpu")
    opt = adamw_init(params, AdamWConfig())
    CheckpointManager(tmp_path).save(3, {"params": params, "opt": opt},
                                     pipeline_state={"epoch": 1, "index": 0, "seed": 0})
    cfg_j = jget_config("wikikv-router").reduced()
    jparams = JM.init_params(cfg_j, seed=0)
    jlike = {"params": jparams, "opt": j_adamw_init(jparams, JAdamWConfig())}
    step, jtree, pipe = JCheckpointManager(tmp_path).restore(jlike)
    assert step == 3 and pipe == {"epoch": 1, "index": 0, "seed": 0}
    mine = leaves({"params": params, "opt": opt})
    theirs = jax.tree.leaves(jtree)
    assert len(mine) == len(theirs)
    for t, j in zip(mine, theirs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    meta = json.loads((tmp_path / "step_3" / "meta.json").read_text())
    jmeta_keys = {"step", "treedef", "n_leaves", "shapes", "dtypes"}
    assert set(meta) == jmeta_keys and meta["n_leaves"] == len(mine)


def test_a_port_bf16_checkpoint_is_written_as_the_reference_writes_it(tmp_path):
    """Both packages store a bf16 leaf as its 2 raw bytes (``|V2``), with
    the same bits and the same meta.json entry."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    JCheckpointManager(tmp_path / "j").save(1, {"w": jnp.asarray(x, jnp.bfloat16)})
    CheckpointManager(tmp_path / "t").save(1, {"w": torch.from_numpy(x).to(torch.bfloat16)})
    j = np.load(tmp_path / "j" / "step_1" / "data.npz")["leaf_0"]
    t = np.load(tmp_path / "t" / "step_1" / "data.npz")["leaf_0"]
    assert j.dtype == t.dtype and j.dtype.kind == "V" and j.tobytes() == t.tobytes()
    for d in ("j", "t"):
        meta = json.loads((tmp_path / d / "step_1" / "meta.json").read_text())
        assert meta["dtypes"] == ["bfloat16"] and meta["shapes"] == [[3, 4]]
    _, tree, _ = CheckpointManager(tmp_path / "j").restore(
        {"w": torch.zeros(3, 4, dtype=torch.bfloat16)})
    assert torch.equal(tree["w"], torch.from_numpy(x).to(torch.bfloat16))


def test_reference_cannot_restore_a_bf16_leaf(tmp_path):
    """A fault of the reference, documented (ROADMAP §3): np.savez keeps an
    ml_dtypes bfloat16 leaf as raw ``|V2`` bytes and the reference's
    restore casts it with ``np.asarray(a, dtype=bfloat16)``, which has no
    cast from ``|V2``.  The port restores the same checkpoint."""
    like = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    jcm = JCheckpointManager(tmp_path)
    jcm.save(1, like)
    with pytest.raises(ValueError, match="No cast function"):
        jcm.restore(like)
    _, tree, _ = CheckpointManager(tmp_path).restore({"w": torch.zeros(2, 3, dtype=torch.bfloat16)})
    assert torch.equal(tree["w"], torch.ones(2, 3, dtype=torch.bfloat16))
