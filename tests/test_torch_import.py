"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, calls no library kernel in place of its own, adds no new
``REPRO_*`` names, and its entry points never fall back to the CPU.  The
JAX-free modules it keeps as copies equal the reference's text once the
absolute ``repro`` imports are repointed."""
import ast
import difflib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
#: modules the port keeps as copies of the reference's: the host tier,
#: obs, the durable storage tier, the data pipeline, the HLO walker, the
#: straggler policy and the model configurations
COPIED = (
    [f"core/{m}.py" for m in ("cache", "coldstart", "consistency", "errorbook", "evolution",
                              "executor", "navigate", "oracle", "paths", "pipeline",
                              "records", "schema", "store")]
    + ["data/corpus.py", "data/pipeline.py", "data/tokenizer.py", "launch/hlo_walk.py",
       "models/config.py", "runtime/straggler.py"]
    + [f"obs/{m}.py" for m in ("__init__", "metrics", "trace")]
    + [f"storage/{m}.py" for m in ("__init__", "failpoints", "lsm", "manifest", "sstable",
                                   "wal")]
    + sorted(str(p.relative_to(REF)) for p in (REF / "configs").glob("*.py")))
# library calls that would stand in for the port's own kernels
BANNED = ("scaled_dot_product_attention", "torch.compile", "F.rms_norm",
          "functional.rms_norm", "torch.searchsorted", "torch.topk")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
    return mods


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'n': len(names), 'jax': [m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.')], 'repro': [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 64
    assert res["jax"] == [] and res["repro"] == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_reference_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def _repointed(path: Path) -> list[str]:
    """The reference file's lines with its absolute ``repro`` imports
    (statements and ``importlib.import_module`` names) pointed at
    ``repro_torch``."""
    text = path.read_text(encoding="utf-8")
    text = re.sub(r"^(\s*)(from|import) repro\b", r"\1\2 repro_torch", text, flags=re.M)
    text = re.sub(r"import_module\((f?[\"'])repro\.", r"import_module(\1repro_torch.", text)
    return text.splitlines()


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_reference(rel):
    assert (PKG / rel).read_text(encoding="utf-8").splitlines() == _repointed(REF / rel)


def test_backends_differ_from_the_reference_only_in_device_lines():
    """``core/backends.py`` is a copy whose device backend takes the torch
    device: every hunk that differs from the reference names the device."""
    ref = _repointed(REF / "core" / "backends.py")
    port = (PKG / "core" / "backends.py").read_text(encoding="utf-8").splitlines()
    hunks = [(ref[i1:i2], port[j1:j2]) for tag, i1, i2, j1, j2 in
             difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes()
             if tag != "equal"]
    assert hunks, "the device backend takes no device"
    for old, new in hunks:
        assert "device" in "\n".join(old + new), (old, new)


def test_port_calls_no_library_kernel():
    for path in sorted(PKG.rglob("*.py")):
        text = path.read_text(encoding="utf-8")
        for name in BANNED:
            assert name not in text, f"{path.relative_to(ROOT)} mentions {name}"


def test_port_adds_no_new_repro_env_names():
    env = re.compile(r"\bREPRO_[A-Z][A-Z0-9_]*\b")
    ref = set()
    for path in (ROOT / "src" / "repro").rglob("*.py"):
        ref |= set(env.findall(path.read_text(encoding="utf-8")))
    port = set()
    for path in PKG.rglob("*.py"):
        port |= set(env.findall(path.read_text(encoding="utf-8")))
    assert port <= ref, sorted(port - ref)


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import (decode_attention, flash_attention, moe_router,
                                     path_lookup, prefix_search, rmsnorm)
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        path_lookup.path_lookup(keys, keys)
    with pytest.raises(ValueError):
        prefix_search.prefix_search(torch.zeros((2, 96), dtype=torch.uint8),
                                    torch.zeros((1, 96), dtype=torch.uint8),
                                    torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm(torch.ones(2, 8))
    with pytest.raises(ValueError):
        decode_attention.decode_attention(torch.ones(1, 2, 16), torch.ones(1, 1, 4, 16),
                                          torch.ones(1, 1, 4, 16),
                                          torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(torch.ones(1, 2, 4, 16), torch.ones(1, 1, 4, 16),
                                        torch.ones(1, 1, 4, 16))
    with pytest.raises(ValueError):
        moe_router.moe_router(torch.zeros(4, 16), 4)
    q, kv = torch.ones(1, 2, 4, 16), torch.ones(1, 1, 4, 16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, kv, kv, q, torch.zeros(1, 2, 4), q)
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm_bwd(torch.ones(2, 8), torch.ones(8), torch.ones(2, 8))


def test_entry_points_without_a_device_need_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.core import records as R
    from repro_torch.core.engine import DeviceEngine
    from repro_torch.core.oracle import HeuristicOracle
    from repro_torch.core.store import MemKV, PathStore
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.serving import ServingEngine
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

    store = PathStore(MemKV())
    store.put_record("/", R.DirRecord(name=""))
    cfg = get_config("wikikv-router").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceEngine.from_store(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [[1.0]]})
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, HashTokenizer(vocab_size=cfg.vocab), store,
                      HeuristicOracle())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--queries", "1"])
    pipe = DataPipeline([list(range(4, 100))], seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainLoop(cfg, AdamWConfig(), TrainLoopConfig(checkpoint_dir=str(tmp_path)), pipe)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--checkpoint-dir", str(tmp_path)])
    # an explicit CPU request is honoured
    assert DeviceEngine.from_store(store, device="cpu").device.type == "cpu"
