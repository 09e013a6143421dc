"""The port's shape, FLOP and sharding helpers against the JAX package's,
for every config of the zoo.

``abstract_params`` (meta tensors) against ``jax.eval_shape`` of the init,
leaf for leaf in shape and dtype; ``spec_tree`` against the reference's
``PartitionSpec`` tree; ``input_specs`` and ``model_flops`` for every
``SHAPES`` entry; ``abstract_decode_state`` and ``decode_state_specs``;
``opt_spec_tree`` with int8 moments.  The port's active-parameter count
follows the reference's docstring ("top_k + shared experts") where the
reference's code also scales the shared expert by top_k / n_experts, so
the two differ by exactly

    port active - reference active = shared-expert params * (1 - top_k / n_experts)

(kimi-k2: 33.70 B against 31.11 B), and nothing else.
"""
import functools
import time

import jax
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import all_arch_ids, get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = all_arch_ids()


@functools.lru_cache(maxsize=None)
def _ref(arch):
    cfg = jget_config(arch)
    return JM.abstract_params(cfg), JM.spec_tree(cfg)


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, P))


def _flat_specs(guide, specs) -> list:
    """The spec at each leaf of ``guide`` (dicts, lists and tuples), in
    ``jax.tree.flatten`` order; the specs are tuples themselves."""
    if isinstance(guide, dict):
        return [x for k in sorted(guide) for x in _flat_specs(guide[k], specs[k])]
    if isinstance(guide, (list, tuple)):
        return [x for g, s in zip(guide, specs) for x in _flat_specs(g, s)]
    return [specs]


def _same_shapes(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        assert t.device.type == "meta"


def _shared_params(cfg) -> float:
    tree = M.abstract_params(cfg)
    return float(sum(t.numel() for slot in tree["body"].values() if "moe" in slot
                     and "shared" in slot["moe"] for t in leaves(slot["moe"]["shared"])))


def test_shapes_table_is_the_reference_s():
    assert {k: vars(v) for k, v in M.SHAPES.items()} == \
        {k: vars(v) for k, v in JM.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_spec_tree_match_the_reference(arch):
    jab, jspec = _ref(arch)
    cfg = get_config(arch)
    tab = M.abstract_params(cfg)
    _same_shapes(jab, tab)
    want = [tuple(s) for s in _jax_leaves(jspec)]
    got = _flat_specs(tab, M.spec_tree(cfg))
    assert got == want
    # every leaf's spec names each mesh axis at most once, and only axes
    # the meshes have
    for s in got:
        named = [e for e in s if e is not None]
        assert len(named) == len(set(named)) and set(named) <= {"data", "model"}


#: the reference's active-parameter count, once per config: its
#: ``model_flops`` traces the whole init twice a call
_ref_active = functools.lru_cache(maxsize=None)(JM._active_params)
_port_active = functools.lru_cache(maxsize=None)(M._active_params)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(JM.SHAPES))
def test_input_specs_and_model_flops_match_the_reference(arch, shape, monkeypatch):
    monkeypatch.setattr(JM, "_active_params", _ref_active)
    monkeypatch.setattr(M, "_active_params", _port_active)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jin, tin = JM.input_specs(jcfg, JM.SHAPES[shape]), M.input_specs(cfg, M.SHAPES[shape])
    assert list(tin) == list(jin)
    for k in jin:
        assert tuple(tin[k].shape) == tuple(jin[k].shape)
        assert str(tin[k].dtype).removeprefix("torch.") == str(jin[k].dtype)
        assert tin[k].device.type == "meta"
    ref = JM.model_flops(jcfg, JM.SHAPES[shape])
    shared = 0.0
    if cfg.moe is not None:
        shared = _shared_params(cfg) * (1.0 - cfg.moe.top_k / cfg.moe.n_experts)
    tokens = M.model_flops(cfg, M.SHAPES[shape]) / M._active_params(cfg)
    assert M.model_flops(cfg, M.SHAPES[shape]) == pytest.approx(ref + tokens * shared,
                                                                rel=1e-12)
    if cfg.moe is None or cfg.moe.n_shared == 0:
        assert M.model_flops(cfg, M.SHAPES[shape]) == pytest.approx(ref, rel=1e-12)


def test_kimi_active_params_count_the_shared_expert_in_full():
    cfg = get_config("kimi-k2-1t-a32b")
    port, ref = _port_active(cfg), _ref_active(jget_config("kimi-k2-1t-a32b"))
    assert port == pytest.approx(33.70e9, rel=1e-3) and ref == pytest.approx(31.11e9, rel=1e-3)
    assert port - ref == pytest.approx(_shared_params(cfg) * (1 - 8 / 384), rel=1e-9)
    assert 25e9 < ref < port < 40e9      # tests/test_models.py's band holds both


def test_abstract_params_allocate_nothing_for_a_trillion_parameters():
    t0 = time.perf_counter()
    tree = M.abstract_params(get_config("kimi-k2-1t-a32b"))
    assert time.perf_counter() - t0 < 10.0
    flat = leaves(tree)
    assert all(t.device.type == "meta" for t in flat)
    assert sum(t.numel() for t in flat) > 1.0e12


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_and_its_specs_match_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    _same_shapes(JM.abstract_decode_state(jcfg, 4, 64), M.abstract_decode_state(cfg, 4, 64))
    state = M.abstract_decode_state(cfg, 4, 64)
    for batch, kw in ((128, {}), (1, {}), (4, {"dp_size": 2, "cache_layout": "seq"}),
                      (32, {"dp": ("pod", "data"), "cache_layout": "head_dim"}),
                      (16, {"cache_layout": "kv_head", "tp_size": 4})):
        want = [tuple(s) for s in _jax_leaves(JM.decode_state_specs(jcfg, batch, **kw))]
        assert _flat_specs(state, M.decode_state_specs(cfg, batch, **kw)) == want


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen3-1.7b", "jamba-v0.1-52b"])
def test_int8_opt_spec_tree_matches_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jab, jspec = _ref(arch)
    for dt in ("int8", "float32"):
        want = JM.opt_spec_tree(jspec, JAdamWConfig(state_dtype=dt), jcfg, abstract=jab)
        got = M.opt_spec_tree(M.spec_tree(cfg), AdamWConfig(state_dtype=dt), cfg)
        # an int8 moment's {"q", "scale"} specs sit where the param's was
        want_m = [tuple(s) for s in _jax_leaves(want["m"])]
        flat = []

        def walk(t):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k])
            elif isinstance(t, list):
                for v in t:
                    walk(v)
            else:
                flat.append(tuple(t))
        walk(got["m"])
        assert flat == want_m and got["step"] == tuple(want["step"])
        assert got["m"] == got["v"]
        if dt == "int8":
            assert any(isinstance(v, dict) for v in leaves_of_dicts(got["m"]))


def leaves_of_dicts(tree):
    """Every dict in ``tree`` whose values are all spec tuples."""
    if isinstance(tree, dict):
        if tree and all(isinstance(v, tuple) for v in tree.values()):
            yield tree
        for v in tree.values():
            yield from leaves_of_dicts(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves_of_dicts(v)
