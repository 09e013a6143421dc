"""The port's DeviceEngine (on the CPU, through the plain versions of its
kernels) against the JAX DeviceEngine and the HostEngine: the same store
built through the same write protocol gives equal Q1/Q2/Q3/Q4/Q4C
answers, before and after patch and rebuild refreshes; a held epoch view
survives the swap; the port's construction pipeline builds the same
AuthTrace wiki as the JAX package's."""
import random

import pytest

torch = pytest.importorskip("torch")

from repro.core import records as JR  # noqa: E402
from repro.core.consistency import InvalidationBus as JBus  # noqa: E402
from repro.core.consistency import WikiWriter as JWriter  # noqa: E402
from repro.core.engine import BatchPlanner as JPlanner  # noqa: E402
from repro.core.engine import DeviceEngine as JDevice  # noqa: E402
from repro.core.engine import HostEngine as JHost  # noqa: E402
from repro.core.engine import ShardedPathStore as JSharded  # noqa: E402
from repro.core.oracle import HeuristicOracle as JOracle  # noqa: E402
from repro.core.pipeline import ConstructionPipeline as JPipe  # noqa: E402
from repro.core.pipeline import PipelineConfig as JPipeCfg  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core.consistency import InvalidationBus, WikiWriter  # noqa: E402
from repro_torch.core.engine import BatchPlanner, DeviceEngine, ShardedPathStore  # noqa: E402
from repro_torch.core.oracle import HeuristicOracle  # noqa: E402
from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig  # noqa: E402
from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace  # noqa: E402


def canon(x):
    """Answers of either package in one comparable form (records become
    their encoded bytes)."""
    if x is None or isinstance(x, (str, int, float)):
        return x
    if hasattr(x, "to_bytes"):
        return x.to_bytes()
    return [canon(v) for v in x]


def _grow(w, Rm, seed):
    """A random protocol-respecting wiki (the test_engine template): the
    same calls with the same seed on either package's writer."""
    rng = random.Random(seed)
    w.ensure_root("root")
    dims = [f"d{i}" for i in range(rng.randint(2, 4))]
    live = []
    for d in dims:
        w.admit(f"/{d}", Rm.DirRecord(name=d, summary=f"dim {d}"))
        for e in range(rng.randint(1, 6)):
            path = f"/{d}/ent_{e}_{rng.randint(0, 9)}"
            if rng.random() < 0.3:
                w.admit(path, Rm.DirRecord(name=path.rsplit("/", 1)[1], summary=f"sub {d}"))
                sub = path + f"/sub{rng.randint(0, 3)}"
                w.admit(sub, Rm.FileRecord(name=sub.rsplit("/", 1)[1], text=f"sub {sub}"))
                live += [path, sub]
            elif rng.random() < 0.15:
                next(w.admit_steps(path, Rm.FileRecord(name="orphan", text="o")))
            else:
                w.admit(path, Rm.FileRecord(name=path.rsplit("/", 1)[1],
                                            text=f"text {d} {e} {rng.random():.3f}"))
                live.append(path)
    for path in rng.sample(live, min(2, len(live))):
        w.unlink(path)
        live.remove(path)
    return dims, live


def _queries(dims, live, seed):
    rng = random.Random(seed + 100)
    pool = live + [f"/{d}/nope" for d in dims] + ["/", "/zz/yy"]
    q1 = [rng.choice(pool) for _ in range(24)]
    q2 = ["/"] + ["/" + d for d in dims] + q1[:8]
    q3 = [rng.choice(pool) for _ in range(8)]
    q4 = ["/", "/" + dims[0], "/zz", rng.choice(pool), dims[-1], "/" + "x" * 120]
    q4c = ["ent", "sub", "nothere", dims[0], rng.choice(live).rsplit("/", 1)[1]]
    return q1, q2, q3, q4, q4c


def _answers(eng, qs):
    q1, q2, q3, q4, q4c = qs
    return canon([eng.q1_get(q1), eng.q2_ls(q2), eng.q3_navigate(q3), eng.q4_search(q4),
                  eng.q4_search(q4, limit=3), eng.q4_contains(q4c),
                  eng.q4_contains(q4c, limit=2)])


def _engines(seed, mode="auto"):
    jstore = JSharded(n_shards=3, memtable_limit=64)
    tstore = ShardedPathStore(n_shards=3, memtable_limit=64)
    dims, live = _grow(JWriter(jstore, clock=lambda: 0.0), JR, seed)
    assert (dims, live) == _grow(WikiWriter(tstore, clock=lambda: 0.0), R, seed)
    jdev = JDevice.from_store(jstore, writer=JWriter(jstore, clock=lambda: 1.0, bus=JBus()),
                              refresh_mode=mode)
    tdev = DeviceEngine.from_store(
        tstore, writer=WikiWriter(tstore, clock=lambda: 1.0, bus=InvalidationBus()),
        refresh_mode=mode, device="cpu")
    return JHost(jstore), jdev, tdev, dims, live


def _write_wave(planner, Rm, dims, live, seed):
    rng = random.Random(seed + 7)
    planner.admit(f"/{dims[0]}/fresh_{seed}", Rm.FileRecord(name=f"fresh_{seed}", text="new"))
    planner.admit("/newdim", Rm.DirRecord(name="newdim", summary="added"))
    planner.admit("/newdim/leaf", Rm.FileRecord(name="leaf", text="deep"))
    if live:
        victim = live[rng.randrange(len(live))]
        planner.unlink(victim)
        planner.admit(live[0] if live[0] != victim else f"/{dims[-1]}/x",
                      Rm.FileRecord(name="over", text="overwritten"))
    planner.flush()


@pytest.mark.parametrize("seed", range(4))
def test_device_engine_matches_reference_and_host(seed):
    host, jdev, tdev, dims, live = _engines(seed)
    qs = _queries(dims, live, seed)
    want = _answers(host, qs)
    assert _answers(jdev, qs) == want
    assert _answers(tdev, qs) == want
    assert tdev.stats.calls == jdev.stats.calls


@pytest.mark.parametrize("mode,kind", [("patch", "patch"), ("rebuild", "rebuild"),
                                       ("auto", "patch")])
def test_device_engine_matches_after_refresh(mode, kind):
    host, jdev, tdev, dims, live = _engines(11, mode=mode)
    _write_wave(JPlanner(jdev), JR, dims, list(live), 11)
    _write_wave(BatchPlanner(tdev), R, dims, list(live), 11)
    assert jdev.refresh() == tdev.refresh() == 1
    assert tdev.last_refresh_kind == jdev.last_refresh_kind == kind
    qs = _queries(dims, live + ["/newdim/leaf", f"/{dims[0]}/fresh_11"], 11)
    want = _answers(host, qs)
    assert _answers(jdev, qs) == want
    assert _answers(tdev, qs) == want


def test_held_epoch_view_survives_the_swap():
    host, jdev, tdev, dims, live = _engines(3, mode="patch")
    held = tdev.epoch_view()
    toks_before = held.ptoks.clone()
    keys_before = held.keys.clone()
    qs = _queries(dims, live, 3)
    before = _answers(tdev, qs)
    _write_wave(BatchPlanner(tdev), R, dims, list(live), 3)
    tdev.refresh()
    assert tdev.last_refresh_kind == "patch"
    nxt = tdev.epoch_view()
    assert nxt is not held and nxt.ptoks.data_ptr() != held.ptoks.data_ptr()
    assert torch.equal(held.ptoks, toks_before) and torch.equal(held.keys, keys_before)
    assert _answers(tdev, qs) != before
    tdev._st = held
    try:
        assert _answers(tdev, qs) == before
    finally:
        tdev._st = nxt


def test_port_pipeline_builds_the_reference_wiki(corpus_and_questions):
    docs, questions = corpus_and_questions
    tdocs, tqs = generate_authtrace(AuthTraceConfig(n_docs=64, n_questions=24, seed=7))
    assert tdocs == docs
    assert [(q.qid, q.text) for q in tqs] == [(q.qid, q.text) for q in questions]
    jpipe = JPipe(JPipeCfg(), JOracle())
    tpipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle())
    for pipe, corpus in ((jpipe, docs), (tpipe, tdocs)):
        pipe.writer.clock = lambda: 0.0
        pipe.bootstrap(corpus)
        for i in range(0, len(corpus), 16):
            pipe.ingest(corpus[i:i + 16])
    paths = jpipe.store.all_paths()
    assert tpipe.store.all_paths() == paths and len(paths) > 50
    for p in paths:
        assert R.encode(tpipe.store.get(p)) == JR.encode(jpipe.store.get(p)), p
    # and the device tiers over the two stores answer alike
    jdev = JDevice.from_store(jpipe.store)
    tdev = DeviceEngine.from_store(tpipe.store, device="cpu")
    dims = [p for p in paths if p.count("/") == 1 and p != "/"]
    qs = (paths[:64], ["/"] + dims, paths[::7], ["/"] + dims, ["zhou", "essay", "x"])
    assert _answers(tdev, qs) == _answers(jdev, qs)
