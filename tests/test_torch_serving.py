"""The whole slice on the CPU: the JAX ServingEngine over the JAX
DeviceEngine against the port's ServingEngine over its own DeviceEngine,
with reduced LM weights bridged from JAX, four requests and one queued
online admit.  Navigation traces, answers (evidence plus greedy
generation), the retired-request order, the admitted record and the
stats schema must be equal."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core.engine import DeviceEngine as JDevice  # noqa: E402
from repro.core.oracle import HeuristicOracle as JOracle  # noqa: E402
from repro.core.pipeline import ConstructionPipeline as JPipe  # noqa: E402
from repro.core.pipeline import PipelineConfig as JPipeCfg  # noqa: E402
from repro.data.tokenizer import HashTokenizer as JTok  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro.runtime.serving import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core.engine import DeviceEngine  # noqa: E402
from repro_torch.core.oracle import HeuristicOracle  # noqa: E402
from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig  # noqa: E402
from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402

ADMIT = "/entities/zz_online"


def _build(pipe, docs):
    pipe.writer.clock = lambda: 0.0
    pipe.bootstrap(docs)
    for i in range(0, len(docs), 16):
        pipe.ingest(docs[i:i + 16])
    return pipe


def _trace(r):
    return (r.rid, r.trace.tool_calls, r.trace.pages_read, r.answer,
            [x.path for x in r.nav_results])


def test_serving_slice_matches_reference(corpus_and_questions):
    docs, questions = corpus_and_questions
    tdocs, tquestions = generate_authtrace(AuthTraceConfig(n_docs=64, n_questions=24, seed=7))
    jpipe = _build(JPipe(JPipeCfg(), JOracle()), docs)
    tpipe = _build(ConstructionPipeline(PipelineConfig(), HeuristicOracle()), tdocs)

    cfg_j = jget_config("wikikv-router").reduced(vocab=500)
    cfg = get_config("wikikv-router").reduced(vocab=500)
    jparams = JM.init_params(cfg_j, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jtok = JTok(vocab_size=cfg.vocab).fit([d["text"] for d in docs])
    ttok = HashTokenizer(vocab_size=cfg.vocab).fit([d["text"] for d in tdocs])

    jeng = JServing(cfg_j, jparams, jtok, JDevice.from_store(jpipe.store), JOracle(),
                    batch_size=2, max_len=128)
    teng = ServingEngine(cfg, params, ttok, DeviceEngine.from_store(tpipe.store, device="cpu"),
                         HeuristicOracle(), batch_size=2, max_len=128, device="cpu")
    jeng.submit_admit(ADMIT, JR.FileRecord(name="zz_online", text="online admit"))
    teng.submit_admit(ADMIT, R.FileRecord(name="zz_online", text="online admit"))
    jdone = jeng.run([JRequest(rid=q.qid, query=q.text, max_new_tokens=6)
                      for q in questions[:4]])
    tdone = teng.run([Request(rid=q.qid, query=q.text, max_new_tokens=6)
                      for q in tquestions[:4]])

    assert len(tdone) == 4
    assert [_trace(r) for r in tdone] == [_trace(r) for r in jdone]
    assert all(r.done and r.answer for r in tdone)
    snap, jsnap = teng.stats_snapshot(), jeng.stats_snapshot()
    assert sorted(snap) == sorted(jsnap)
    assert snap["ops"] == jsnap["ops"]
    # the queued admit went through a planner wave and a refresh
    assert teng.engine.q1_get([ADMIT])[0].text == "online admit"
    assert teng.engine.epoch == jeng.engine.epoch >= 1
