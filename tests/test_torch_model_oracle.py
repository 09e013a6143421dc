"""The port's ModelOracle against the JAX package's on the same bridged
parameters and the same tokenizer (mirrors tests/test_model_oracle.py):
every NLL within the f32 tolerance of tests/test_kernels.py, every
classify_query / needs_deeper decision equal, and an LM-routed
``Navigator.nav`` over the same wiki with equal traces and results."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.navigate import Navigator as JNavigator  # noqa: E402
from repro.core.navigate import UnitBudget as JUnitBudget  # noqa: E402
from repro.data.tokenizer import HashTokenizer as JTok  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime.model_oracle import ModelOracle as JModelOracle  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.navigate import Navigator, UnitBudget, check_progressive  # noqa: E402
from repro_torch.core.oracle import ROUTE_ENUMERATE, HeuristicOracle  # noqa: E402
from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig  # noqa: E402
from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace  # noqa: E402
from repro_torch.data.tokenizer import HashTokenizer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime.model_oracle import ModelOracle  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)
FIT = ["the quick brown fox jumps over the lazy dog " * 4]


def _oracles(texts=FIT):
    over = dict(d_model=32, vocab=512, n_layers=2)
    cfg_j = jget_config("wikikv-router").reduced(**over)
    cfg = get_config("wikikv-router").reduced(**over)
    jparams = JM.init_params(cfg_j, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jo = JModelOracle(cfg_j, jparams, JTok(vocab_size=cfg.vocab).fit(texts))
    to = ModelOracle(cfg, params, HashTokenizer(vocab_size=cfg.vocab).fit(texts), device="cpu")
    return jo, to


@pytest.fixture(scope="module")
def oracles():
    return _oracles()


@pytest.mark.parametrize("prefix,target", [
    ("the quick brown fox", "jumps over the lazy dog"),
    ("", "tell me about the estrangement"),
    ("a page about foxes " * 20, "where does the fox sleep"),
    ("one", "x"),
])
def test_nll_matches_reference(oracles, prefix, target):
    jo, to = oracles
    ops.reset_launches()
    got = to._nll(prefix, target)
    assert isinstance(got, float) and np.isfinite(got)
    np.testing.assert_allclose(got, jo._nll(prefix, target), **TOL)
    assert ops.LAUNCHES["flash_attention"] == 0        # CPU: the plain version


def test_empty_target_raises_in_both(oracles):
    """tgt_len == 0: ``labels[-0:]`` is the whole label row, one longer
    than the assigned ids, and numpy refuses it in both packages."""
    jo, to = oracles
    with pytest.raises(ValueError):
        jo._nll("some page", "")
    with pytest.raises(ValueError):
        to._nll("some page", "")


@pytest.mark.parametrize("q", [
    "Which dimensions exist?",                     # regex fast path
    "tell me about the estrangement",
    "compare the fox and the dog",
    "where was the lazy dog born",
])
def test_classify_query_matches_reference(oracles, q):
    jo, to = oracles
    got = to.classify_query(q)
    assert got == jo.classify_query(q)
    assert got in (ROUTE_ENUMERATE, "LOOKUP", "AGGREGATE")
    assert to.calls["classify_query"] == jo.calls["classify_query"]


@pytest.mark.parametrize("q,content,theta", [
    ("anything at all", "", 0.34),
    ("where does the quick fox sleep", "the quick brown fox sleeps in a den", 0.34),
    ("who owns the lazy dog", "an unrelated page about turbines and gears", 0.34),
    ("who owns the lazy dog", "the lazy dog is owned by the farmer", 0.6),
])
def test_needs_deeper_matches_reference(oracles, q, content, theta):
    jo, to = oracles
    assert to.needs_deeper(q, content, theta) == jo.needs_deeper(q, content, theta)
    assert to.needs_deeper("anything", "   ") is True


def test_model_oracle_nav_matches_reference(built_wiki):
    pipe, questions = built_wiki
    docs, tquestions = generate_authtrace(AuthTraceConfig(n_docs=64, n_questions=24, seed=7))
    tpipe = ConstructionPipeline(PipelineConfig(), HeuristicOracle())
    tpipe.bootstrap(docs)
    for i in range(0, len(docs), 16):
        tpipe.ingest(docs[i:i + 16])
    jo, to = _oracles(FIT + [d["text"] for d in docs[:8]])
    jnav, tnav = JNavigator(pipe.store, jo), Navigator(tpipe.store, to)
    for jq, tq in list(zip(questions, tquestions))[:4]:
        assert jq.text == tq.text
        jres, jtrace = jnav.nav(jq.text, JUnitBudget(200))
        res, trace = tnav.nav(tq.text, UnitBudget(200))
        assert check_progressive(res)
        assert trace.tool_calls > 0 and trace.llm_calls > 0
        assert dataclasses.asdict(trace) == dataclasses.asdict(jtrace)
        assert [dataclasses.asdict(r) for r in res] == [dataclasses.asdict(r) for r in jres]
    assert to.calls == jo.calls
