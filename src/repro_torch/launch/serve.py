"""Serving launcher: build a wiki from a corpus, bring up the engine,
answer a query batch (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --queries 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --queries 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --reduced \
        --device cpu --queries 2

The LM and the device tier run on ``cuda`` unless ``--device`` says
otherwise.  Every family but the encoder-decoder serves, the recurrent
ones (jamba's mamba slots, xlstm's mLSTM and sLSTM) included; a config
wider than 512 is served reduced, as the reference does, and
``--reduced`` asks for that whatever the width.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core.cache import TieredCache
from repro_torch.core.engine import DeviceEngine
from repro_torch.core.oracle import HeuristicOracle
from repro_torch.core.pipeline import ConstructionPipeline, PipelineConfig
from repro_torch.data.corpus import AuthTraceConfig, generate_authtrace
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.runtime.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="wikikv-router")
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (CPU-sized) config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    docs, questions = generate_authtrace(
        AuthTraceConfig(n_docs=60, n_questions=max(args.queries, 8),
                        seed=args.seed))
    oracle = HeuristicOracle()
    pipe = ConstructionPipeline(PipelineConfig(), oracle)
    pipe.bootstrap(docs)
    for i in range(0, len(docs), 16):
        pipe.ingest(docs[i:i + 16])

    cfg = get_config(args.arch)
    if args.reduced or cfg.d_model > 512:
        cfg = cfg.reduced()
    tok = HashTokenizer(vocab_size=cfg.vocab).fit([d["text"] for d in docs])
    params = M.init_params(cfg, seed=args.seed, device=device)
    cache = TieredCache(pipe.store, bus=pipe.bus)
    cache.prewarm()
    engine = ServingEngine(cfg, params, tok,
                           DeviceEngine.from_store(pipe.store, device=device),
                           oracle, cache=cache, batch_size=args.batch_size,
                           max_len=256, device=device)
    reqs = [Request(rid=q.qid, query=q.text, max_new_tokens=8)
            for q in questions[: args.queries]]
    done = engine.run(reqs)
    for r in done:
        print(f"[{r.rid}] tool_calls={r.trace.tool_calls} "
              f"pages={r.trace.pages_read} nav={r.latency_s*1000:.1f}ms")
        print(f"    Q: {r.query}")
        print(f"    A: {r.answer[:160]}")
    print(f"cache hit-rate: {cache.stats.hit_rate():.2f}")
    return done


if __name__ == "__main__":
    main()
