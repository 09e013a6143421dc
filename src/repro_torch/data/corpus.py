"""Synthetic AUTHTRACE-like corpus generator (DESIGN.md §3).

The real AUTHTRACE [20] is not available offline; this generator
reproduces its *protocol*: thematically dense single-author corpora with
quoted evidence, exact fan-in annotations per question, and the three
fan-in buckets (single-doc / low multi-doc = 2 / high multi-doc ≥ 3).

Every fact is a (subject entity, key, value) triple embedded in exactly
the documents its question's fan-in demands, with the convention that a
fan-in-k question requires the k *shards* of its answer that are spread
across k documents ("the estrangement began in <year>" + "…in <city>" +
"…over <reason>").  Answer correctness is then mechanically checkable:
an answer is correct iff every shard token appears (pack-level AC).

Determinism: everything derives from (seed, author) via hashlib — runs
are byte-stable across processes, which the ablation tables rely on.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field

TOPICS = [
    "relationships", "writing_style", "polemics", "translations",
    "medicine", "education", "politics", "folklore",
]

ENTITIES = {
    "relationships": ["zhou_zuoren", "xu_guangping", "zhu_an", "mentors"],
    "writing_style": ["vernacular", "satire", "essays", "diaries"],
    "polemics": ["chen_xiying", "liang_shiqiu", "critics", "debates"],
    "translations": ["gogol", "verne", "soviet_fiction", "fairy_tales"],
    "medicine": ["sendai", "anatomy", "abandonment", "teachers"],
    "education": ["lectures", "students", "beijing_university", "reform"],
    "politics": ["league", "censorship", "exile", "manifestos"],
    "folklore": ["mountain_spirits", "new_year", "opera", "customs"],
}

_KEYS = ["year", "city", "reason", "outcome", "count", "companion"]
_VALUES = {
    "year": ["1902", "1906", "1918", "1923", "1927", "1930", "1936"],
    "city": ["beijing", "shanghai", "sendai", "tokyo", "guangzhou", "xiamen"],
    "reason": ["estrangement", "illness", "censorship", "poverty", "ideals"],
    "outcome": ["reconciliation", "silence", "publication", "exile", "fame"],
    "count": ["three", "seven", "twelve", "twenty", "forty"],
    "companion": ["brother", "student", "editor", "translator", "publisher"],
}

_FILLER = [
    "The correspondence from this period survives in fragments.",
    "Contemporary readers debated the essay for months.",
    "Several drafts exist with marginal annotations.",
    "The episode is retold differently in later memoirs.",
    "Archival records confirm the sequence of events.",
    "Critics at the time dismissed the piece as minor.",
]


@dataclass
class Question:
    qid: str
    text: str
    fan_in: int
    doc_ids: list[str]
    answer_shards: list[str]   # tokens that must all appear in the answer
    topic: str
    entity: str


@dataclass
class AuthTraceConfig:
    n_docs: int = 120
    n_questions: int = 60
    seed: int = 0
    author: str = "lu_xun"
    noise_docs: int = 8        # low-information docs the filter Φ must drop
    fan_in_mix: tuple = (0.5, 0.3, 0.2)   # single / low / high buckets


def _rng(cfg: AuthTraceConfig, salt: str) -> random.Random:
    h = hashlib.sha256(f"{cfg.seed}:{cfg.author}:{salt}".encode()).digest()
    return random.Random(int.from_bytes(h[:8], "big"))


def generate_authtrace(cfg: AuthTraceConfig) -> tuple[list[dict], list[Question]]:
    """Returns (documents, questions)."""
    rng = _rng(cfg, "docs")
    docs: list[dict] = []
    facts_per_doc: dict[str, list[str]] = {}
    # fact pool: (topic, entity, key, value, parts) — parts spread over docs
    fact_pool = []
    for qi in range(cfg.n_questions):
        r = _rng(cfg, f"q{qi}")
        topic = r.choice(TOPICS)
        entity = r.choice(ENTITIES[topic])
        u = r.random()
        if u < cfg.fan_in_mix[0]:
            fan = 1
        elif u < cfg.fan_in_mix[0] + cfg.fan_in_mix[1]:
            fan = 2
        else:
            fan = r.choice([3, 3, 4])
        keys = r.sample(_KEYS, fan)
        shards = [(k, r.choice(_VALUES[k])) for k in keys]
        fact_pool.append((qi, topic, entity, shards))

    # documents: each carries a handful of fact shards + filler
    for di in range(cfg.n_docs):
        r = _rng(cfg, f"d{di}")
        topic = TOPICS[di % len(TOPICS)]
        entity = r.choice(ENTITIES[topic])
        did = f"{cfg.author}_doc{di:04d}"
        opening = (f"In this essay on {topic.replace('_', ' ')}, the author "
                   f"reflects on {entity.replace('_', ' ')} at length, {di}.")
        body = [opening]
        body.extend(r.sample(_FILLER, 3))
        docs.append({
            "id": did, "title": f"essay_{di:04d}", "topics": [topic],
            "entities": [entity], "text": "", "facts": [],
        })
        facts_per_doc[did] = []

    # place each question's shards into `fan` distinct docs of its topic
    questions: list[Question] = []
    for qi, topic, entity, shards in fact_pool:
        r = _rng(cfg, f"place{qi}")
        topic_docs = [d for d in docs if d["topics"] == [topic]]
        if len(topic_docs) < len(shards):
            topic_docs = docs
        chosen = r.sample(topic_docs, len(shards))
        doc_ids = []
        shard_tokens = []
        for d, (k, v) in zip(chosen, shards):
            line = (f"Regarding {entity.replace('_', ' ')}: the {k} was {v}. "
                    f"fact: q{qi}_{k}={v}.")
            facts_per_doc[d["id"]].append(line)
            d.setdefault("entities", []).append(entity)
            d["facts"].append(f"fact: q{qi}_{k}={v}")
            doc_ids.append(d["id"])
            shard_tokens.append(v)
        keys_str = " and ".join(k for k, _ in shards)
        qtext = (f"What was the {keys_str} of the "
                 f"{entity.replace('_', ' ')} matter?")
        questions.append(Question(
            qid=f"q{qi}", text=qtext, fan_in=len(shards),
            doc_ids=doc_ids, answer_shards=shard_tokens,
            topic=topic, entity=entity))

    # assemble doc text — openings rotate so same-author essays do not
    # trip the template-boilerplate filter (they are genuine originals)
    _OPENINGS = [
        "An essay concerning {t}, where the author turns to {e}.",
        "Notes toward {t}: observations gathered around {e}.",
        "{e} occupies this piece on {t} from beginning to end.",
        "Among the writings on {t}, this one dwells on {e}.",
        "A later reflection on {t}, returning once more to {e}.",
        "From the notebooks: {t}, and above all {e}.",
    ]
    for di, d in enumerate(docs):
        r = _rng(cfg, "asm" + d["id"])
        opening = _OPENINGS[di % len(_OPENINGS)].format(
            t=d["topics"][0].replace("_", " "),
            e=d["entities"][0].replace("_", " "))
        lines = [opening]
        lines.extend(facts_per_doc[d["id"]])
        lines.extend(r.sample(_FILLER, 2 + r.randrange(3)))
        d["text"] = " ".join(lines)
        d["entities"] = sorted(set(d["entities"]))

    # low-information noise (exercises the ingestion filter Φ)
    noise_templates = [
        "Happy new year to all our readers! Best wishes for the spring festival.",
        "Announcing our annual meetup. Save the date! Registration opens soon.",
        "Limited time offer: discount on the collected essays. Buy now!",
        "http://a.example http://b.example http://c.example http://d.example",
        "ok.",
    ]
    r = _rng(cfg, "noise")
    for ni in range(cfg.noise_docs):
        docs.append({
            "id": f"{cfg.author}_noise{ni:03d}",
            "title": f"notice_{ni:03d}", "topics": [], "entities": [],
            "text": noise_templates[ni % len(noise_templates)], "facts": [],
        })
    return docs, questions


def score_answer(answer: str, q: Question) -> float:
    """Pack-level answer correctness: 1.0 iff every shard value appears."""
    low = answer.lower()
    return 1.0 if all(s.lower() in low for s in q.answer_shards) else 0.0


def bucket(q: Question) -> str:
    if q.fan_in == 1:
        return "single"
    if q.fan_in == 2:
        return "low_multi"
    return "high_multi"
