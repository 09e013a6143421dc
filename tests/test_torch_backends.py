"""The port's Table II backends (``repro_torch.core.backends``): the
reference's agreement test over the port's seven backends, and each port
backend's Q1–Q4 answers equal to the reference backend of the same name
on one seeded wiki (records compared by ``to_bytes()``).  The device
backend runs on ``device="cpu"`` here."""
import random

import pytest

torch = pytest.importorskip("torch")

from repro.core import records as JR  # noqa: E402
from repro.core.backends import ALL_BACKENDS as J_BACKENDS  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core.backends import ALL_BACKENDS, WikiKVDeviceBackend  # noqa: E402


def _make(name):
    """A port backend by name; the device one on the CPU."""
    if name == "wikikv_device":
        return WikiKVDeviceBackend(device="cpu")
    return ALL_BACKENDS[name]()


def _mini_wiki():
    items = [
        ("/", R.DirRecord(name="", sub_dirs=["rel", "style"])),
        ("/rel", R.DirRecord(name="rel", files=["lu_xun", "zhou"])),
        ("/style", R.DirRecord(name="style", files=["satire"])),
        ("/rel/lu_xun", R.FileRecord(name="lu_xun", text="the author")),
        ("/rel/zhou", R.FileRecord(name="zhou", text="the brother")),
        ("/style/satire", R.FileRecord(name="satire", text="sharp prose")),
    ]
    return items


def test_port_has_the_reference_backends():
    assert sorted(ALL_BACKENDS) == sorted(J_BACKENDS)
    assert len(ALL_BACKENDS) == 7


@pytest.mark.parametrize("name", sorted(ALL_BACKENDS))
def test_backends_agree(name):
    be = _make(name)
    try:
        be.load(_mini_wiki())
        rec = be.q1_get("/rel/zhou")
        assert isinstance(rec, R.FileRecord) and rec.text == "the brother"
        assert be.q1_get("/nope") is None
        kids = be.q2_ls("/rel")
        assert sorted(kids) == ["/rel/lu_xun", "/rel/zhou"]
        assert len(be.q3_navigate("/style/satire")) == 3
        hits = be.q4_search("/rel")
        assert set(hits) >= {"/rel", "/rel/lu_xun", "/rel/zhou"}
        assert "/style/satire" not in hits
    finally:
        be.close()


def _seeded_wiki(Rm, seed: int):
    """A protocol-consistent wiki as (path, record) pairs: dimensions,
    topics with files, a few nested directories — the same pairs for
    either package's records module."""
    rng = random.Random(seed)
    items = []
    dims = [f"dim{d}" for d in range(rng.randint(3, 5))]
    items.append(("/", Rm.DirRecord(name="", sub_dirs=dims)))
    leaves = []
    for d in dims:
        topics = [f"topic_{d}_{t}" for t in range(rng.randint(2, 4))]
        items.append((f"/{d}", Rm.DirRecord(name=d, sub_dirs=topics, summary=f"about {d}")))
        for t in topics:
            files = [f"f{k}_{rng.randint(0, 99)}" for k in range(rng.randint(1, 6))]
            items.append((f"/{d}/{t}", Rm.DirRecord(name=t, files=files)))
            for f in files:
                path = f"/{d}/{t}/{f}"
                items.append((path, Rm.FileRecord(name=f, text=f"{t} {f} {rng.random():.4f}")))
                leaves.append(path)
    return items, dims, leaves


def _canon(x):
    if x is None or isinstance(x, (str, int, float)):
        return x
    if hasattr(x, "to_bytes"):
        return x.to_bytes()
    return [_canon(v) for v in x]


def _ask(be, dims, leaves, seed):
    rng = random.Random(seed + 1)
    q1 = rng.sample(leaves, 8) + [f"/{dims[0]}", "/", "/nope", f"/{dims[-1]}/missing"]
    q2 = ["/"] + [f"/{d}" for d in dims] + [leaves[0], "/nope"]
    q3 = rng.sample(leaves, 4) + [f"/{dims[1]}/x/y"]
    q4 = ["/", f"/{dims[0]}", leaves[3].rsplit("/", 1)[0], "/dim", "/nope"]
    return _canon([[be.q1_get(p) for p in q1], [be.q2_ls(p) for p in q2],
                   [be.q3_navigate(p) for p in q3], [sorted(be.q4_search(p)) for p in q4]])


@pytest.mark.parametrize("name", sorted(ALL_BACKENDS))
def test_port_backend_answers_equal_the_reference(name):
    seed = 5
    items, dims, leaves = _seeded_wiki(R, seed)
    j_items, _, _ = _seeded_wiki(JR, seed)
    assert _canon([r for _, r in items]) == _canon([r for _, r in j_items])
    be, ref = _make(name), J_BACKENDS[name]()
    try:
        be.load(items)
        ref.load(j_items)
        got = _ask(be, dims, leaves, seed)
        assert got == _ask(ref, dims, leaves, seed)
        assert any(got[0]) and any(got[3])
    finally:
        be.close()
        ref.close()


def test_device_backend_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        WikiKVDeviceBackend()
    be = WikiKVDeviceBackend(device="cpu")
    be.load(_mini_wiki())
    assert be.engine.device.type == "cpu"
    be.close()
