"""The port's tensor index against the JAX package's: for the same store
and the same delta sequence, ``logical_state``, ``batched_get``,
``search_prefix`` and ``navigate_rows`` agree in patch, rebuild and auto
modes (template: tests/test_tensorstore.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.core import paths as JP  # noqa: E402
from repro.core import records as JR  # noqa: E402
from repro.core import tensorstore as JTS  # noqa: E402
from repro.core.store import DictKV as JDictKV, PathStore as JPathStore  # noqa: E402
from repro_torch.core import paths as P  # noqa: E402
from repro_torch.core import records as R  # noqa: E402
from repro_torch.core import tensorstore as TS  # noqa: E402
from repro_torch.core.store import DictKV, PathStore  # noqa: E402

seg = st.text(alphabet="abcdefgh_", min_size=1, max_size=6)
CPU = "cpu"


class _Side:
    """One package's store + mutation helpers (the same calls on both)."""

    def __init__(self, P_, R_, PathStore_, DictKV_, norm):
        self.P, self.R = P_, R_
        self.kids: dict[str, set] = {}
        for p in norm:
            self.kids.setdefault(P_.parent(p), set()).add(P_.basename(p))
        self.ps = PathStore_(DictKV_())
        self.ps.put_record("/", R_.DirRecord(
            name="", sub_dirs=sorted(P_.basename(d) for d in self.kids)))
        for d in sorted(self.kids):
            self.ps.put_record(d, R_.DirRecord(name=P_.basename(d),
                                               files=sorted(self.kids[d])))
        for p in norm:
            self.ps.put_record(p, R_.FileRecord(name=P_.basename(p), text="t"))

    def mutate(self, live, mutations):
        P_, R_, ps, kids = self.P, self.R, self.ps, self.kids
        ups: dict = {}
        unlinks: list = []

        def parent(dim):
            rec = R_.DirRecord(name=P_.basename(dim), files=sorted(kids[dim]))
            ps.put_record(dim, rec)
            ups[dim] = rec

        for kind, a, b in mutations:
            if kind == "append":
                p = P_.normalize(f"/{a}/x_{b}")
                dim = P_.parent(p)
                if dim not in kids or not kids[dim]:
                    kids.setdefault(dim, set())
                    rec = R_.DirRecord(name="", sub_dirs=sorted(
                        P_.basename(d) for d in kids if kids[d] or d == dim))
                    ps.put_record("/", rec)
                    ups["/"] = rec
                kids[dim].add(P_.basename(p))
                parent(dim)
                rec = R_.FileRecord(name=P_.basename(p), text="new")
                ps.put_record(p, rec)
                ups[p] = rec
                if p not in live:
                    live.append(p)
                unlinks = [q for q in unlinks if q != p]
            elif kind == "overwrite" and live:
                p = live[len(a) % len(live)]
                rec = R_.FileRecord(name=P_.basename(p), text=f"over_{b}")
                ps.put_record(p, rec)
                ups[p] = rec
            elif kind == "unlink" and len(live) > 1:
                p = live.pop(len(b) % len(live))
                kids[P_.parent(p)].discard(P_.basename(p))
                ps.delete_record(p)
                parent(P_.parent(p))
                unlinks.append(p)
                ups.pop(p, None)
        return list(ups.items()), unlinks


def _canon_state(state):
    """logical_state with records as their encoded bytes (the two
    packages' record classes differ; their encodings must not)."""
    rows = {p: v[:-1] + (None if v[-1] is None else v[-1].to_bytes(),)
            for p, v in state["rows"].items()}
    return {**state, "rows": rows}


def _pair(norm):
    return (_Side(JP, JR, JPathStore, JDictKV, norm),
            _Side(P, R, PathStore, DictKV, norm))


def _check_queries(jw, tw, probes):
    live = sorted(jw.row_of)
    assert sorted(tw.row_of) == live
    paths = live + ["/definitely/not_here"]
    jrows = JTS.batched_get(jw, paths)
    trows = TS.batched_get(tw, paths, device=CPU)
    assert [jw.paths[r] if r >= 0 else None for r in jrows] == \
        [tw.paths[r] if r >= 0 else None for r in trows]
    for prefix in probes:
        assert TS.search_prefix(tw, prefix, device=CPU) == JTS.search_prefix(jw, prefix)
    for p in live[:6]:
        jn = JTS.navigate_rows(jw, p)
        tn = TS.navigate_rows(tw, p, device=CPU)
        assert [jw.paths[r] if r >= 0 else None for r in jn] == \
            [tw.paths[r] if r >= 0 else None for r in tn]


@pytest.mark.parametrize("mode", ["auto", "patch", "rebuild"])
@settings(max_examples=12, deadline=None)
@given(st.sets(st.builds(lambda a, b: f"/{a}/{b}", seg, seg), min_size=2, max_size=16),
       st.lists(st.tuples(st.sampled_from(["append", "overwrite", "unlink"]), seg, seg),
                min_size=1, max_size=10))
def test_delta_sequence_matches_reference(mode, paths, mutations):
    norm = sorted({P.normalize(p) for p in paths})
    js, ts = _pair(norm)
    jw, jr = JTS.freeze_with_records(js.ps)
    tw, tr = TS.freeze_with_records(ts.ps)
    assert _canon_state(TS.logical_state(tw, tr)) == _canon_state(JTS.logical_state(jw, jr))
    jlive, tlive = list(norm), list(norm)
    # two epochs of the same mutations split in halves
    half = max(1, len(mutations) // 2)
    for epoch, chunk in enumerate((mutations[:half], mutations[half:]), start=1):
        if not chunk:
            continue
        jd = JTS.TensorDelta(epoch, *js.mutate(jlive, chunk))
        td = TS.TensorDelta(epoch, *ts.mutate(tlive, chunk))
        try:
            jw, jr, jinfo = JTS.apply_delta_ex(jw, jr, jd, mode=mode)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                TS.apply_delta_ex(tw, tr, td, mode=mode)
            return
        tw, tr, tinfo = TS.apply_delta_ex(tw, tr, td, mode=mode)
        assert (tinfo.kind, tinfo.reason) == (jinfo.kind, jinfo.reason)
        assert tinfo.new_rows == jinfo.new_rows and tinfo.removed_rows == jinfo.removed_rows
        assert _canon_state(TS.logical_state(tw, tr)) == \
            _canon_state(JTS.logical_state(jw, jr))
        assert tw.paths == jw.paths
        assert np.array_equal(tw.path_tokens, jw.path_tokens)
        _check_queries(jw, tw, ["/", "/" + chunk[0][1], "/zz"] +
                       [P.parent(p) for p in tlive[:3]])


def test_built_wiki_queries_match_reference(built_wiki):
    pipe, _ = built_wiki
    jw = JTS.freeze(pipe.store)
    # the same store content, read into the port's own store
    ps = PathStore(DictKV())
    for p in pipe.store.all_paths():
        ps.put_record(p, R.decode(JR.encode(pipe.store.get(p))))
    tw = TS.freeze(ps)
    assert tw.paths == jw.paths and tw.n_pinned == jw.n_pinned
    dims = [p for p in jw.paths if P.depth(p) == 1]
    _check_queries(jw, tw, ["/", "/sources", "/sources/digests"] + dims)
    root = int(TS.batched_get(tw, ["/"], device=CPU)[0])
    assert TS.ls_rows(tw, root).tolist() == JTS.ls_rows(jw, root).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_contains_match_matches_reference(seed):
    """``contains_match_ref``: keyword containment over a token matrix, the
    same bitmap as the reference's on random rows, needles cut from rows
    (hits, also at the row's end), random needles (mostly misses), the
    empty needle and one longer than the row's room."""
    rs = np.random.RandomState(seed)
    N, L, K = 40, 24, 6
    toks = rs.randint(0, 4, (N, L)).astype(np.uint8)      # a small alphabet: many hits
    toks[rs.rand(N, L) < 0.1] = 0
    cases = [(toks[rs.randint(N), o:o + n], n) for o, n in ((3, 4), (L - 5, 5), (0, 6))]
    cases += [(rs.randint(0, 4, K).astype(np.uint8), n) for n in (1, 3, 6)]
    cases += [(np.zeros(0, np.uint8), 0)]
    for needle, n in cases:
        padded = np.zeros(K, np.uint8)
        padded[:len(needle)] = needle
        want = np.asarray(JTS.contains_match_ref(jnp.asarray(toks), jnp.asarray(padded),
                                                 jnp.int32(n)))
        got = TS.contains_match_ref(torch.from_numpy(toks), torch.from_numpy(padded), n)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), (needle, n)
    # a needle that fits nowhere: K bytes in a row of K - 1
    short = toks[:, :K - 1]
    want = np.asarray(JTS.contains_match_ref(jnp.asarray(short), jnp.asarray(toks[0, :K]),
                                             jnp.int32(K)))
    got = TS.contains_match_ref(torch.from_numpy(short), torch.from_numpy(toks[0, :K]), K)
    assert not want.any() and np.array_equal(got.numpy(), want)
