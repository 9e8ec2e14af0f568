"""The reference against brute force and the numpy truths, on small
generated graphs; each control against the reference; the generator
against the figures its configuration states."""

import json

import numpy as np
import pytest

from portbench import reference as R
from portbench import snb, truths
from portbench.refctx import Context, find_walk_windows

from conftest import REPO, TINY_GRAPH

BASE = json.loads((REPO / "portbench" / "configs" / "snb_sf1.json").read_text())


def gen(**kw):
    return dict(BASE["generator"], **kw)


def small(seed, persons=300, knows=2400):
    return snb.graph_of(gen(persons=persons, knows=knows, graph_seed=seed))


def brute_paths(g):
    """Per source a: distinct pairs, triangles and undirected closes by
    enumerating every 2-walk in Python."""
    out = [[] for _ in range(g.n)]
    for s, d in zip(g.src.tolist(), g.dst.tolist()):
        out[s].append(d)
    mult = {}
    for s, d in zip(g.src.tolist(), g.dst.tolist()):
        mult[(s, d)] = mult.get((s, d), 0) + 1
    res = {k: np.zeros(g.n, np.int64) for k in ("distinct_pairs", "triangles", "undirected_closes")}
    for a in range(g.n):
        pairs = set()
        for b in out[a]:
            for c in out[b]:
                pairs.add(c)
                back = mult.get((c, a), 0)
                res["triangles"][a] += back
                res["undirected_closes"][a] += back + mult.get((a, c), 0)
        res["distinct_pairs"][a] = len(pairs)
    return res


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_path_counts_equal_brute_force(seed):
    g = small(seed, persons=120, knows=900)
    _same(R.path_counts(R.EdgeIndex(g.src, g.dst, g.n, "cpu")), brute_paths(g))


@pytest.mark.parametrize("seed", [4, 5])
def test_path_counts_in_small_blocks_equal_the_truths(seed, monkeypatch):
    g = small(seed)
    monkeypatch.setattr(R, "BLOCK_CELLS", 37 * g.n)  # many blocks, ragged ends
    monkeypatch.setattr(R, "BLOCK_LANES", 5_000)
    got = R.path_counts(R.EdgeIndex(g.src, g.dst, g.n, "cpu"))
    tt = truths.triangle_truth(g.ids, g.ids[g.src], g.ids[g.dst], False)
    assert int(got["distinct_pairs"].sum()) == truths.two_hop_distinct_scipy(g.src, g.dst, g.n)
    assert int(got["triangles"].sum()) == tt["triangles"]
    assert np.array_equal(got["undirected_closes"], tt["close_rows"])
    assert truths.two_hop_distinct_pairs(g.src, g.dst, g.n)[0] == int(got["distinct_pairs"].sum())


@pytest.mark.parametrize("seed", [6, 7])
def test_walk_counts_equal_brute_force(seed):
    g = small(seed, persons=150, knows=900)
    ix = R.EdgeIndex(g.src, g.dst, g.n, "cpu")
    rng = np.random.default_rng(seed)
    for _ in range(3):
        start = int(rng.integers(0, g.n - 3))
        lo, hi = int(g.ids[start]), int(g.ids[start + 2]) + 1
        mask = R.window_mask(g.ids, lo, hi, "cpu")
        hom, uniq = R.walk_counts(ix, mask, 4)
        sources = np.flatnonzero(mask.numpy())
        assert uniq == truths.brute_walks(truths.directed_steps(g.src, g.dst), g.n, sources, 4)
        assert hom == [int(w[sources].sum()) for w in truths.walk_estimates(g.src, g.dst, g.n, 4)]
        assert uniq == truths.unique_walk_counts(g.src, g.dst, g.n, mask.numpy(), 4)
        assert R.walk_counts(ix, mask, 3)[1] == uniq[:3]


@pytest.mark.parametrize("persons,knows", [(2000, 30000), (9892, 180623), (65645, 1938516)])
def test_the_graph_holds_the_configurations_figures(persons, knows):
    """As many persons and KNOWS as stated; an undirected simple graph, each
    KNOWS stored once; a degree law with a median near its share of the
    mean and a tail; the same graph from the same block."""
    g = snb.graph_of(gen(persons=persons, knows=knows))
    assert g.n == persons and g.e == knows
    assert not (g.src == g.dst).any()
    pair = np.minimum(g.src, g.dst) * g.n + np.maximum(g.src, g.dst)
    assert len(np.unique(pair)) == knows
    deg = g.out_degree() + g.in_degree()
    assert abs(np.median(deg) / deg.mean() - 0.5211) < 0.15
    assert deg.max() > 5 * deg.mean()
    assert np.all(np.diff(g.ids) == 7)
    lo, hi = BASE["generator"]["birthday_days"]
    assert g.birthday.min() >= lo and g.birthday.max() < hi
    again = snb.graph_of(gen(persons=persons, knows=knows))
    assert np.array_equal(g.src, again.src) and np.array_equal(g.dst, again.dst)


@pytest.mark.parametrize("key", ["zipf_exponent", "scale"])
def test_a_generator_key_it_does_not_read_is_refused(key):
    with pytest.raises(ValueError, match=key):
        snb.snb_arrays(gen(**{key: 1.0}))
    short = gen()
    del short["knows"]
    with pytest.raises(ValueError, match="knows"):
        snb.snb_arrays(short)


TINY = {"name": "snb_tiny", "generator": gen(**TINY_GRAPH)}
FOF = {"params": {"source_share": 0.75}}


def test_source_windows_are_drawn_from_the_seed_and_never_repeat_early():
    a = Context.for_run(TINY, FOF, 8).source_windows()
    b = Context.for_run(TINY, FOF, 8).source_windows()
    c = Context.for_run(TINY, FOF, 2**40 + 9).source_windows()
    assert a == b and a != c
    assert len({(w["lo"], w["hi"]) for w in a}) == len(a) == 2000 - 1500 + 1
    ctx = Context.for_run(TINY, FOF, 8)
    assert {ctx.span(w)[1] - ctx.span(w)[0] for w in a} == {1500}


def test_the_frozen_walk_windows_are_found_again():
    """The var-length mix's windows, frozen as data for each configuration,
    are what the search finds on that configuration's graph."""
    mix = json.loads((REPO / "portbench" / "traffic" / "varlen.json").read_text())
    for name, frozen in mix["params"]["windows"].items():
        cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
        assert find_walk_windows(snb.graph_of(cfg["generator"]), mix["params"]) == frozen


@pytest.mark.parametrize("seed", [10, 11])
def test_each_control_breaks_its_guarantee(seed):
    ctx = Context.for_run(TINY, FOF, seed)
    ix, paths, hashed = ctx.index(), ctx.path_counts(), ctx.closes_hashed32()
    wins = ctx.source_windows()[:3]
    got = [R.distinct_pairs_hashed32(R.pair_hashes32(ix), *ctx.span(w)) for w in wins]
    assert all(h < ctx.source_sum(paths["distinct_pairs"], w) for h, w in zip(got, wins))
    for k in ("triangles", "undirected_closes"):
        assert (hashed[k] >= paths[k]).all() and hashed[k].sum() > paths[k].sum()
    mix = {"params": {"walk_lengths": [3, 4], "walk_budget": 2_000_000, "accept_share": 0.97,
                      "count": 4}}
    mix["params"]["windows"] = {"snb_tiny": find_walk_windows(ctx.graph, mix["params"])}
    ctx = Context.for_run(TINY, mix, seed)
    for p in ctx.walk_windows(4):
        hom, uniq = ctx.walk_counts(p, 4)
        assert sum(hom) > sum(uniq)
