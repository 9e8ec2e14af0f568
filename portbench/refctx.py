"""What the query kinds share: the run's graph, its traffic mix and seed,
the parameters drawn from the seed, and the reference's memoized counts
(each computed once a run, however many kinds and queries read it)."""

from __future__ import annotations

import numpy as np

from . import reference as R
from . import snb, truths
from .snb import Graph


def seed_rng(seed: int, stream: int):
    """A numpy generator for one of a run's streams, from any whole
    ``seed`` (negative or past 64 bits too)."""
    return np.random.default_rng([abs(int(seed)) % (1 << 64), abs(int(seed)) >> 64,
                                  int(seed < 0), stream])


class Context:
    """``graph`` is the run's graph, made from the configuration; ``config``
    the configuration's name, under which a mix keeps data drawn once on
    that graph (``walk_windows``)."""

    def __init__(self, graph: Graph, mix: dict, seed: int, device="cpu", config=""):
        self.graph = graph
        self.mix = mix
        self.seed = seed
        self.device = device
        self.config = config
        self.memo: dict = {}

    @classmethod
    def for_run(cls, config: dict, mix: dict, seed: int, device="cpu") -> "Context":
        return cls(snb.graph_of(config["generator"]), mix, seed, device, config["name"])

    def _memo(self, key, make):
        if key not in self.memo:
            self.memo[key] = make()
        return self.memo[key]

    def span(self, p) -> tuple:
        """The node indices ``[lo, hi)`` of a window ``{"lo": id, "hi": id}``
        (ids ascend with the index)."""
        ids = self.graph.ids
        return int(np.searchsorted(ids, p["lo"])), int(np.searchsorted(ids, p["hi"]))

    def source_sum(self, vec: np.ndarray, p) -> int:
        """``vec`` summed over the window's sources."""
        lo, hi = self.span(p)
        return int(vec[lo:hi].sum())

    # -- parameters, drawn from the seed -----------------------------------

    def source_windows(self) -> list:
        """Windows of ``source_share`` of the persons, consecutive by id, in
        an order drawn from the seed: every start once before any repeats,
        so consecutive queries ask of different sources and every query
        the same number of them."""
        def make():
            n = self.graph.n
            size = max(1, int(round(self.mix["params"]["source_share"] * n)))
            ids = self.graph.ids
            starts = seed_rng(self.seed, 0x51DE).permutation(n - size + 1)
            return [{"lo": int(ids[s]), "hi": int(ids[s + size - 1]) + 1} for s in starts]

        return self._memo("source_windows", make)

    def walk_windows(self, k: int) -> list:
        """The mix's frozen walk windows for this configuration and walk
        length ``k``, as ``{"lo": id, "hi": id}``."""
        ids = self.graph.ids
        return [{"lo": int(ids[w[str(k)][0]]), "hi": int(ids[w[str(k)][0] + w[str(k)][1] - 1]) + 1}
                for w in self.mix["params"]["windows"][self.config]]

    # -- the reference's side (torch, on ``device``) ------------------------

    def index(self) -> R.EdgeIndex:
        g = self.graph
        return self._memo("index", lambda: R.EdgeIndex(g.src, g.dst, g.n, self.device))

    def path_counts(self) -> dict:
        return self._memo("paths", lambda: R.path_counts(self.index()))

    def pair_hashes32(self):
        return self._memo("pairs32", lambda: R.pair_hashes32(self.index()))

    def closes_hashed32(self) -> dict:
        return self._memo("closes32", lambda: R.closes_hashed32(self.index()))

    def walk_counts(self, p, k: int):
        """(homomorphic, relationship-unique) walk counts per length from
        the window's sources."""
        def make():
            mask = R.window_mask(self.graph.ids, p["lo"], p["hi"], self.device)
            return R.walk_counts(self.index(), mask, k)

        return self._memo(("walks", p["lo"], p["hi"], k), make)

    # -- the traffic's and the yardstick's side (numpy, on the host) -------

    def walk_estimates(self):
        """[w_1 .. w_4]: directed j-walks from each person."""
        g = self.graph
        return self._memo("west", lambda: truths.walk_estimates(g.src, g.dst, g.n, 4))

    def wcoj_arm_rows(self):
        """The triangle count's lanes per arm and source a: over the edges
        a -> b, out(b) where out(b) <= in(a) (arm 0, the pivot wins ties),
        else in(a)."""
        def make():
            g = self.graph
            ob, ia = g.out_degree()[g.dst], g.in_degree()[g.src]
            arm0 = ob <= ia
            return (np.bincount(g.src, weights=np.where(arm0, ob, 0), minlength=g.n).astype(np.int64),
                    np.bincount(g.src, weights=np.where(arm0, 0, ia), minlength=g.n).astype(np.int64))

        return self._memo("arms", make)

    def walk_lanes(self, p, k: int) -> list:
        """[sources, lanes of hop 1, ..., lanes of hop k] of the var-length
        expand from the window's sources: hop j expands every (j-1)-walk; a
        walk already known to reuse a relationship (e1 = e3) keeps its row
        but gets no lanes at hop 4."""
        def make():
            g = self.graph
            lo, hi = self.span(p)
            w = self.walk_estimates()
            lanes = [hi - lo] + [int(w[j][lo:hi].sum()) for j in range(k)]
            if k >= 4:
                sel = (g.src >= lo) & (g.src < hi)
                sa, sb = g.src[sel], g.dst[sel]
                mult = self._memo("mult", lambda: truths.edge_multiplicity(g.src, g.dst, g.n))
                lanes[4] -= int((mult(sb, sa) * g.out_degree()[sb]).sum())
            return lanes

        return self._memo(("lanes", p["lo"], p["hi"], k), make)


def find_walk_windows(graph: Graph, params: dict) -> list:
    """Walk windows on ``graph``, found once and frozen in a mix as data:
    ``count`` windows from starts drawn from a fixed stream, each kept only where the
    window that bench.py's rule sizes from it holds between ``accept_share``
    and all of ``walk_budget`` estimated walks for every walk length in
    ``walk_lengths`` and overlaps no window kept before. Returns
    [{str(k): [start, size]}]."""
    budget, share, ks = params["walk_budget"], params["accept_share"], params["walk_lengths"]
    w = truths.walk_estimates(graph.src, graph.dst, graph.n, max(ks))
    est = {k: sum(w[:k]) for k in ks}
    rng = np.random.default_rng(0x3A1C)
    out, taken = [], np.zeros(graph.n, bool)
    for _ in range(100_000):
        start = int(rng.integers(0, graph.n))
        got = {}
        for k in ks:
            size = truths.walk_window(est[k], budget, start)
            total = int(est[k][start:start + size].sum())
            if size < 2 or not share * budget <= total <= budget:
                break
            got[str(k)] = [start, size]
        else:
            end = start + max(size for _, size in got.values())
            if not taken[start:end].any():
                taken[start:end] = True
                out.append(got)
                if len(out) == params["count"]:
                    return out
    raise ValueError(f"no {params['count']} walk windows of {budget} walks found")
