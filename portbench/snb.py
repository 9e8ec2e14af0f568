"""The LDBC SNB Person/KNOWS graph the cells run on, made from a
configuration's ``generator`` block.

``snb_arrays`` builds the graph that LDBC SNB's data generator (Datagen)
describes, at the sizes the configuration gives: ``persons`` persons and
exactly ``knows`` KNOWS, an undirected simple graph (no self-loop, no two
KNOWS between one pair). Each person's degree is drawn from a Facebook-like
law scaled to the graph's mean degree (lognormal with Facebook's median over
mean, capped at its maximum over mean); the edges come, as Datagen makes
them, from several correlation dimensions: in each, the persons stand in an
order of their own and each pairs its share of the degree with persons near
it in that order (``reach`` persons on average; none: anywhere). Each KNOWS
is stored once, in a direction drawn at random; the benchmark's directed
patterns read that direction. Persons carry ``id`` (ascending with their
index, ``id_step`` apart) and ``birthday`` (days since 1970-01-01, uniform in
the ``birthday_days`` range).

Every key of the block is read, and a key the generator does not know is an
error, so a configuration says all that its graph is made from. The graph
depends on the configuration alone, not on a run's seed: a run's seed draws
its queries' parameters and their order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

KEYS = {"persons", "knows", "graph_seed", "degree", "dimensions", "id_step", "birthday_days"}


@dataclass
class Graph:
    """A Person/KNOWS graph as node indices: ``ids[i]`` is person i's id,
    ``src[j] -> dst[j]`` the j-th KNOWS (indices into ``ids``)."""

    ids: np.ndarray
    birthday: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    memo: Dict[str, object] = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return len(self.ids)

    @property
    def e(self) -> int:
        return len(self.src)

    def out_degree(self) -> np.ndarray:
        if "out" not in self.memo:
            self.memo["out"] = np.bincount(self.src, minlength=self.n).astype(np.int64)
        return self.memo["out"]

    def in_degree(self) -> np.ndarray:
        if "in" not in self.memo:
            self.memo["in"] = np.bincount(self.dst, minlength=self.n).astype(np.int64)
        return self.memo["in"]


def target_degrees(n: int, mean: float, law: dict, rng) -> np.ndarray:
    """Each person's degree target: lognormal with the law's median over
    mean, capped at its maximum over mean, at least 1."""
    if law["law"] != "lognormal":
        raise ValueError(f"unknown degree law {law['law']!r}")
    sigma = np.sqrt(-2.0 * np.log(law["median_over_mean"]))
    t = np.exp(np.log(mean) - sigma * sigma / 2 + sigma * rng.standard_normal(n))
    return np.clip(t, 1.0, law["max_over_mean"] * mean)


def _pairs(t: np.ndarray, dims: list, scale: float, rng) -> np.ndarray:
    """Candidate KNOWS as sorted keys ``u * n + v`` (u < v), duplicates and
    self-pairs dropped: per dimension each person's stubs stand at its place
    in the dimension's order plus a Laplace offset (``reach``, widened to a
    person's own stub count so that a hub reaches past its own stubs; no
    reach: uniform), and stubs next to each other in that order pair."""
    n = len(t)
    keys = []
    for dim in dims:
        want = dim["share"] * scale * t
        stubs = np.floor(want + rng.random(n)).astype(np.int64)
        owner = np.repeat(np.arange(n), stubs)
        if len(owner) % 2:
            owner = owner[:-1]
        if dim["reach"] is None:
            place = rng.random(len(owner))
        else:
            spread = np.maximum(dim["reach"], stubs)[owner].astype(np.float64)
            place = rng.permutation(n)[owner] + rng.laplace(0.0, 1.0, len(owner)) * spread
        owner = owner[np.argsort(place)]
        u, v = owner[0::2], owner[1::2]
        keep = u != v
        keys.append(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    return np.unique(np.concatenate(keys))


def snb_arrays(gen: dict):
    """(ids, birthday, src_index, dst_index) of the graph the configuration's
    ``generator`` block describes."""
    unknown = set(gen) - KEYS
    if unknown or KEYS - set(gen):
        raise ValueError(f"generator keys: unknown {sorted(unknown)}, missing {sorted(KEYS - set(gen))}")
    n, m = int(gen["persons"]), int(gen["knows"])
    if sum(d["share"] for d in gen["dimensions"]) != 1.0:
        raise ValueError("the dimensions' shares must sum to 1")
    rng = np.random.default_rng(gen["graph_seed"])
    t = target_degrees(n, 2.0 * m / n, gen["degree"], rng)
    t *= 2.0 * m / t.sum()
    scale = 1.2  # duplicates and self-pairs take about a tenth
    for _ in range(8):  # widen until the simple graph holds ``knows`` edges
        keys = _pairs(t, gen["dimensions"], scale, rng)
        if len(keys) >= m:
            break
        scale *= 1.02 * m / len(keys)
    else:
        raise ValueError(f"no simple graph of {m} KNOWS over {n} persons")
    keys = keys[np.sort(rng.choice(len(keys), size=m, replace=False))]
    u, v = keys // n, keys % n
    flip = rng.random(m) < 0.5
    src, dst = np.where(flip, v, u), np.where(flip, u, v)
    order = rng.permutation(m)
    ids = np.arange(n, dtype=np.int64) * int(gen["id_step"]) + 1
    lo, hi = gen["birthday_days"]
    birthday = rng.integers(lo, hi, size=n, dtype=np.int64)
    return ids, birthday, src[order].astype(np.int64), dst[order].astype(np.int64)


def graph_of(gen: dict) -> Graph:
    return Graph(*snb_arrays(gen))
