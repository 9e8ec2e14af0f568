"""IR pattern model.

Mirrors the reference's IR pattern vocabulary
(``okapi-ir/.../api/pattern/Connection.scala:37``, ``Pattern``/``Entity``):
typed node/relationship entities plus a topology of connections. Direction is
kept per-connection; undirected connections are expanded by the planners
(relational planner unions both orientations, ``RelationalPlanner.scala``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

from ..api import types as T

OUTGOING = ">"
INCOMING = "<"
BOTH = "-"


@dataclass(frozen=True)
class Connection:
    """rel field -> (source node field, target node field, direction).

    For INCOMING the stored source/target are already swapped to the
    canonical outgoing orientation; ``direction`` is then OUTGOING. BOTH is
    preserved (undirected — planner unions orientations).
    """

    source: str
    target: str
    direction: str  # OUTGOING | BOTH
    lower: int = 1
    upper: Optional[int] = 1  # None = unbounded '*'; (1,1) = single hop
    # True when the pattern WROTE var-length syntax: '*1..1' binds a
    # LIST of one relationship, not the relationship itself (openCypher
    # "Handle fixed-length variable length pattern")
    var_syntax: bool = False

    @property
    def is_var_length(self) -> bool:
        return self.var_syntax or not (self.lower == 1 and self.upper == 1)


@dataclass
class IRPattern:
    """All entities bound by one MATCH."""

    node_types: Dict[str, T.CTNodeType] = field(default_factory=dict)
    rel_types: Dict[str, T.CTRelationshipType] = field(default_factory=dict)
    topology: Dict[str, Connection] = field(default_factory=dict)
    # CONSTRUCT support: entity -> base entity (COPY OF)
    base_entities: Dict[str, str] = field(default_factory=dict)
    # named paths: path var -> ordered element fields
    paths: Dict[str, Tuple[str, ...]] = field(default_factory=dict)

    @property
    def fields(self) -> FrozenSet[str]:
        return frozenset(self.node_types) | frozenset(self.rel_types)

    def entity_type(self, name: str):
        if name in self.node_types:
            return self.node_types[name]
        return self.rel_types.get(name)

    def connections_for(self, node_field: str):
        return {
            r: c
            for r, c in self.topology.items()
            if c.source == node_field or c.target == node_field
        }

    def components(self) -> Tuple[FrozenSet[str], ...]:
        """Connected components over node fields (for CartesianProduct planning).

        Mirrors the connected-component analysis in the reference's
        ``LogicalPlanner`` (``LogicalPlanner.scala:93-190``).
        """
        parent: Dict[str, str] = {n: n for n in self.node_types}

        def find(x: str) -> str:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a: str, b: str):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for c in self.topology.values():
            union(c.source, c.target)
        groups: Dict[str, set] = {}
        for n in self.node_types:
            groups.setdefault(find(n), set()).add(n)
        return tuple(frozenset(g) for g in groups.values())
