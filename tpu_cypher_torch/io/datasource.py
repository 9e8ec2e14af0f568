"""Property-graph data sources.

Re-design of the reference's PGDS layer (``okapi-api/.../api/io/
PropertyGraphDataSource.scala:42``, ``impl/io/SessionGraphDataSource.scala``,
``morpheus/.../api/io/util/CachedDataSource.scala:45``): a namespace mounted
on the session catalog resolves graph names to a data source; sources load
graphs into backend tables and store graphs back out.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional

from ..api.schema import PropertyGraphSchema


class DataSourceError(Exception):
    pass


class PropertyGraphDataSource(ABC):
    """Reference ``PropertyGraphDataSource.scala:42``."""

    @abstractmethod
    def has_graph(self, name: str) -> bool: ...

    @abstractmethod
    def graph_names(self) -> List[str]: ...

    @abstractmethod
    def schema(self, name: str) -> Optional[PropertyGraphSchema]:
        """The stored schema, if the source can provide it without a full load."""
        ...

    @abstractmethod
    def graph(self, name: str, session) -> "RelationalCypherGraph":  # noqa: F821
        ...

    @abstractmethod
    def store(self, name: str, graph: "RelationalCypherGraph") -> None:  # noqa: F821
        ...

    @abstractmethod
    def delete(self, name: str) -> None: ...


class SessionGraphDataSource(PropertyGraphDataSource):
    """In-memory source backing the ``session.*`` namespace
    (reference ``SessionGraphDataSource.scala``)."""

    def __init__(self):
        self._graphs: Dict[str, object] = {}

    def has_graph(self, name: str) -> bool:
        return name in self._graphs

    def graph_names(self) -> List[str]:
        return sorted(self._graphs)

    def schema(self, name: str):
        g = self._graphs.get(name)
        return g.schema if g is not None else None

    def graph(self, name: str, session):
        if name not in self._graphs:
            raise DataSourceError(f"Graph {name!r} not found in session catalog")
        return self._graphs[name]

    def store(self, name: str, graph) -> None:
        self._graphs[name] = graph

    def delete(self, name: str) -> None:
        self._graphs.pop(name, None)


class CachedDataSource(PropertyGraphDataSource):
    """Decorator caching loaded graphs
    (reference ``CachedDataSource.scala:45-90`` — there caching at a Spark
    StorageLevel; here the loaded graph's device/host tables stay resident)."""

    def __init__(self, underlying: PropertyGraphDataSource):
        self.underlying = underlying
        self._cache: Dict[str, object] = {}

    def has_graph(self, name: str) -> bool:
        return name in self._cache or self.underlying.has_graph(name)

    def graph_names(self) -> List[str]:
        return self.underlying.graph_names()

    def schema(self, name: str):
        g = self._cache.get(name)
        return g.schema if g is not None else self.underlying.schema(name)

    def graph(self, name: str, session):
        if name not in self._cache:
            self._cache[name] = self.underlying.graph(name, session)
        return self._cache[name]

    def store(self, name: str, graph) -> None:
        self.underlying.store(name, graph)
        self._cache[name] = graph

    def delete(self, name: str) -> None:
        self.underlying.delete(name)
        self._cache.pop(name, None)
