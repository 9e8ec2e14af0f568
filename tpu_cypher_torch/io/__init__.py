"""IO subsystem of the port: the data-source SPI, the LDBC SNB loader and
generator, and SNAP edge lists (``edge_list``, parsed by the native C++
tier). The filesystem, SQL and Neo4j sources are not ported yet (ROADMAP.md
queue 1)."""

from .datasource import (
    CachedDataSource,
    DataSourceError,
    PropertyGraphDataSource,
    SessionGraphDataSource,
)
from .edge_list import EdgeListDataSource, load_edge_list
from .ldbc import generate_snb, load_snb_csv

__all__ = [
    "CachedDataSource",
    "DataSourceError",
    "EdgeListDataSource",
    "generate_snb",
    "load_snb_csv",
    "PropertyGraphDataSource",
    "SessionGraphDataSource",
    "load_edge_list",
]
