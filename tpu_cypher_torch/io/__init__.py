"""IO subsystem of the port: the data-source SPI and the LDBC SNB loader
and generator. The filesystem, SQL, Neo4j and edge-list sources are not
ported yet (ROADMAP.md queue 1)."""

from .datasource import (
    CachedDataSource,
    DataSourceError,
    PropertyGraphDataSource,
    SessionGraphDataSource,
)
from .ldbc import generate_snb, load_snb_csv

__all__ = [
    "CachedDataSource",
    "DataSourceError",
    "generate_snb",
    "load_snb_csv",
    "PropertyGraphDataSource",
    "SessionGraphDataSource",
]
