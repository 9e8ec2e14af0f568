"""IO subsystem of the port: property-graph data sources and persistence.

Mirrors the reference's PGDS layer (SURVEY.md section 2.2), as
``tpu_cypher/io`` does: session/catalog sources, filesystem parquet/CSV
persistence with the reference's directory layout (``fs``), SQL views
mapped by Graph DDL (``sql``), Neo4j's bulk CSV export and its gated live
source (``neo4j``), SNAP edge lists (``edge_list``, parsed by the native C++
tier), the LDBC SNB loader and generator, and a caching decorator. pandas
and pyarrow are imported only where a graph table is stored or loaded, so
this package imports without them."""

from .datasource import (
    CachedDataSource,
    DataSourceError,
    PropertyGraphDataSource,
    SessionGraphDataSource,
)
from .edge_list import EdgeListDataSource, load_edge_list
from .fs import FSGraphSource
from .ldbc import generate_snb, load_snb_csv
from .neo4j import (
    Neo4jBulkCSVDataSink,
    Neo4jConfig,
    Neo4jPropertyGraphDataSource,
)

__all__ = [
    "CachedDataSource",
    "DataSourceError",
    "EdgeListDataSource",
    "FSGraphSource",
    "generate_snb",
    "load_snb_csv",
    "Neo4jBulkCSVDataSink",
    "Neo4jConfig",
    "Neo4jPropertyGraphDataSource",
    "PropertyGraphDataSource",
    "SessionGraphDataSource",
    "load_edge_list",
]
