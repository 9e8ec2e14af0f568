"""tpu-cypher on PyTorch and CUDA: the port of ``tpu_cypher`` to an
NVIDIA H100.

The backend-agnostic Cypher compiler pipeline (parse -> IR -> logical plan
-> relational plan) is a copy of the JAX package's; it bottoms out in the
same abstract Table algebra with two backends — the pure-Python local table
(correctness oracle) and ``CudaTable``, whose columns are torch tensors on
one explicit device and whose hot path runs hand-written Hopper kernels
(``backend/cuda/hopper``). The package imports neither ``jax`` nor
``tpu_cypher``.

Quick start::

    from tpu_cypher_torch import CypherSession
    session = CypherSession.cuda()          # cuda:0; device="cpu" for tests
    g = session.create_graph_from_create_query(
        "CREATE (a:Person {name:'Alice'})-[:KNOWS]->(:Person {name:'Bob'})")
    print(g.cypher("MATCH (a:Person)-[:KNOWS]->(b) RETURN a.name, b.name").show())
"""

from . import errors, obs
from .api.mapping import NodeMappingBuilder, RelationshipMappingBuilder
from .api.schema import PropertyGraphSchema, SchemaPattern
from .api.values import CypherMap, Duration, Node, Relationship
from .errors import TpuCypherError
from .relational.graphs import ElementTable, ScanGraph
from .relational.session import CypherResult, CypherSession, PropertyGraph

__version__ = "0.1.0"

__all__ = [
    "errors",
    "obs",
    "TpuCypherError",
    "CypherSession",
    "PropertyGraph",
    "CypherResult",
    "ElementTable",
    "ScanGraph",
    "PropertyGraphSchema",
    "SchemaPattern",
    "NodeMappingBuilder",
    "RelationshipMappingBuilder",
    "Node",
    "Relationship",
    "CypherMap",
    "Duration",
]
