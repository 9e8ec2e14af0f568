"""Hand-written Hopper kernels for the query hot path.

One package, one policy: every kernel registers with ``dispatch`` (the
device tier rule, fault sites, launch counters) and ships beside the plain
PyTorch version of the same function. Sources live in
``tpu_cypher_torch/csrc`` and build on first use (``_build``).

Kernels:

* ``expand.expand_materialize_counted`` — CSR expand row-search materialize
* ``frontier.csr_frontier_degree_sum``  — frontier degree-sum reduction
* ``aggregate.segment_aggregate``       — masked grouped segment reduce
* ``intersect.intersect_range_count``   — WCOJ sorted-key range count
* ``join.join_probe``                    — equi-join hash-table probe
"""

from . import dispatch  # noqa: F401
from .aggregate import segment_aggregate  # noqa: F401
from .expand import expand_materialize_counted  # noqa: F401
from .frontier import csr_frontier_degree_sum  # noqa: F401
from .intersect import intersect_range_count  # noqa: F401
from .join import join_probe  # noqa: F401
