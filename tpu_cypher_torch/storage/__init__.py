"""Transactional mutation storage: delta-CSR overlays + WAL durability.

The reference architecture (CAPS) keeps the compiler stack storage-agnostic
— a ``RelationalCypherGraph`` is anything that answers ``scan_operator``.
This package exploits that seam to add writes without touching the read
path's contract: an immutable bucket-padded base (``ScanGraph``), a small
delta overlay whose extents round on the bucket lattice, versioned
read snapshots, and a write-ahead log for crash durability
(docs/mutation.md).
"""

from .delta import (
    DEAD_KEY,
    MutableGraph,
    SnapshotGraph,
    WriteBatch,
    mutable_graph_from_create_query,
)
from .wal import WriteAheadLog, wal_directory

__all__ = [
    "DEAD_KEY",
    "MutableGraph",
    "SnapshotGraph",
    "WriteAheadLog",
    "WriteBatch",
    "mutable_graph_from_create_query",
    "wal_directory",
]
