"""Table — the backend SPI.

Re-design of the reference's backend contract
(``okapi-relational/.../api/table/Table.scala:43-178``): the relational
algebra a backend must provide. Two implementations exist:
``backend.local.LocalTable`` (pure-Python columnar; correctness oracle and
TCK runner) and ``backend.tpu.TpuTable`` (sharded JAX arrays; the TPU path).

Differences from the reference signature: expression-bearing ops take
``(header, parameters)`` explicitly (the reference passes them implicitly),
and ``explode`` (UNWIND) and ``rename`` are first-class (the reference
backends implement them via engine-specific functions)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from .types import CypherType

JoinType = str  # "inner" | "left_outer" | "right_outer" | "full_outer" | "cross"


class Table(ABC):
    """Abstract columnar table (reference ``Table[T]``)."""

    # -- metadata ---------------------------------------------------------

    @property
    @abstractmethod
    def physical_columns(self) -> List[str]:
        ...

    @abstractmethod
    def column_type(self, col: str) -> CypherType:
        ...

    @property
    @abstractmethod
    def size(self) -> int:
        ...

    @abstractmethod
    def rows(self) -> Iterator[Dict[str, Any]]:
        """Iterate rows as {column: python value} (null = None)."""
        ...

    @classmethod
    def from_arrays(cls, cols: Dict[str, Any]) -> "Table":
        """Bulk construction from mixed numpy arrays / value lists (the
        IO/bench ingestion SPI). Default decodes arrays to value lists and
        delegates to ``from_columns``; backends override with a zero-decode
        fast path (``TpuTable.from_arrays`` -> one H2D copy per numeric
        column)."""
        return cls.from_columns(
            {
                c: (v.tolist() if hasattr(v, "tolist") else list(v))
                for c, v in cols.items()
            }
        )

    def column_values(self, col: str) -> List[Any]:
        """One column as host Python values (null = None). Backends override
        with a columnar read; the default goes through ``rows``."""
        return [r[col] for r in self.rows()]

    def distinct_count(self, cols: Sequence[str]) -> Optional[int]:
        """Number of distinct rows over ``cols`` without materializing them,
        or None when this backend has no cheaper path than ``distinct()``
        (count-over-distinct aggregate pushdown)."""
        return None

    # -- algebra ----------------------------------------------------------

    @abstractmethod
    def select(self, cols: Sequence[str]) -> "Table":
        ...

    @abstractmethod
    def rename(self, mapping: Dict[str, str]) -> "Table":
        ...

    @abstractmethod
    def drop(self, cols: Sequence[str]) -> "Table":
        ...

    @abstractmethod
    def filter(self, expr, header, parameters) -> "Table":
        ...

    @abstractmethod
    def join(
        self,
        other: "Table",
        kind: JoinType,
        join_cols: Sequence[Tuple[str, str]],
    ) -> "Table":
        ...

    @abstractmethod
    def union_all(self, other: "Table") -> "Table":
        ...

    @abstractmethod
    def order_by(self, items: Sequence[Tuple[str, bool]]) -> "Table":
        """items: (column, ascending)."""
        ...

    @abstractmethod
    def skip(self, n: int) -> "Table":
        ...

    @abstractmethod
    def limit(self, n: int) -> "Table":
        ...

    @abstractmethod
    def distinct(self, cols: Optional[Sequence[str]] = None) -> "Table":
        ...

    @abstractmethod
    def group(
        self,
        by: Sequence[str],
        aggregations: Sequence[Tuple[str, Any]],  # (output col, typed Agg expr)
        header,
        parameters,
    ) -> "Table":
        ...

    @abstractmethod
    def with_columns(
        self,
        items: Sequence[Tuple[Any, str]],  # (typed expr, output col)
        header,
        parameters,
    ) -> "Table":
        ...

    @abstractmethod
    def explode(self, expr, col: str, header, parameters) -> "Table":
        """One output row per element of the evaluated list expr (UNWIND)."""
        ...

    def project(self, pairs: Sequence[Tuple[str, str]]) -> "Table":
        """Project (source column, output column) pairs; unlike select+rename
        a source column may appear multiple times (e.g. a self-loop relationship
        whose start and end map to the same physical column)."""
        raise NotImplementedError

    @abstractmethod
    def with_row_index(self, col: str) -> "Table":
        """Append a 0..n-1 int64 row-index column (id generation for new
        elements — the analog of the reference's partitioned id assignment,
        ``MorpheusFunctions.scala:76`` / ``TableOps.scala:217``)."""
        ...

    def cache(self) -> "Table":
        return self

    def show(self, n: int = 20) -> str:
        from ..utils.printer import format_table

        return format_table(self, n)
