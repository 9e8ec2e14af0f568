"""ASCII table printing (reference ``TablePrinter.scala`` / ``RecordsPrinter``)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from ..api.values import to_cypher_string


def format_rows(columns: Sequence[str], rows: Sequence[Sequence[Any]], max_rows: Optional[int] = None) -> str:
    shown = list(rows[:max_rows]) if max_rows is not None else list(rows)
    cells = [[to_cypher_string(v) for v in r] for r in shown]
    widths = [len(c) for c in columns]
    for r in cells:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+" if columns else "++\n||\n++"

    def fmt_row(vals):
        return "|" + "|".join(f" {v:<{w}} " for v, w in zip(vals, widths)) + "|"

    lines = [sep, fmt_row(columns), sep]
    for r in cells:
        lines.append(fmt_row(r))
    lines.append(sep)
    n = len(rows)
    lines.append(f"({n} row{'s' if n != 1 else ''})")
    return "\n".join(lines)


def format_table(table, n: int = 20) -> str:
    cols = table.physical_columns
    rows = []
    for i, r in enumerate(table.rows()):
        if i >= n:
            break
        rows.append([r[c] for c in cols])
    return format_rows(cols, rows)
