"""Notebook / Zeppelin-style visualization of records and graphs.

Re-design of the reference's ``ZeppelinSupport``
(``okapi-api/src/main/scala/org/opencypher/okapi/api/util/ZeppelinSupport.scala:42-280``):

* ``records_to_table_tsv``   — the ``%table`` tab-separated rendering
* ``records_to_graph_json``  — the ``%network`` JSON: element columns of a
                               result deduplicated by id into
                               ``{nodes, edges, labels, types, directed}``
* ``graph_to_json``          — same JSON for a whole property graph
* ``visualize``              — graph if the result returns one, else table

Node JSON: ``{id, label, labels, data}`` (label = first label,
lexicographically — the reference uses ``labels.headOption``); relationship
JSON: ``{id, source, target, label, data}``. Ids are strings, as in the
reference's Zeppelin format.
"""

from __future__ import annotations

import json as _json
import math
from typing import Any, Dict, Iterable, List

from ..api.values import Node, Relationship, to_cypher_string


def _json_value(v: Any) -> Any:
    """Property value -> JSON-compatible value (Cypher-formatted when the
    type has no JSON analog)."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        if math.isnan(v) or math.isinf(v):
            return to_cypher_string(v)
        return v
    if isinstance(v, (list, tuple)):
        return [_json_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_value(x) for k, x in v.items()}
    return to_cypher_string(v).strip("'")


def node_json(n: Node) -> Dict[str, Any]:
    labels = sorted(n.labels)
    return {
        "id": str(n.id),
        "label": labels[0] if labels else "",
        "labels": labels,
        "data": {k: _json_value(v) for k, v in sorted(n.properties.items())},
    }


def relationship_json(r: Relationship) -> Dict[str, Any]:
    return {
        "id": str(r.id),
        "source": str(r.start),
        "target": str(r.end),
        "label": r.rel_type,
        "data": {k: _json_value(v) for k, v in sorted(r.properties.items())},
    }


def elements_to_graph_json(
    nodes: Iterable[Node], rels: Iterable[Relationship], indent: int = 2
) -> str:
    by_id: Dict[Any, Node] = {}
    for n in nodes:
        by_id.setdefault(n.id, n)
    rel_by_id: Dict[Any, Relationship] = {}
    for r in rels:
        rel_by_id.setdefault(r.id, r)
    labels = sorted({l for n in by_id.values() for l in n.labels})
    types = sorted({r.rel_type for r in rel_by_id.values()})
    obj = {
        "nodes": [node_json(n) for _, n in sorted(by_id.items())],
        "edges": [relationship_json(r) for _, r in sorted(rel_by_id.items())],
        "labels": labels,
        "types": types,
        "directed": True,
    }
    return _json.dumps(obj, indent=indent)


def records_to_graph_json(records, indent: int = 2) -> str:
    """Element columns of a result, deduplicated by id
    (reference ``toZeppelinGraph``, ``ZeppelinSupport.scala:144-180``)."""
    rows = records.collect()
    nodes: List[Node] = []
    rels: List[Relationship] = []
    for row in rows:
        for v in row.values():
            if isinstance(v, Node):
                nodes.append(v)
            elif isinstance(v, Relationship):
                rels.append(v)
    return elements_to_graph_json(nodes, rels, indent)


def records_to_table_tsv(records) -> str:
    """``%table`` rendering (reference ``toZeppelinTable``): header row then
    one tab-separated Cypher-formatted line per record."""
    cols = records.columns
    lines = ["\t".join(cols)]
    for row in records.collect():
        lines.append("\t".join(to_cypher_string(row[c]) for c in cols))
    return "\n".join(lines)


def records_to_html(records, max_rows: int = 100) -> str:
    """Notebook ``_repr_html_`` table."""
    import html

    cols = records.columns
    rows = records.collect()[:max_rows]
    head = "".join(f"<th>{html.escape(c)}</th>" for c in cols)
    body = "".join(
        "<tr>"
        + "".join(f"<td>{html.escape(to_cypher_string(r[c]))}</td>" for c in cols)
        + "</tr>"
        for r in rows
    )
    return (
        f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"
        f"<p>{records.size} row(s)</p>"
    )


def graph_to_json(graph, indent: int = 2) -> str:
    """Whole-graph ``%network`` JSON via full node/relationship scans
    (reference ``ZeppelinGraph.printGraph``)."""
    node_rows = graph.nodes("n").collect()
    rel_rows = graph.relationships("r").collect()
    return elements_to_graph_json(
        (row["n"] for row in node_rows),
        (row["r"] for row in rel_rows),
        indent,
    )


def visualize(result) -> str:
    """Graph rendering if the result carries a graph (RETURN GRAPH), else the
    table (reference ``ResultVisualizer.visualize``)."""
    recs = result.records
    if recs is None or not recs.columns:  # graph-returning query
        return graph_to_json(result.graph)
    return records_to_table_tsv(recs)
