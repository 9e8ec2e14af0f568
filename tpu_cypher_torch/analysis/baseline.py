"""Baseline: grandfathered findings that don't fail the run.

The committed baseline (``analysis/baseline.json``) is kept EMPTY — the
acceptance bar for this engine is that every finding is fixed or carries
an inline reason. The mechanism still exists (and is tested) because a
downstream consumer adopting a new rule over a large tree needs a ratchet:
baseline today's debt, fail anything NEW, burn the file down over time.

Matching is by ``(rule, path, message)`` with multiplicity — line numbers
drift with unrelated edits, but if a file grows a SECOND identical
violation the new one still fails.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, List, Tuple

from .core import Finding

BASELINE_VERSION = 1


def load(path: str) -> Counter:
    """Baseline file -> multiset of finding keys. A missing file is an
    empty baseline; a malformed one raises (a corrupt ratchet must not
    silently allow everything)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return Counter()
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"baseline {path!r}: expected {{'findings': [..]}}")
    keys: Counter = Counter()
    for entry in data["findings"]:
        keys[(entry["rule"], entry["path"], entry["message"])] += 1
    return keys


def save(path: str, findings: Iterable[Finding]) -> None:
    entries = sorted(
        (
            {"rule": f.rule, "path": f.path, "message": f.message}
            for f in findings
        ),
        key=lambda e: (e["path"], e["rule"], e["message"]),
    )
    with open(path, "w") as f:
        json.dump(
            {"version": BASELINE_VERSION, "findings": entries}, f, indent=2
        )
        f.write("\n")


def split(
    findings: List[Finding], baseline: Counter
) -> Tuple[List[Finding], List[Finding]]:
    """-> (blocking, baselined). Consumes baseline multiplicity in file
    order, so N baselined + 1 new identical findings block exactly once."""
    remaining = Counter(baseline)
    blocking: List[Finding] = []
    grandfathered: List[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if remaining[key] > 0:
            remaining[key] -= 1
            grandfathered.append(f)
        else:
            blocking.append(f)
    return blocking, grandfathered
