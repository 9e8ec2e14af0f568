"""Gherkin-lite parser for TCK ``.feature`` files.

Supports the subset the openCypher TCK uses: ``Feature:``, ``Background:``,
``Scenario:``, ``Scenario Outline:`` + ``Examples:`` expansion, steps
(Given/When/Then/And/But), ``\"\"\"`` docstrings, ``|``-delimited data tables,
``@tags`` and ``#`` comments. (The reference consumes the TCK through the
published ``tck-api`` artifact; our framework owns the whole pipeline.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class GherkinParseError(Exception):
    pass


@dataclass
class Step:
    keyword: str  # Given / When / Then / And / But
    text: str
    docstring: Optional[str] = None
    table: Optional[List[List[str]]] = None  # rows of raw cell strings

    def __repr__(self):
        return f"{self.keyword} {self.text}"


@dataclass
class Scenario:
    feature: str
    name: str
    steps: List[Step] = field(default_factory=list)
    tags: Tuple[str, ...] = ()
    example_index: Optional[int] = None

    def __str__(self):
        # the reference blacklists by "Feature "x": Scenario "y"" strings
        # (TCKFixture ScenariosFor); we key the same way
        suffix = f" (example {self.example_index})" if self.example_index is not None else ""
        return f'Feature "{self.feature}": Scenario "{self.name}"{suffix}'


@dataclass
class Feature:
    name: str
    scenarios: List[Scenario] = field(default_factory=list)
    source: str = ""  # raw feature text (test generator re-embeds it)


def _split_table_row(line: str) -> List[str]:
    # | a | b c |  -> ['a', 'b c']; escaped \| inside cells
    s = line.strip()
    if not (s.startswith("|") and s.endswith("|")):
        raise GherkinParseError(f"Malformed table row: {line!r}")
    cells: List[str] = []
    cur = []
    i = 1
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s) and s[i + 1] == "|":
            cur.append("|")
            i += 2
            continue
        if ch == "|":
            cells.append("".join(cur).strip())
            cur = []
            i += 1
            continue
        cur.append(ch)
        i += 1
    return cells


_STEP_KEYWORDS = ("Given", "When", "Then", "And", "But")


def parse_feature(text: str, path: str = "<string>") -> Feature:
    lines = text.splitlines()
    feature: Optional[Feature] = None
    background: List[Step] = []
    pending_tags: List[str] = []

    i = 0
    n = len(lines)

    def peek_stripped(j: int) -> str:
        return lines[j].strip()

    current: Optional[Scenario] = None
    in_background = False
    outline_steps: Optional[List[Step]] = None
    outline_name: Optional[str] = None
    outline_tags: Tuple[str, ...] = ()

    def flush_outline(examples: List[List[str]]):
        nonlocal outline_steps, outline_name
        if outline_steps is None:
            return
        header, *rows = examples
        for idx, row in enumerate(rows):
            subs = dict(zip(header, row))
            steps = []
            for st in background + outline_steps:
                steps.append(
                    Step(
                        st.keyword,
                        _substitute(st.text, subs),
                        _substitute(st.docstring, subs) if st.docstring else None,
                        [[_substitute(c, subs) for c in r] for r in st.table]
                        if st.table
                        else None,
                    )
                )
            feature.scenarios.append(
                Scenario(feature.name, outline_name, steps, outline_tags, idx + 1)
            )
        outline_steps = None
        outline_name = None

    while i < n:
        raw = lines[i]
        line = raw.strip()
        i += 1
        if not line or line.startswith("#"):
            continue
        if line.startswith("@"):
            pending_tags.extend(t for t in line.split() if t.startswith("@"))
            continue
        if line.startswith("Feature:"):
            feature = Feature(line[len("Feature:"):].strip(), source=text)
            pending_tags = []
            continue
        if feature is None:
            raise GherkinParseError(f"{path}: content before Feature: header")
        if line.startswith("Background:"):
            in_background = True
            current = None
            continue
        if line.startswith("Scenario Outline:") or line.startswith("Scenario Template:"):
            in_background = False
            current = None
            outline_steps = []
            outline_name = line.split(":", 1)[1].strip()
            outline_tags = tuple(pending_tags)
            pending_tags = []
            continue
        if line.startswith("Scenario:") or line.startswith("Example:"):
            in_background = False
            current = Scenario(
                feature.name,
                line.split(":", 1)[1].strip(),
                list(background),
                tuple(pending_tags),
            )
            pending_tags = []
            feature.scenarios.append(current)
            continue
        if line.startswith("Examples:") or line.startswith("Scenarios:"):
            rows: List[List[str]] = []
            while i < n and peek_stripped(i).startswith("|"):
                rows.append(_split_table_row(lines[i]))
                i += 1
            if not rows:
                raise GherkinParseError(f"{path}: Examples without table")
            flush_outline(rows)
            continue
        kw = next((k for k in _STEP_KEYWORDS if line.startswith(k + " ")), None)
        if kw is None:
            raise GherkinParseError(f"{path}: unparseable line {line!r}")
        step = Step(kw, line[len(kw):].strip())
        # attached docstring?
        if i < n and peek_stripped(i).startswith('"""'):
            i += 1
            doc: List[str] = []
            while i < n and not peek_stripped(i).startswith('"""'):
                doc.append(lines[i])
                i += 1
            if i >= n:
                raise GherkinParseError(f"{path}: unterminated docstring")
            i += 1
            step.docstring = _dedent(doc)
        # attached table?
        elif i < n and peek_stripped(i).startswith("|"):
            tbl: List[List[str]] = []
            while i < n and peek_stripped(i).startswith("|"):
                tbl.append(_split_table_row(lines[i]))
                i += 1
            step.table = tbl
        if in_background:
            background.append(step)
        elif outline_steps is not None:
            outline_steps.append(step)
        elif current is not None:
            current.steps.append(step)
        else:
            raise GherkinParseError(f"{path}: step outside scenario: {line!r}")
    return feature


def _dedent(doc: List[str]) -> str:
    indents = [len(l) - len(l.lstrip()) for l in doc if l.strip()]
    cut = min(indents) if indents else 0
    return "\n".join(l[cut:] if len(l) >= cut else l for l in doc)


def _substitute(text: str, subs) -> str:
    for k, v in subs.items():
        text = text.replace(f"<{k}>", v)
    return text
