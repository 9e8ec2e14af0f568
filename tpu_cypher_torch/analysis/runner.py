"""Orchestration: collect files, build contexts once, run every rule,
apply suppressions and the baseline, format the report.

The port's copy of ``tpu_cypher/analysis/runner.py``, over
``tpu_cypher_torch/``; it adds ``sync_sites``, the host-sync rule's
inventory that ``chip_smoke.py`` holds against the card's sync trace.
The shape rules share the run's one parse and one ``ProjectContext``
(``project.shapes``), and ``--facts-out`` reads the facts from it.

Parsing is cached process-wide keyed by ``(abspath, mtime_ns, size)`` —
repeated ``run_paths`` calls in one process (the test suite runs the
analyzer dozens of times) re-parse only files that actually changed.
``restrict_to`` narrows which files RULES run on while still parsing the
whole tree, so the interprocedural substrate (call graph, taint) sees
every definition even when only a git-changed subset is being checked.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import baseline as baseline_mod
from .core import FileContext, Finding
from .project import ProjectContext
from .rules import ALL_RULES, RULES_BY_ID

# the port's package root (…/tpu_cypher_torch) — what check_engine lints
ENGINE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json"
)

# version stamp on the ``suppressions`` section of --format json output
SUPPRESSION_SCHEMA_VERSION = 1

_SKIP_DIRS = {"__pycache__", ".git", "node_modules"}

# (abspath) -> ((mtime_ns, size, relpath), FileContext): one parse per
# file VERSION per process, shared across run_paths calls
_PARSE_CACHE: Dict[str, Tuple[Tuple[int, int, str], FileContext]] = {}


@dataclass
class Report:
    """Everything one analysis run produced. ``blocking`` is what fails
    CI; suppressed and baselined findings are carried for the report so a
    reader can audit the debt."""

    blocking: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    suppress_reasons: Dict[Finding, str] = field(default_factory=dict)
    # every well-formed suppression seen, fired or not — the auditable
    # debt ledger ``--format json`` exports as the ``suppressions`` section
    suppression_entries: List[Dict[str, object]] = field(default_factory=list)
    files_checked: int = 0
    rules_run: int = 0
    # per-run cache traffic: parse cache + shape summary cache hit/miss
    cache_stats: Dict[str, int] = field(default_factory=dict)
    # the ProjectContext the run was checked against (not serialized):
    # what sync_sites reads the taint model from and what --facts-out
    # hands to shapes.collect_facts
    project: Optional[ProjectContext] = None

    @property
    def clean(self) -> bool:
        return not self.blocking

    def counts_by_rule(self) -> Dict[str, int]:
        """{rule id: blocking finding count} — a regressed invariant names
        itself instead of flipping an opaque boolean."""
        out: Dict[str, int] = {}
        for f in self.blocking:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> Dict[str, object]:
        return {
            "clean": self.clean,
            "files_checked": self.files_checked,
            "rules_run": self.rules_run,
            "findings": [f.to_json() for f in self.blocking],
            "suppressed": [
                {**f.to_json(), "reason": self.suppress_reasons.get(f, "")}
                for f in self.suppressed
            ],
            "baselined": [f.to_json() for f in self.baselined],
            "suppressions": {
                "schema_version": SUPPRESSION_SCHEMA_VERSION,
                "entries": self.suppression_entries,
            },
            "caches": dict(self.cache_stats),
        }

    def render_text(self) -> str:
        out: List[str] = []
        for f in self.blocking:
            out.append(f"{f.location()}: [{f.rule}] {f.message}")
        out.append(
            f"{len(self.blocking)} finding(s) "
            f"({len(self.suppressed)} suppressed, "
            f"{len(self.baselined)} baselined) across "
            f"{self.files_checked} file(s)"
        )
        return "\n".join(out)


def _collect_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, fnames in os.walk(p):
                dirnames[:] = sorted(
                    d
                    for d in dirnames
                    if d not in _SKIP_DIRS and not d.startswith(".")
                )
                for fname in sorted(fnames):
                    if fname.endswith(".py"):
                        files.append(os.path.join(dirpath, fname))
        elif p.endswith(".py"):
            files.append(p)
    # dedupe, stable order
    seen = set()
    out = []
    for f in files:
        a = os.path.abspath(f)
        if a not in seen:
            seen.add(a)
            out.append(f)
    return out


def _relpath(path: str) -> str:
    a = os.path.abspath(path)
    rel = os.path.relpath(a, os.getcwd())
    chosen = a if rel.startswith("..") else rel
    return chosen.replace(os.path.sep, "/")


def _load_context(path: str, rel: str) -> Tuple[FileContext, bool]:
    """Parse ``path`` into a FileContext, reusing the process-wide cache
    when (mtime_ns, size, relpath) are unchanged. FileContext is immutable
    after construction, so sharing one across runs is safe. Returns
    ``(ctx, cache_hit)`` so the caller can report per-run cache traffic
    without module-level counters."""
    a = os.path.abspath(path)
    try:
        st = os.stat(a)
        key = (st.st_mtime_ns, st.st_size, rel)
    except OSError:
        key = None
    if key is not None:
        hit = _PARSE_CACHE.get(a)
        if hit is not None and hit[0] == key:
            return hit[1], True
    with open(path, "r") as f:
        source = f.read()
    ctx = FileContext(path, rel, source)
    if key is not None:
        _PARSE_CACHE[a] = (key, ctx)
    return ctx, False


def run_paths(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = None,
    restrict_to: Optional[Iterable[str]] = None,
) -> Report:
    """Analyze ``paths`` (files or directories). ``rules`` limits to a
    subset of rule ids; ``baseline_path`` points at a grandfather file
    (None = no baseline). ``restrict_to`` (paths) narrows which files the
    RULES check and report on — the whole tree is still parsed so the
    interprocedural substrate stays complete (``--changed-only``). Raises
    ``KeyError`` on an unknown rule id."""
    active = (
        ALL_RULES
        if rules is None
        else [RULES_BY_ID[r] for r in rules]
    )
    active_ids = {r.id for r in active}
    report = Report(rules_run=len(active))
    parse_hits = parse_misses = 0

    restrict = (
        None
        if restrict_to is None
        else {os.path.abspath(p) for p in restrict_to}
    )

    contexts: List[FileContext] = []
    for path in _collect_files(paths):
        rel = _relpath(path)
        in_scope = restrict is None or os.path.abspath(path) in restrict
        try:
            ctx, was_hit = _load_context(path, rel)
            parse_hits += 1 if was_hit else 0
            parse_misses += 0 if was_hit else 1
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            if in_scope:
                report.blocking.append(
                    Finding(
                        "parse",
                        rel,
                        getattr(exc, "lineno", 0) or 0,
                        0,
                        f"unparsable file: {exc}",
                    )
                )
            continue
        contexts.append(ctx)

    checked = [
        c
        for c in contexts
        if restrict is None or os.path.abspath(c.path) in restrict
    ]
    report.files_checked = len(checked)

    project = ProjectContext(contexts)

    raw: List[Finding] = []
    for ctx in checked:
        # malformed / reason-less suppressions are findings themselves
        for f in ctx.suppression_findings:
            raw.append(
                Finding(f.rule, ctx.relpath, f.line, f.col, f.message)
            )
        for rule in active:
            for f in rule.check(ctx, project):
                reason = ctx.allowed(f.line, f.rule)
                if reason is not None:
                    report.suppressed.append(f)
                    report.suppress_reasons[f] = reason
                else:
                    raw.append(f)

    # suppression inventory + stale detection: an allow whose named rules
    # ALL ran this pass but suppressed nothing marks a site that is clean
    # now — the comment itself becomes the finding. Suppressions naming
    # any rule OUTSIDE the active set are skipped (a restricted run cannot
    # know whether the other rule still fires there).
    for ctx in checked:
        for s in ctx.suppressions:
            if not any(r in RULES_BY_ID for r in s.rules):
                # syntax examples in docstrings (allow[rule-id] ...) parse
                # as suppressions for nonexistent rules; they suppress
                # nothing and don't belong in the inventory
                continue
            fired = any(
                f.path == ctx.relpath
                and f.rule in s.rules
                and f.line in s.covers
                for f in report.suppressed
            )
            report.suppression_entries.append(
                {
                    "path": ctx.relpath,
                    "line": s.line,
                    "rules": list(s.rules),
                    "reason": s.reason,
                    "active": fired,
                }
            )
            if not fired and all(r in active_ids for r in s.rules):
                raw.append(
                    Finding(
                        "suppression",
                        ctx.relpath,
                        s.line,
                        0,
                        "stale suppression: allow[%s] matched no finding "
                        "this run — the site is clean now; delete the "
                        "comment" % ",".join(s.rules),
                    )
                )

    raw.sort(key=lambda f: (f.path, f.line, f.col, f.rule, f.message))

    if baseline_path is not None:
        base = baseline_mod.load(baseline_path)
        blocking, grandfathered = baseline_mod.split(raw, base)
        report.blocking.extend(blocking)
        report.baselined.extend(grandfathered)
    else:
        report.blocking.extend(raw)

    report.blocking.sort(
        key=lambda f: (f.path, f.line, f.col, f.rule, f.message)
    )
    # shape-summary cache traffic: at most one lookup per run (the lazy
    # ProjectContext.shapes property records whether it hit)
    built = project._shapes is not None
    hit = project.shape_summary_cache_hit
    report.cache_stats = {
        "parse_hits": parse_hits,
        "parse_misses": parse_misses,
        "summary_hits": 1 if (built and hit) else 0,
        "summary_misses": 1 if (built and not hit) else 0,
    }
    report.project = project
    return report


def check_engine(
    rules: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = DEFAULT_BASELINE,
) -> Report:
    """Lint the ``tpu_cypher_torch`` package — the thin invocation the
    tests and ``chip_smoke.py`` use."""
    return run_paths([ENGINE_ROOT], rules=rules, baseline_path=baseline_path)


def engine_is_clean() -> bool:
    """True when the port lints clean. Never raises — a caller recording
    the verdict on a result line gets False from an analyzer crash."""
    try:
        return check_engine().clean
    except Exception:  # fault-ok: a lint crash must not fail the caller's result line
        return False


def engine_lint_summary() -> Dict[str, object]:
    """A ``lint_clean`` payload: verdict plus per-rule blocking finding
    counts, so a regressed invariant names itself instead of flipping an
    opaque boolean. Never raises — an analyzer crash reports
    ``{"clean": False, "error": ...}``."""
    try:
        report = check_engine()
        return {
            "clean": report.clean,
            "findings_by_rule": report.counts_by_rule(),
            "suppressed": len(report.suppressed),
            "files_checked": report.files_checked,
        }
    except Exception as exc:  # fault-ok: a lint crash must not fail the caller's result line
        return {"clean": False, "findings_by_rule": {}, "error": str(exc)[:200]}


def sync_sites(report: Report) -> Dict[Tuple[str, int], Dict[str, str]]:
    """Every device->host sync the host-sync rule's taint model sees in
    the files ``report`` checked, keyed by (relpath, line): its ``kind``
    and its ``status`` — ``flagged`` (a blocking finding), ``suppressed``
    (an inline allow), ``accepted`` (under a ``fault_point``) or
    ``outside scope`` (a file the rule does not check). A line with
    several syncs keeps its first by this order."""
    from .rules.host_sync import HostSyncRule, in_scope

    project = report.project
    rule = HostSyncRule()
    suppressed = {
        (f.path, f.line) for f in report.suppressed if f.rule == rule.id
    }
    order = ("flagged", "suppressed", "accepted", "outside scope")
    out: Dict[Tuple[str, int], Dict[str, str]] = {}
    for ctx in project.contexts:
        scoped = in_scope(ctx.relpath)
        for call, kind, guarded in rule.sites(ctx, project):
            key = (ctx.relpath, call.lineno)
            if not scoped:
                status = "outside scope"
            elif key in suppressed:
                status = "suppressed"
            elif guarded:
                status = "accepted"
            else:  # a blocking or a baselined finding
                status = "flagged"
            old = out.get(key)
            if old is None or order.index(status) < order.index(old["status"]):
                out[key] = {"kind": kind, "status": status}
    return out


def format_report(report: Report, fmt: str) -> str:
    if fmt == "json":
        return json.dumps(report.to_json(), indent=2)
    return report.render_text()
