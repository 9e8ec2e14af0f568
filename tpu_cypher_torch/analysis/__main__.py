"""CLI: ``python -m tpu_cypher_torch.analysis [options] [paths...]``.

Exit codes: 0 clean, 1 findings, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from .baseline import save as save_baseline
from .runner import (
    DEFAULT_BASELINE,
    ENGINE_ROOT,
    format_report,
    run_paths,
)
from .rules import ALL_RULES, RULES_BY_ID


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_cypher_torch.analysis",
        description=(
            "Engine-aware static analysis of the port: host syncs, kernel "
            "launches, config, exception and concurrency invariants, and "
            "the shape pack over the bucket lattice."
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: the tpu_cypher_torch "
        "package)",
    )
    p.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="report format (default: text)",
    )
    p.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help="grandfathered-findings file (default: the committed, empty "
        "analysis/baseline.json); pass an empty string for no baseline",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="write all current blocking findings to --baseline and exit 0 "
        "(the adoption ratchet)",
    )
    p.add_argument(
        "--rules",
        default="",
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--facts-out",
        default="",
        metavar="PATH",
        help="write the shape interpreter's facts (schema-versioned "
        "per-operator padded-shape formulas plus every classified size "
        "site) as JSON to PATH",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule table and exit",
    )
    p.add_argument(
        "--changed-only",
        action="store_true",
        help="check only files git reports modified/untracked; the whole "
        "tree is still parsed so cross-module (interprocedural) facts stay "
        "complete",
    )
    return p


def _git_changed_files() -> Optional[List[str]]:
    """Absolute paths of the .py files git reports changed (staged,
    unstaged, or untracked) in the repo containing the engine package.
    None when git is unavailable or this is not a work tree."""
    cwd = os.path.dirname(ENGINE_ROOT)
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            cwd=cwd, capture_output=True, text=True, timeout=10,
        )
        if top.returncode != 0:
            return None
        root = top.stdout.strip()
        st = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        if st.returncode != 0:
            return None
    except (OSError, subprocess.SubprocessError):
        return None
    changed: List[str] = []
    for line in st.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:  # rename: lint the new name
            path = path.split(" -> ", 1)[1]
        path = path.strip().strip('"')
        if path.endswith(".py"):
            changed.append(os.path.join(root, path))
    return changed


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:20s} {rule.title}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rule_ids if r not in RULES_BY_ID]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    paths = args.paths or [ENGINE_ROOT]
    baseline = args.baseline or None

    restrict = None
    if args.changed_only:
        restrict = _git_changed_files()
        if restrict is None:
            print("--changed-only needs a git work tree", file=sys.stderr)
            return 2

    try:
        report = run_paths(
            paths, rules=rule_ids, baseline_path=baseline, restrict_to=restrict
        )
    except ValueError as exc:  # malformed baseline
        print(str(exc), file=sys.stderr)
        return 2

    if args.write_baseline:
        if not baseline:
            print("--write-baseline needs --baseline", file=sys.stderr)
            return 2
        save_baseline(baseline, report.blocking)
        print(
            f"wrote {len(report.blocking)} finding(s) to {baseline}"
        )
        return 0

    print(format_report(report, args.format))

    if args.facts_out:
        from .shapes import collect_facts

        facts = collect_facts(report.project)
        with open(args.facts_out, "w") as f:
            json.dump(facts, f, indent=2, sort_keys=True)
            f.write("\n")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
