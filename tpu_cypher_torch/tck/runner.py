"""TCK scenario runner with whitelist/blacklist semantics.

Mirrors the reference harness behavior (``TCKFixture.scala:84-150``,
``TckSparkCypherTest.scala:39-76``): scenarios not on the blacklist MUST pass;
blacklisted scenarios MUST fail — a passing blacklisted scenario is itself an
error ("false positive"), which keeps the blacklist shrinking honestly.
Blacklist files are plain text, one scenario key per line, ``#`` comments
(reference resources ``morpheus-tck/src/test/resources/failing_blacklist`` etc).
"""

from __future__ import annotations

import glob
import math
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .gherkin import Feature, Scenario, parse_feature
from .tck_values import (
    normalize_expected_value,
    normalize_result_value,
    parse_tck_value,
)


class TckHarnessError(Exception):
    pass


@dataclass
class ScenarioResult:
    scenario: Scenario
    passed: bool
    message: str = ""
    # the errors that the scenario's "should be raised" steps consumed, in
    # order: a caller can hold their classes to another engine's
    errors: List[Exception] = field(default_factory=list)

    def __repr__(self):
        status = "PASS" if self.passed else "FAIL"
        return f"[{status}] {self.scenario}: {self.message}"


def load_features(feature_dir: str) -> List[Feature]:
    feats = []
    for path in sorted(glob.glob(os.path.join(feature_dir, "**", "*.feature"), recursive=True)):
        with open(path) as f:
            feats.append(parse_feature(f.read(), path))
    if not feats:
        raise TckHarnessError(f"No .feature files under {feature_dir}")
    return feats


def load_blacklist(*paths: str) -> frozenset:
    entries: List[str] = []
    for p in paths:
        with open(p) as f:
            for line in f:
                # strip trailing reason comments ("... # [unbounded]")
                line = line.split("  #", 1)[0].strip()
                if line and not line.startswith("#"):
                    entries.append(line)
    dupes = {e for e in entries if entries.count(e) > 1}
    if dupes:
        # the reference asserts the same (TCKFixture ScenariosFor apply)
        raise TckHarnessError(f"Blacklist contains duplicate scenarios: {sorted(dupes)}")
    return frozenset(entries)


class ScenariosFor:
    """Partition scenarios into whitelist and blacklist (reference
    ``ScenariosFor``, ``TCKFixture.scala:113-134``)."""

    def __init__(self, features: Sequence[Feature], blacklist: frozenset = frozenset()):
        self.scenarios: List[Scenario] = [s for f in features for s in f.scenarios]
        keys = {str(s) for s in self.scenarios}
        unknown = set(blacklist) - keys
        if unknown:
            raise TckHarnessError(
                f"Blacklist entries match no scenario: {sorted(unknown)}"
            )
        self.blacklist_keys = blacklist

    @property
    def white_list(self) -> List[Scenario]:
        return [s for s in self.scenarios if str(s) not in self.blacklist_keys]

    @property
    def black_list(self) -> List[Scenario]:
        return [s for s in self.scenarios if str(s) in self.blacklist_keys]

    def get(self, name: str) -> List[Scenario]:
        return [s for s in self.scenarios if s.name == name]


class TckRunner:
    """Executes scenarios against a session factory (the adapter role of the
    reference's ``TCKGraph``)."""

    def __init__(self, session_factory: Callable[[], object]):
        self.session_factory = session_factory

    # -- step execution ----------------------------------------------------

    def run(self, scenario: Scenario) -> ScenarioResult:
        try:
            return ScenarioResult(scenario, True, errors=self._run_steps(scenario))
        except AssertionError as e:
            return ScenarioResult(scenario, False, f"assertion: {e}")
        except Exception as e:  # fault-ok: scenario verdict — the failure IS the recorded result
            return ScenarioResult(scenario, False, f"{type(e).__name__}: {e}")

    def _run_steps(self, scenario: Scenario):
        session = self.session_factory()
        graph = None
        init_queries: List[str] = []
        parameters: Dict[str, object] = {}
        result = None
        error: Optional[Exception] = None
        raised: List[Exception] = []
        executed = False

        def build_graph():
            nonlocal graph
            if init_queries:
                graph = session.create_graph_from_create_query(
                    "\n".join(init_queries)
                )
            else:
                from ..relational.graphs import EmptyGraph
                from ..relational.session import PropertyGraph

                graph = PropertyGraph(session, EmptyGraph())

        for step in scenario.steps:
            text = step.text
            low = text.lower().rstrip(":")
            if low in ("an empty graph", "any graph", "an empty graph with no data"):
                init_queries = []
            elif low.startswith("having executed") or low.startswith(
                "after having executed"
            ):
                if step.docstring is None:
                    raise TckHarnessError(f"Step needs docstring: {step}")
                init_queries.append(step.docstring)
            elif low.startswith("parameters are") or low.startswith(
                "parameter values are"
            ):
                if not step.table:
                    raise TckHarnessError(f"Step needs table: {step}")
                for row in step.table:
                    if len(row) != 2:
                        raise TckHarnessError(f"Bad parameter row {row}")
                    parameters[row[0]] = _to_engine_value(parse_tck_value(row[1]))
            elif low.startswith("executing query") or low.startswith(
                "executing control query"
            ):
                if step.docstring is None:
                    raise TckHarnessError(f"Step needs docstring: {step}")
                build_graph()
                executed = True
                result, error = None, None
                try:
                    res = graph.cypher(step.docstring, dict(parameters))
                    records = res.records
                    result = list(records.collect()) if records is not None else []
                except Exception as e:  # noqa: BLE001 — fault-ok: error steps assert on this
                    error = e
            elif low.startswith("the result should be empty"):
                self._require_no_error(error)
                assert result == [], f"expected empty result, got {result}"
            elif low.startswith("the result should be"):
                self._require_no_error(error)
                assert executed, "no query executed"
                in_order = ", in order" in low
                ignore_list_order = "ignoring element order for lists" in low
                self._compare(step, result, in_order, ignore_list_order)
            elif "should be raised" in low:
                assert error is not None, (
                    f"expected an error ({text}) but the query succeeded"
                )
                raised.append(error)
                error = None  # consumed
            elif low.startswith("no side effects") or low.startswith(
                "the side effects should be"
            ):
                # engine is read-only over immutable device tables; CREATE-
                # style init queries run before execution, so side-effect
                # accounting is structurally impossible to violate
                pass
            else:
                raise TckHarnessError(f"Unsupported TCK step: {step}")
        if error is not None:
            raise error
        return raised

    @staticmethod
    def _require_no_error(error: Optional[Exception]):
        if error is not None:
            raise error

    def _compare(self, step, result, in_order: bool, ignore_list_order: bool):
        if step.table is None:
            raise TckHarnessError(f"Step needs table: {step}")
        header, *rows = step.table
        expected = []
        for row in rows:
            if len(row) != len(header):
                raise TckHarnessError(f"Ragged expected row {row}")
            expected.append(
                tuple(
                    normalize_expected_value(parse_tck_value(cell), ignore_list_order)
                    for cell in row
                )
            )
        got = []
        for rec in result:
            missing = [c for c in header if c not in rec]
            assert not missing, f"result lacks columns {missing}; has {list(rec)}"
            got.append(
                tuple(
                    normalize_result_value(rec[c], ignore_list_order) for c in header
                )
            )
        if in_order:
            assert got == expected, f"\nexpected (in order): {expected}\ngot: {got}"
        else:
            # true multiset equality — repr-based keys are NOT canonical
            # (equal frozensets may iterate, and so repr, in different orders
            # depending on insertion history)
            from collections import Counter

            assert Counter(got) == Counter(expected), (
                f"\nexpected (any order): {expected}\ngot: {got}"
            )

    # -- suite-level entry points -----------------------------------------

    def run_all(
        self, scenarios: ScenariosFor
    ) -> Tuple[List[ScenarioResult], List[ScenarioResult]]:
        """Returns (failures, false_positives): whitelisted scenarios that
        failed, and blacklisted scenarios that passed."""
        failures = [
            r for s in scenarios.white_list if not (r := self.run(s)).passed
        ]
        false_positives = [
            r for s in scenarios.black_list if (r := self.run(s)).passed
        ]
        return failures, false_positives


def _to_engine_value(v):
    """Parsed TCK parameter → engine-side value."""
    from .tck_values import TckNode, TckPath, TckRelationship

    if isinstance(v, (TckNode, TckRelationship, TckPath)):
        raise TckHarnessError("Graph elements are not valid parameters")
    if isinstance(v, list):
        return [_to_engine_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_engine_value(x) for k, x in v.items()}
    if isinstance(v, float) and math.isnan(v):
        return float("nan")
    return v
