"""The TCK on the port: ``tests/tck/features`` and ``tests/tck/blacklist``
through ``tpu_cypher_torch.tck`` and ``CypherSession.cuda(device="cpu")``,
one case per scenario, with ``tests/test_tck.py``'s rules:

* every whitelisted scenario passes;
* every blacklisted scenario fails (a pass is a false positive);
* the blacklist's entries resolve.

One rule is stricter than the runner's, which takes any exception for
"an error should be raised": an error scenario passes only where each error
the port raised is of the class the port's own ``CypherSession.local()``
oracle raises for that scenario. A refusal (``TpuUnsupportedExpr``) or a
device fault is never the expected error.

``UNANSWERED`` lists the whitelisted scenarios the port does not answer,
each with the ROADMAP.md entry that covers it. A listed scenario must
raise ``TpuUnsupportedExpr`` naming that entry, so one that starts to pass
fails here until it is taken off the list. The list only shrinks, and no
fault goes in it.
"""

import functools
import os

import pytest
import torch

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.tck import ScenariosFor, TckRunner, load_features
from tpu_cypher_torch.tck.runner import load_blacklist

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
FEATURES = os.path.join(HERE, "tck", "features")
BLACKLIST = os.path.join(HERE, "tck", "blacklist")

_scenarios = ScenariosFor(load_features(FEATURES), load_blacklist(BLACKLIST))
_port = TckRunner(functools.partial(CypherSession.cuda, device="cpu"))
_oracle = TckRunner(CypherSession.local)

# scenario -> the ROADMAP.md entry its refusal names
UNANSWERED = {
    'Feature "TemporalZoned": Scenario "zoned datetime properties order by instant"':
        "ROADMAP.md §3",
    'Feature "TemporalZoned": Scenario "datetime with a named zone resolves its offset"':
        "ROADMAP.md §3",
}


def test_unanswered_scenarios_are_whitelisted():
    white = {str(s) for s in _scenarios.white_list}
    assert set(UNANSWERED) <= white


@pytest.mark.parametrize("scenario", _scenarios.white_list, ids=lambda s: str(s))
def test_whitelist(scenario):
    r = _port.run(scenario)
    listed = UNANSWERED.get(str(scenario))
    if listed is not None:
        assert not r.passed and r.message.startswith("TpuUnsupportedExpr"), r.message
        assert listed in r.message, r.message
        return
    assert r.passed, r.message
    if r.errors:
        want = _oracle.run(scenario)
        assert want.passed, want.message
        assert [type(e) for e in r.errors] == [type(e) for e in want.errors], (
            r.errors, want.errors)


@pytest.mark.parametrize("scenario", _scenarios.black_list, ids=lambda s: str(s))
def test_blacklist_still_fails(scenario):
    r = _port.run(scenario)
    assert not r.passed, (
        f"Blacklisted scenario passed (false positive) — remove it from the "
        f"blacklist: {scenario}"
    )


def test_blacklist_entries_resolve():
    # ScenariosFor raises on unknown or stale entries; building it at module
    # scope is the check
    assert _scenarios.scenarios and _scenarios.black_list
