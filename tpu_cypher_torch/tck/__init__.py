"""openCypher-TCK-style conformance harness.

Re-design of the reference TCK integration (``okapi-tck/.../TCKFixture.scala:84``,
``TckSparkCypherTest.scala:39-76``): a gherkin-lite ``.feature`` parser, a TCK
expected-value grammar, a scenario runner adapting a
:class:`~tpu_cypher_torch.CypherSession`, and whitelist/blacklist partitioning where
a *passing blacklisted scenario fails the build* (false positive), keeping the
blacklist honest as coverage grows.
"""

from .gherkin import Feature, Scenario, Step, parse_feature
from .runner import ScenarioResult, ScenariosFor, TckRunner, load_features

__all__ = [
    "Feature",
    "Scenario",
    "ScenarioResult",
    "ScenariosFor",
    "Step",
    "TckRunner",
    "load_features",
    "parse_feature",
]
