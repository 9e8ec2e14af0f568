"""Standalone acceptance-test generation from TCK feature files.

Re-design of the reference's ``AcceptanceTestGenerator``
(``okapi-tck/.../AcceptanceTestGenerator.scala:36`` +
``morpheus-tck/src/generator/.../MorpheusTestGenerator.scala:34``): emits one
pytest module per feature, with whitelisted scenarios as plain tests and
blacklisted scenarios as ``xfail(strict=True)`` (a passing blacklisted
scenario fails the run — the same false-positive discipline as the live TCK
suite). The generated files are standalone: debugging one scenario no longer
means running the whole parametrized harness."""

from __future__ import annotations

import os
import re
from typing import Iterable, List, Optional, Sequence

from .gherkin import Feature
from .runner import ScenariosFor, load_blacklist, load_features

_HEADER = '''"""GENERATED acceptance tests from TCK feature {feature!r} — do not edit.

Regenerate with:
    python -m tpu_cypher_torch.tck.generator <features_dir> <out_dir> [blacklist]
(reference analog: AcceptanceTestGenerator.scala:36)."""

import pytest

import functools

from tpu_cypher_torch import CypherSession
from tpu_cypher_torch.tck.runner import TckRunner
from tpu_cypher_torch.tck.gherkin import parse_feature

_FEATURE_TEXT = {feature_text}

_runner = TckRunner({session_factory})
# indexed, not name-keyed: duplicate scenario names must each keep their steps
_scenarios = list(parse_feature(_FEATURE_TEXT).scenarios)


def _run(index, name):
    sc = _scenarios[index]
    assert str(sc) == name, f"feature drifted: {{str(sc)!r}} != {{name!r}}"
    r = _runner.run(sc)
    assert r.passed, r.message

'''

_WHITE_CASE = '''
def test_{safe_name}():
    _run({index}, {name!r})
'''

_BLACK_CASE = '''
@pytest.mark.xfail(strict=True, reason="blacklisted: not yet supported")
def test_{safe_name}():
    _run({index}, {name!r})
'''


# --session choice -> the session factory the generated module runs
_FACTORIES = {
    "local": "CypherSession.local",
    "cuda": "CypherSession.cuda",
    "cuda-cpu": 'functools.partial(CypherSession.cuda, device="cpu")',
}


def _safe(name: str) -> str:
    s = re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_").lower()
    return s or "scenario"


def generate_feature_module(
    feature: Feature,
    blacklisted: Iterable[str],
    session_factory: str = "local",
    keywords: Sequence[str] = (),
) -> Optional[str]:
    """Source text of one generated pytest module; None when ``keywords``
    filter out every scenario. Indices are positions in the FULL feature
    (the module re-parses the embedded source), so filtering never shifts
    them; duplicate scenario names each keep their own steps."""
    black = set(blacklisted)
    out = [
        _HEADER.format(
            feature=feature.name,
            feature_text=repr(feature.source),
            session_factory=_FACTORIES[session_factory],
        )
    ]
    used: set = set()
    emitted = 0
    for index, sc in enumerate(feature.scenarios):
        if keywords and not any(k in sc.name for k in keywords):
            continue
        base = _safe(sc.name)
        if sc.example_index is not None:
            base = f"{base}_ex{sc.example_index}"
        name = base
        i = 1
        while name in used:
            i += 1
            name = f"{base}_{i}"
        used.add(name)
        tpl = _BLACK_CASE if str(sc) in black else _WHITE_CASE
        out.append(tpl.format(safe_name=name, name=str(sc), index=index))
        emitted += 1
    if not emitted:
        return None
    return "".join(out)


def generate_all(
    features_dir: str,
    out_dir: str,
    blacklist_path: Optional[str] = None,
    session_factory: str = "local",
    keywords: Sequence[str] = (),
) -> List[str]:
    """Emit one ``test_tck_<feature>.py`` per feature; returns written paths.
    ``keywords`` restricts generation to scenarios whose name contains any
    keyword (reference ``generateGivenScenarios``)."""
    features = load_features(features_dir)
    black = load_blacklist(blacklist_path) if blacklist_path else []
    # validate blacklist scope exactly like the live harness
    ScenariosFor(features, black)
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    used_names: set = set()
    for f in features:
        src = generate_feature_module(f, black, session_factory, keywords)
        if src is None:
            continue
        # dedup module filenames: distinct features may sanitize identically
        base = f"test_tck_{_safe(f.name)}"
        name = base
        i = 1
        while name in used_names:
            i += 1
            name = f"{base}_{i}"
        used_names.add(name)
        path = os.path.join(out_dir, f"{name}.py")
        with open(path, "w") as fh:
            fh.write(src)
        written.append(path)
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("features_dir")
    p.add_argument("out_dir")
    p.add_argument("blacklist", nargs="?", default=None)
    p.add_argument("--session", default="local", choices=sorted(_FACTORIES))
    p.add_argument("--keyword", action="append", default=[])
    a = p.parse_args(argv)
    paths = generate_all(
        a.features_dir, a.out_dir, a.blacklist, a.session, a.keyword
    )
    for path in paths:
        print(path)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
