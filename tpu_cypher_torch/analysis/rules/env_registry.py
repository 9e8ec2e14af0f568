"""env-var-registry: every ``TPU_CYPHER_*`` knob flows through the typed
registry in ``utils/config.py``.

A raw ``os.environ.get("TPU_CYPHER_X")`` is invisible configuration: no
type, no default policy, no in-process override for tests, no single place
an operator can enumerate the engine's knobs — and the same var drifts to
different defaults in different modules (the ``TPU_CYPHER_PRINT_TIMINGS``
duplication that motivated this rule). Declarations themselves must live
in the config module: a ``ConfigOption`` constructed elsewhere is a
declaration the registry cannot see.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Finding, Rule, dotted_name
from ..project import CONFIG_MODULE_SUFFIX, ProjectContext

ENV_PREFIX = "TPU_CYPHER_"
_CTOR_NAMES = ("ConfigOption", "ConfigFlag")


def _env_key(node: ast.AST):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class EnvVarRegistryRule(Rule):
    id = "env-var-registry"
    title = "TPU_CYPHER_* reads go through the typed config registry"
    rationale = (
        "raw env reads have no type, default policy, or test override; "
        "declarations outside utils/config.py are invisible to the registry"
    )

    def check(
        self, ctx: FileContext, project: ProjectContext
    ) -> Iterator[Finding]:
        in_config = ctx.relpath.endswith(CONFIG_MODULE_SUFFIX)
        for call in ctx.calls:
            name = dotted_name(call.func)
            # raw reads: os.environ.get / os.getenv / os.environ.setdefault
            if name in ("os.environ.get", "os.getenv", "os.environ.setdefault"):
                key = _env_key(call.args[0]) if call.args else None
                if key and key.startswith(ENV_PREFIX) and not in_config:
                    yield ctx.finding(
                        self.id,
                        call,
                        f"raw env read of {key!r} — declare it in "
                        "utils/config.py and read through the typed option",
                    )
                continue
            # declarations outside the registry module
            last = name.split(".")[-1]
            if last in _CTOR_NAMES and not in_config:
                key = _env_key(call.args[0]) if call.args else None
                label = f" for {key!r}" if key else ""
                yield ctx.finding(
                    self.id,
                    call,
                    f"{last} constructed{label} outside utils/config.py — "
                    "declare the option in the registry and import it",
                )
        # raw subscript reads: os.environ["TPU_CYPHER_X"]
        if in_config:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Subscript):
                continue
            if dotted_name(node.value) != "os.environ":
                continue
            key = _env_key(node.slice)
            if key and key.startswith(ENV_PREFIX):
                yield ctx.finding(
                    self.id,
                    node,
                    f"raw env subscript of {key!r} — declare it in "
                    "utils/config.py and read through the typed option",
                )
        # reads through the registry of names nobody declared (typo guard);
        # only when the config module is part of the analyzed set
        if project.declared_env_vars is None:
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                v = node.value
                if (
                    v.startswith(ENV_PREFIX)
                    and v != ENV_PREFIX
                    and "=" not in v
                    and " " not in v
                    and v.rstrip("*") == v
                    and v not in project.declared_env_vars
                ):
                    yield ctx.finding(
                        self.id,
                        node,
                        f"env var literal {v!r} is not declared in the "
                        "utils/config.py registry",
                    )
