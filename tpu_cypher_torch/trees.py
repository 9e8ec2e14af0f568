"""Tree rewriting substrate.

Re-design of ``okapi-trees`` (``TreeNode.scala:47``, ``AbstractTreeNode.scala:55``,
``TreeTransformerStackSafe.scala:63``): self-typed immutable rewritable trees with
bottom-up / top-down rewriting, folds and pretty-printing.

Python adaptation: tree nodes are frozen dataclasses; children are discovered by
introspecting dataclass fields whose values are ``TreeNode`` instances or
tuples/lists of them (cached per class, mirroring the reference's cached
product-args copy in ``AbstractTreeNode.scala:55``). All rewrites are iterative
(explicit work stacks), matching the reference's stack-safe transformers —
deep plan trees (e.g. unrolled var-length expands) must not hit Python's
recursion limit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Type, TypeVar

T = TypeVar("T", bound="TreeNode")

_CHILD_FIELD_CACHE: Dict[type, Tuple[str, ...]] = {}


def _field_names(cls: type) -> Tuple[str, ...]:
    names = _CHILD_FIELD_CACHE.get(cls)
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(cls))
        _CHILD_FIELD_CACHE[cls] = names
    return names


class TreeNode:
    """Mixin for frozen dataclasses forming rewritable trees."""

    __slots__ = ()

    # -- children ---------------------------------------------------------

    @property
    def children(self) -> Tuple["TreeNode", ...]:
        out: List[TreeNode] = []
        for name in _field_names(type(self)):
            v = getattr(self, name)
            if isinstance(v, TreeNode):
                out.append(v)
            elif isinstance(v, (tuple, list)):
                out.extend(c for c in v if isinstance(c, TreeNode))
        return tuple(out)

    def with_new_children(self: T, new_children: Tuple["TreeNode", ...]) -> T:
        """Rebuild this node with children replaced positionally."""
        if not new_children and not self.children:
            return self
        it = iter(new_children)
        updates: Dict[str, Any] = {}
        changed = False
        for name in _field_names(type(self)):
            v = getattr(self, name)
            if isinstance(v, TreeNode):
                nv = next(it)
                if nv is not v:
                    changed = True
                updates[name] = nv
            elif isinstance(v, (tuple, list)):
                elems = []
                any_tree = False
                for c in v:
                    if isinstance(c, TreeNode):
                        any_tree = True
                        nc = next(it)
                        if nc is not c:
                            changed = True
                        elems.append(nc)
                    else:
                        elems.append(c)
                if any_tree:
                    updates[name] = tuple(elems) if isinstance(v, tuple) else list(elems)
        if not changed:
            return self
        return dataclasses.replace(self, **updates)  # type: ignore[type-var]

    # -- traversal --------------------------------------------------------

    def iter_nodes(self) -> Iterator["TreeNode"]:
        """Pre-order iteration (iterative)."""
        stack: List[TreeNode] = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    @property
    def height(self) -> int:
        h = 0
        stack: List[Tuple[TreeNode, int]] = [(self, 1)]
        while stack:
            node, d = stack.pop()
            h = max(h, d)
            for c in node.children:
                stack.append((c, d + 1))
        return h

    @property
    def size(self) -> int:
        return sum(1 for _ in self.iter_nodes())

    def exists(self, pred: Callable[["TreeNode"], bool]) -> bool:
        return any(pred(n) for n in self.iter_nodes())

    def collect(self, fn: Callable[["TreeNode"], Optional[Any]]) -> List[Any]:
        out = []
        for n in self.iter_nodes():
            v = fn(n)
            if v is not None:
                out.append(v)
        return out

    def collect_nodes(self, cls) -> List[Any]:
        return [n for n in self.iter_nodes() if isinstance(n, cls)]

    # -- rewriting (stack-safe, reference TreeTransformerStackSafe) --------

    def rewrite(self: T, rule: Callable[["TreeNode"], "TreeNode"]) -> T:
        """Bottom-up rewrite: children first, then the node (``TreeNode.rewrite``)."""
        return _rewrite_bottom_up(self, rule)

    def rewrite_top_down(self: T, rule: Callable[["TreeNode"], "TreeNode"]) -> T:
        """Top-down rewrite: node first, then recurse into its (new) children."""
        return _rewrite_top_down(self, rule)

    def transform(self, fn: Callable[["TreeNode", List[Any]], Any]) -> Any:
        """Bottom-up fold: ``fn(node, child_results)`` (``TreeNode.transform``)."""
        # post-order iterative fold
        results: Dict[int, Any] = {}
        stack: List[Tuple[TreeNode, bool]] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                child_vals = [results[id(c)] for c in node.children]
                results[id(node)] = fn(node, child_vals)
            else:
                stack.append((node, True))
                for c in reversed(node.children):
                    stack.append((c, False))
        return results[id(self)]

    # -- pretty printing ---------------------------------------------------

    def _show_inner(self) -> str:
        """Non-child args to display; override for custom rendering."""
        parts = []
        for name in _field_names(type(self)):
            v = getattr(self, name)
            if isinstance(v, TreeNode):
                continue
            if isinstance(v, (tuple, list)) and any(isinstance(c, TreeNode) for c in v):
                continue
            parts.append(f"{name}={v!r}")
        return ", ".join(parts)

    def pretty(self) -> str:
        """ASCII tree rendering (reference ``TreeNode.pretty``)."""
        lines: List[str] = []

        def label(n: TreeNode) -> str:
            inner = n._show_inner()
            return f"{type(n).__name__}({inner})" if inner else type(n).__name__

        # iterative DFS with prefixes
        stack: List[Tuple[TreeNode, str, bool, bool]] = [(self, "", True, True)]
        while stack:
            node, prefix, is_last, is_root = stack.pop()
            if is_root:
                lines.append(label(node))
                child_prefix = ""
            else:
                connector = "╚═" if is_last else "╠═"
                lines.append(prefix + connector + label(node))
                child_prefix = prefix + ("  " if is_last else "║ ")
            kids = node.children
            for i in range(len(kids) - 1, -1, -1):
                stack.append((kids[i], child_prefix, i == len(kids) - 1, False))
        return "\n".join(lines)


def _rewrite_bottom_up(root: T, rule: Callable[[TreeNode], TreeNode]) -> T:
    results: Dict[int, TreeNode] = {}
    stack: List[Tuple[TreeNode, bool]] = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if expanded:
            new_children = tuple(results[id(c)] for c in node.children)
            rebuilt = node.with_new_children(new_children)
            results[id(node)] = rule(rebuilt)
        else:
            stack.append((node, True))
            for c in reversed(node.children):
                stack.append((c, False))
    return results[id(root)]  # type: ignore[return-value]


def _rewrite_top_down(root: T, rule: Callable[[TreeNode], TreeNode]) -> T:
    new_root = rule(root)

    # process: rewrite children of node top-down, iteratively.
    # We model the continuation as: (node, state) where state tracks child idx.
    # Simpler approach: recursion-free via explicit result reconstruction.
    class Frame:
        __slots__ = ("node", "kids", "done", "idx")

        def __init__(self, node: TreeNode):
            self.node = node
            self.kids = node.children
            self.done: List[TreeNode] = []
            self.idx = 0

    top = Frame(new_root)
    stack = [top]
    while True:
        f = stack[-1]
        if f.idx < len(f.kids):
            child = rule(f.kids[f.idx])
            f.idx += 1
            stack.append(Frame(child))
        else:
            rebuilt = f.node.with_new_children(tuple(f.done))
            stack.pop()
            if not stack:
                return rebuilt  # type: ignore[return-value]
            stack[-1].done.append(rebuilt)
