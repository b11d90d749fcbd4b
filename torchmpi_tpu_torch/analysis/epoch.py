"""Resize-epoch cache-coherence lint (rule TPL007).

The port's copy of ``torchmpi_tpu/analysis/epoch.py``, unchanged (the
port's live resize waits for ROADMAP A10; the rule already holds its
caches to the contract).

Live elastic resharding (``torchmpi_tpu/reshard``) can change the world
size WITHOUT restarting the process: ``engine.resize``, an elastic
membership change, or a PS chain re-formation all bump the
``resize_epoch`` constant — which advances ``constants.generation()``,
the monotone counter every world-derived cache is expected to embed in
its keys (the dispatch memos, the plan cache, the compiled-reshard
cache all do). A cache whose key bakes in a world-size-derived value
(``comm.size``, ``world``, ``process_count()``) *without* a
``generation()`` / ``resize_epoch`` component keeps serving entries
compiled for the OLD world after a resize — the silent-staleness bug
class this rule makes structural.

Heuristic (intraprocedural, deliberately conservative):

- a **cache access** is a subscript store/load or a ``.get`` /
  ``.setdefault`` / ``.pop`` call on a name matching ``cache``/``memo``
  (suffix-insensitive);
- its **key expression** (simple ``name = (...)`` assignments in the
  same scope are resolved one hop) is world-derived when it reads a
  ``.size`` attribute, a name containing ``world``, or calls
  ``size()`` / ``process_count()`` / ``num_processes()``;
- the access is CLEAN when the key also calls ``generation()`` or
  reads ``resize_epoch`` (either literally in a ``get``/``set`` string
  or as an attribute).

Passing a variable that happens to hold a world size through a
non-cache-named dict is out of scope — naming the container is the
opt-in, same as the reference's ``_cache`` suffix conventions.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from .core import Finding, SourceFile, attr_chain, expr_source, walk_scope

_CACHE_NAME = re.compile(r"(cache|memo)s?(\b|_|$)", re.IGNORECASE)
_WORLD_NAME = re.compile(r"world", re.IGNORECASE)
_WORLD_CALLS = {"size", "process_count", "num_processes"}
_EPOCH_NAMES = {"generation", "resize_epoch"}


def _cache_target(node: ast.AST) -> Optional[str]:
    """The cache-ish name a subscript/get call operates on, or None."""
    chain = attr_chain(node)
    if not chain:
        return None
    name = chain[-1]
    return name if _CACHE_NAME.search(name) else None


def _mentions_world(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr == "size":
            return True
        if isinstance(node, ast.Name) and _WORLD_NAME.search(node.id):
            return True
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in _WORLD_CALLS:
                return True
    return False


def _mentions_epoch(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in _EPOCH_NAMES:
                return True
            # constants.get("resize_epoch")
            if (
                chain
                and chain[-1] == "get"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "resize_epoch"
            ):
                return True
        if isinstance(node, ast.Attribute) and node.attr in _EPOCH_NAMES:
            return True
        if isinstance(node, ast.Name) and node.id in _EPOCH_NAMES:
            return True
    return False


class _Scopes(ast.NodeVisitor):
    def __init__(self, tree: ast.AST):
        self.scopes = [list(tree.body)] if hasattr(tree, "body") else []
        self.visit(tree)

    def visit_FunctionDef(self, node):
        self.scopes.append(list(node.body))
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def check_stale_world_cache(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for body in _Scopes(sf.tree).scopes:
        scope = ast.Module(body=body, type_ignores=[])
        # one-hop key resolution: `key = (...)` then `cache.get(key)`
        assigns: Dict[str, ast.AST] = {}
        for node in walk_scope(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
                isinstance(node.targets[0], ast.Name)
            ):
                assigns[node.targets[0].id] = node.value

        def key_expr(expr: ast.AST) -> ast.AST:
            if isinstance(expr, ast.Name) and expr.id in assigns:
                return assigns[expr.id]
            return expr

        seen = set()
        for node in walk_scope(scope):
            target = key = None
            if isinstance(node, ast.Subscript):
                target = _cache_target(node.value)
                key = key_expr(node.slice)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if (
                    chain
                    and len(chain) >= 2
                    and chain[-1] in ("get", "setdefault", "pop")
                    and node.args
                ):
                    target = (
                        chain[-2]
                        if _CACHE_NAME.search(chain[-2]) else None
                    )
                    key = key_expr(node.args[0])
            if target is None or key is None:
                continue
            if not _mentions_world(key) or _mentions_epoch(key):
                continue
            if (target, node.lineno) in seen:
                continue
            seen.add((target, node.lineno))
            findings.append(Finding(
                "TPL007", sf.display, node.lineno,
                f"cache '{target}' is keyed on world-size-derived state "
                f"({expr_source(key)}) without a generation()/"
                "resize_epoch component — entries go stale across a "
                "live resize epoch",
                hint="append constants.generation() (or the resize_epoch "
                "knob) to the cache key so a resize invalidates it "
                "coherently",
            ))
    return findings


def check_file(sf: SourceFile) -> List[Finding]:
    return check_stale_world_cache(sf)
