"""Collective-contract checks (rules TPL001-TPL006).

The port's copy of ``torchmpi_tpu/analysis/contracts.py`` (stdlib
``ast`` only). Two changes: TPL005 recognises ``torchmpi_tpu_torch`` as
the package whose ``start()``/``stop()`` open and close the window, and
its hints name it. TPL004 keeps the JAX pattern it checks,
``jax.jit(f, donate_argnums=...)``: PyTorch has no buffer donation, so
the rule finds nothing in the port's own code, and it still lints JAX
code handed to it.

The contract every SPMD program implicitly signs: all ranks of a
communicator issue the *same* collective sequence (else the world
desyncs — the exact bug shape the runtime flight-recorder analyzer
diagnoses post-mortem), every async handle is eventually waited (else
completion is silently unordered and backpressure accounting leaks),
donated device buffers are dead after the donating call, and no
collective runs outside the ``start()``/``stop()`` window.

All checks are intraprocedural and deliberately conservative: a handle
that *escapes* (returned, stored, passed to any call) is assumed
waited by someone; only provably-dropped handles are flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile, attr_chain, expr_source, walk_scope

# Names whose call (or bare variable read) makes an expression
# rank-dependent. process_count()/size() are NOT here: they evaluate the
# same on every rank.
RANK_SOURCES = {"rank", "local_ranks", "process_index"}

# The public collective surface (collectives/__init__.py) plus the eager
# entry points. Terminal attribute/name matches: `mpi.allreduce_tensor`,
# `mpi.ring.allreduce_tensor`, bare `allreduce_tensor` after a
# from-import all count.
COLLECTIVE_NAMES = {
    "broadcast_tensor", "reduce_tensor", "allreduce_tensor",
    "allgather_tensor", "allgatherv_tensor", "sendreceive_tensor",
    "reducescatter_tensor", "alltoall_tensor",
    "broadcast_scalar", "allreduce_scalar", "reduce_scalar",
    "sendreceive_scalar", "barrier",
    "run", "run_async", "run_fused", "run_allgatherv",
    "synchronize_gradients", "synchronize_parameters",
    "check_with_allreduce", "allreduce_async",
}
# `run`/`barrier` as a BARE name is too generic to claim; require an
# attribute chain for these (eager.run / mpi.barrier).
_ATTR_ONLY = {"run", "barrier"}

# Calls that produce SyncHandles: anything reached through the async_
# namespace, eager.run_async, and GradientBuckets.allreduce_async.
ASYNC_TERMINALS = {"run_async", "allreduce_async"}

_WAIT_NAMES = {"wait", "sync_all", "wait_and_unflatten"}


def _is_collective_call(node: ast.Call) -> Optional[str]:
    chain = attr_chain(node.func)
    if not chain:
        return None
    name = chain[-1]
    if name not in COLLECTIVE_NAMES:
        return None
    if len(chain) == 1 and name in _ATTR_ONLY:
        return None
    return name


def _is_async_call(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    if not chain:
        return False
    if chain[-1] in ASYNC_TERMINALS:
        return True
    # mpi.async_.allreduce_tensor / async_.ring.allreduce_tensor
    return "async_" in chain[:-1] and chain[-1] in COLLECTIVE_NAMES


def _is_rank_dependent(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in RANK_SOURCES:
                return True
        elif isinstance(node, ast.Name) and node.id == "rank":
            # the `rank = mpi.rank(); if rank == 0:` idiom
            return True
    return False


def _collective_sequence(body: Sequence[ast.stmt]) -> List[Tuple[str, int]]:
    """Ordered (op, line) sequence of collective calls in a statement
    list, recursing into nested control flow but not nested defs."""
    out: List[Tuple[str, int]] = []
    for stmt in body:
        for node in walk_scope(stmt):
            if isinstance(node, ast.Call):
                op = _is_collective_call(node)
                if op:
                    out.append((op, node.lineno))
    return out


def _terminates(body: Sequence[ast.stmt]) -> bool:
    """Does the block end control flow (return/raise/continue/break)?"""
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


class _FunctionScopes(ast.NodeVisitor):
    """Collect every function body (plus the module body) as a scope."""

    def __init__(self, tree: ast.AST):
        self.scopes: List[Tuple[str, Sequence[ast.stmt]]] = [
            ("<module>", tree.body)
        ]
        self.visit(tree)

    def visit_FunctionDef(self, node):
        self.scopes.append((node.name, node.body))
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def check_rank_divergence(sf: SourceFile) -> List[Finding]:
    """TPL001/TPL002: collectives under rank-dependent control flow."""
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.If, ast.While)):
            continue
        if not _is_rank_dependent(node.test):
            continue
        body_seq = _collective_sequence(node.body)
        else_seq = _collective_sequence(node.orelse)
        if isinstance(node, ast.While):
            if body_seq:
                op, line = body_seq[0]
                findings.append(Finding(
                    "TPL001", sf.display, line,
                    f"collective '{op}' issued inside a while-loop whose "
                    f"condition depends on the rank "
                    f"({expr_source(node.test)}): ranks iterate different "
                    "numbers of times and desync",
                    hint="make the loop bound rank-invariant, or hoist the "
                    "collective out of the loop",
                ))
            continue
        body_ops = [op for op, _ in body_seq]
        else_ops = [op for op, _ in else_seq]
        if body_ops == else_ops:
            continue  # both arms issue the identical sequence: legal
        if body_ops and else_ops:
            op, line = (body_seq or else_seq)[0]
            findings.append(Finding(
                "TPL002", sf.display, line,
                f"rank-dependent branch ({expr_source(node.test)}) arms "
                f"issue mismatched collective sequences "
                f"{body_ops} vs {else_ops}",
                hint="all ranks must issue the same collective sequence; "
                "restructure so both arms match, or hoist the collectives "
                "out of the branch",
            ))
        else:
            seq = body_seq or else_seq
            op, line = seq[0]
            findings.append(Finding(
                "TPL001", sf.display, line,
                f"collective '{op}' issued only when "
                f"{expr_source(node.test)} — other ranks never enter this "
                "collective and the world desyncs",
                hint="issue the collective unconditionally on every rank "
                "(guard only the rank-local work, not the collective)",
            ))
    # early-exit divergence: `if rank() != 0: return` followed by
    # collectives in the enclosing block
    for fname, body in _FunctionScopes(sf.tree).scopes:
        findings.extend(_check_early_exit(sf, body))
    return findings


def _check_early_exit(sf: SourceFile, body: Sequence[ast.stmt]) -> List[Finding]:
    findings: List[Finding] = []
    for i, stmt in enumerate(body):
        if (
            isinstance(stmt, ast.If)
            and _is_rank_dependent(stmt.test)
            and _terminates(stmt.body)
            and not stmt.orelse
            and not _collective_sequence(stmt.body)
        ):
            after = _collective_sequence(body[i + 1:])
            if after:
                op, line = after[0]
                findings.append(Finding(
                    "TPL001", sf.display, line,
                    f"collective '{op}' is unreachable for ranks taking "
                    f"the early exit at line {stmt.lineno} "
                    f"({expr_source(stmt.test)})",
                    hint="every rank must reach the collective; move the "
                    "rank-guarded early exit below it",
                ))
        # recurse into nested blocks so guarded regions are checked too
        for sub in getattr(stmt, "body", []), getattr(stmt, "orelse", []):
            if sub and not isinstance(stmt, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                findings.extend(_check_early_exit(sf, sub))
    return findings


# ---------------------------------------------------------------------------
# TPL003: leaked SyncHandles
# ---------------------------------------------------------------------------


def _parent_map(root: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def _name_is_waited(name: str, scope: ast.AST, after_line: int) -> bool:
    """Does `name` escape or get waited anywhere after ``after_line``?

    Conservative: ANY use other than a bare read absolves it — returned,
    yielded, stored, subscripted, passed to a call, iterated, waited.
    Only a handle that is never touched again is a leak.
    """
    for node in walk_scope(scope):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in _WAIT_NAMES and not node.args \
                    and chain[:-1] != [name]:
                # a bare sync_all() drains the global handle table
                if chain[-1] == "sync_all":
                    return True
        if (
            isinstance(node, ast.Name)
            and node.id == name
            and isinstance(node.ctx, ast.Load)
            and node.lineno > after_line
        ):
            return True
    return False


def check_leaked_handles(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    parents = _parent_map(sf.tree)
    for fname, body in _FunctionScopes(sf.tree).scopes:
        scope_root = ast.Module(body=list(body), type_ignores=[])
        for node in walk_scope(scope_root):
            if not (isinstance(node, ast.Call) and _is_async_call(node)):
                continue
            parent = parents.get(id(node))
            if isinstance(parent, ast.Expr):
                findings.append(Finding(
                    "TPL003", sf.display, node.lineno,
                    f"result of async collective "
                    f"'{expr_source(node.func)}' is discarded — the "
                    "SyncHandle is never waited",
                    hint="assign the handle and wait() it (or call "
                    "sync_all() before results are consumed)",
                ))
                continue
            if isinstance(parent, ast.Assign) and all(
                isinstance(t, ast.Name) for t in parent.targets
            ):
                for t in parent.targets:
                    if not _name_is_waited(t.id, scope_root, parent.lineno):
                        findings.append(Finding(
                            "TPL003", sf.display, node.lineno,
                            f"SyncHandle '{t.id}' from async collective is "
                            "never waited, returned, or stored",
                            hint=f"call {t.id}.wait() (or mpi.wait/"
                            "sync_all) before the function exits",
                        ))
    return findings


# ---------------------------------------------------------------------------
# TPL004: donated buffers read after donation
# ---------------------------------------------------------------------------


def _donated_positions(call: ast.Call) -> Optional[Tuple[int, ...]]:
    """For `jax.jit(f, donate_argnums=...)`: the donated positions."""
    chain = attr_chain(call.func)
    if not chain or chain[-1] != "jit":
        return None
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            try:
                val = ast.literal_eval(kw.value)
            except ValueError:
                return None
            if isinstance(val, int):
                return (val,)
            if isinstance(val, (tuple, list)):
                return tuple(int(v) for v in val)
    return None


def check_donated_reuse(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for fname, body in _FunctionScopes(sf.tree).scopes:
        scope_root = ast.Module(body=list(body), type_ignores=[])
        jitted: Dict[str, Tuple[int, ...]] = {}
        for node in walk_scope(scope_root):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                pos = _donated_positions(node.value)
                if pos is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            jitted[t.id] = pos
        if not jitted:
            continue
        parents = _parent_map(scope_root)
        for node in walk_scope(scope_root):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in jitted
            ):
                continue
            for pos in jitted[node.func.id]:
                if pos >= len(node.args):
                    continue
                arg = node.args[pos]
                if not isinstance(arg, ast.Name):
                    continue
                parent = parents.get(id(node))
                if isinstance(parent, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == arg.id
                    for t in parent.targets
                ):
                    continue  # `buf = fn(buf, ...)`: immediate rebind
                leak = _read_after(scope_root, arg.id, node.lineno)
                if leak is not None:
                    findings.append(Finding(
                        "TPL004", sf.display, leak,
                        f"'{arg.id}' is read at line {leak} after being "
                        f"donated to jitted '{node.func.id}' at line "
                        f"{node.lineno} — the donated buffer is dead "
                        "(XLA may have aliased its memory)",
                        hint="use the function's result instead of the "
                        "donated input, or drop donate_argnums",
                    ))
    return findings


def _read_after(scope: ast.AST, name: str, line: int) -> Optional[int]:
    """First Load of ``name`` after ``line`` with no intervening rebind."""
    events: List[Tuple[int, str]] = []
    for node in walk_scope(scope):
        if isinstance(node, ast.Name) and node.id == name:
            if node.lineno <= line:
                continue
            kind = "store" if isinstance(node.ctx, (ast.Store, ast.Del)) \
                else "load"
            events.append((node.lineno, kind))
    for ln, kind in sorted(events):
        if kind == "store":
            return None  # rebound before any read: fresh value
        return ln
    return None


# ---------------------------------------------------------------------------
# TPL006: literal routing kwarg outside schedule/
# ---------------------------------------------------------------------------

# the legacy escape hatches the schedule compiler absorbed: routing is a
# PLAN attribute now, decided by the compiler (cost model + autotuner
# overrides), not a per-call-site kwarg
_ROUTING_KWARGS = {"impl", "staged_intra", "ring_impl"}

# callees the rule applies to: the collective surface plus the
# generator-pinning wrappers that still accept routing kwargs —
# `impl=` on an unrelated library call is not our business, and the
# compiler's own pin surface (compile_collective / pinned_plan, the
# sanctioned mechanism) is not in this set
_ROUTED_CALLEES = COLLECTIVE_NAMES | {
    "run_hierarchical_allreduce",
    "run_hierarchical_collective",
    "run_tree_hierarchical_allreduce",
}


def _in_schedule_package(sf: SourceFile) -> bool:
    parts = sf.display.replace("\\", "/").split("/")
    return "schedule" in parts


def check_literal_routing(sf: SourceFile) -> List[Finding]:
    """TPL006: a call passing a literal routing kwarg (``impl='pallas'``,
    ``staged_intra='ring'``, ``ring_impl=...``) outside ``schedule/``.

    The schedule compiler owns routing: flat/hierarchical/staged/tree is
    a cost-modeled (and autotunable) plan decision, and a call site that
    pins it with a string literal silently bypasses the cost model, the
    measured ``tune_plan`` overrides, AND the plan cache keying — the
    exact escape hatch the compiler deleted. Passing a *variable*
    through (plumbing someone else's decision) is fine; hardcoding the
    schedule family at a call site is not. The generator-pinning
    wrappers delegate to the compiler's pin surface
    (``compile_collective``/``pinned_plan``), which is exempt."""
    if _in_schedule_package(sf):
        return []
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or chain[-1] not in _ROUTED_CALLEES:
            continue
        for kw in node.keywords:
            if kw.arg in _ROUTING_KWARGS and isinstance(
                kw.value, ast.Constant
            ):
                findings.append(Finding(
                    "TPL006", sf.display, node.lineno,
                    f"collective call passes literal routing kwarg "
                    f"{kw.arg}={kw.value.value!r} outside schedule/ — "
                    "the schedule compiler owns this decision (cost "
                    "model + tune_plan overrides), and a hardcoded "
                    "family bypasses both",
                    hint="drop the kwarg and let schedule.compile() "
                    "choose, or plumb a variable through; pin a "
                    "generator only via the run_hierarchical_* wrappers "
                    "/ compile_collective",
                ))
    return findings


# ---------------------------------------------------------------------------
# TPL005: collectives outside the start()/stop() window
# ---------------------------------------------------------------------------


def _lifecycle_aliases(tree: ast.AST) -> Set[str]:
    """Module aliases that refer to the torchmpi_tpu_torch package."""
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torchmpi_tpu_torch":
                    aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torchmpi_tpu_torch":
                for a in node.names:
                    if a.name in ("start", "stop"):
                        aliases.add("<bare>")
    return aliases


def _lifecycle_calls(body: Sequence[ast.stmt], aliases: Set[str], which: str
                     ) -> List[int]:
    lines = []
    for stmt in body:
        for node in walk_scope(stmt):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if chain == [which] and "<bare>" in aliases:
                lines.append(node.lineno)
            elif (
                len(chain) == 2 and chain[1] == which and chain[0] in aliases
            ):
                lines.append(node.lineno)
    return lines


def check_lifecycle(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    aliases = _lifecycle_aliases(sf.tree)
    if not aliases:
        return findings
    for fname, body in _FunctionScopes(sf.tree).scopes:
        starts = _lifecycle_calls(body, aliases, "start")
        stops = _lifecycle_calls(body, aliases, "stop")
        if not starts and not stops:
            continue
        # collectives directly in this scope (nested defs run later, at an
        # unknowable time — skip them)
        seq = []
        for stmt in body:
            for node in walk_scope(stmt):
                if isinstance(node, ast.Call):
                    op = _is_collective_call(node)
                    if op:
                        seq.append((op, node.lineno))
        for op, line in seq:
            if starts and line < min(starts):
                findings.append(Finding(
                    "TPL005", sf.display, line,
                    f"collective '{op}' invoked before start() "
                    f"(line {min(starts)})",
                    hint="move the collective after torchmpi_tpu_torch.start()",
                ))
            elif stops and line > max(stops):
                findings.append(Finding(
                    "TPL005", sf.display, line,
                    f"collective '{op}' invoked after stop() "
                    f"(line {max(stops)})",
                    hint="move the collective before torchmpi_tpu_torch.stop()",
                ))
    return findings


def check_file(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    out.extend(check_rank_divergence(sf))
    out.extend(check_leaked_handles(sf))
    out.extend(check_donated_reuse(sf))
    out.extend(check_lifecycle(sf))
    out.extend(check_literal_routing(sf))
    return out
