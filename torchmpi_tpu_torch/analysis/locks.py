"""Static lock-order analyzer (rules TPL101-TPL103).

The port's copy of ``torchmpi_tpu/analysis/locks.py``, unchanged.

Builds, per module, the static lock-acquisition graph: nodes are lock
*definitions* (``threading.Lock()`` / ``RLock`` / ``Condition`` or the
:mod:`.lockmon` factories, assigned to a module global, a ``self``
attribute, or a list/dict of locks), edges are "B acquired while A is
held" — from lexical ``with`` nesting plus an intraprocedural
same-module call graph (method/function calls propagate their callees'
acquisitions to the caller's held-set). A cycle in that graph is a
potential deadlock (TPL101); re-acquiring a held non-reentrant lock is
a guaranteed one (TPL103); and a blocking call — ``join``, ``result``,
``wait`` on a foreign object, ``shutdown(wait=True)``, ``sleep`` —
under any lock is a stall amplifier at best and a deadlock at worst
(TPL102).

The companion runtime monitor (:mod:`.lockmon`,
``TORCHMPI_TPU_LOCK_MONITOR=1``) records *actual* acquisition orders
during the test suite and fails on inversion, validating this static
graph against reality.

Explicit ``lock.release()`` inside a ``with`` block is honored: the
bounded-inflight pattern in ``parameterserver/server.py`` drops its
lock around a blocking drain and re-acquires — the walker tracks that.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile, attr_chain, expr_source

_LOCK_CTORS = {"Lock", "RLock", "Condition", "make_lock", "make_rlock",
               "make_condition"}
_BLOCKING_ATTRS = {"join", "result", "exception", "sleep"}
_WAITY_ATTRS = {"wait", "wait_for"}


def _creates_lock(value: ast.AST) -> Optional[str]:
    """'' for a single lock, '[]' for a collection of locks, None else."""
    if isinstance(value, ast.Call):
        chain = attr_chain(value.func)
        if chain and chain[-1] in _LOCK_CTORS:
            return ""
    if isinstance(value, (ast.List, ast.Tuple)):
        for elt in value.elts:
            if _creates_lock(elt) == "":
                return "[]"
    if isinstance(value, ast.ListComp):
        if _creates_lock(value.elt) == "":
            return "[]"
    if isinstance(value, ast.DictComp):
        if _creates_lock(value.value) == "":
            return "[]"
    return None


class _FuncInfo:
    def __init__(self, node, cls: Optional[str]):
        self.node = node
        self.cls = cls
        # lock keys this function acquires anywhere in its body (direct)
        self.direct_acquires: Set[str] = set()
        # same-module callees: (cls, name) tuples
        self.calls: Set[Tuple[Optional[str], str]] = set()


class ModuleLockGraph:
    """One module's lock definitions, acquisition edges, and findings."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.prefix = sf.display.rsplit("/", 1)[-1]  # e.g. transport.py
        self.module_locks: Dict[str, str] = {}  # name -> key
        self.class_locks: Dict[Tuple[str, str], str] = {}  # (cls,attr)->key
        self.funcs: Dict[Tuple[Optional[str], str], _FuncInfo] = {}
        self.classes: Set[str] = set()
        # (a, b) -> (display, line, context) of the first site where b was
        # acquired while a was held
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        self.findings: List[Finding] = []
        self._collect_defs()
        self._collect_funcs()
        self._transitive = self._fixpoint_acquires()
        for info in self.funcs.values():
            self._walk_function(info)

    # -- definitions --------------------------------------------------------
    def _key(self, cls: Optional[str], name: str, suffix: str) -> str:
        if cls:
            return f"{self.prefix}:{cls}.{name}{suffix}"
        return f"{self.prefix}:{name}{suffix}"

    def _collect_defs(self) -> None:
        for node in ast.walk(self.sf.tree):
            if isinstance(node, ast.ClassDef):
                self.classes.add(node.name)
        # module-level lock names
        for stmt in self.sf.tree.body:
            if isinstance(stmt, ast.Assign):
                suffix = _creates_lock(stmt.value)
                if suffix is not None:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks[t.id] = self._key(
                                None, t.id, suffix
                            )
        # self.<attr> lock assignments anywhere inside a class
        for cls in ast.walk(self.sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Assign):
                    continue
                suffix = _creates_lock(node.value)
                if suffix is None:
                    continue
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        self.class_locks[(cls.name, t.attr)] = self._key(
                            cls.name, t.attr, suffix
                        )
                    elif (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Attribute)
                        and isinstance(t.value.value, ast.Name)
                        and t.value.value.id == "self"
                    ):
                        # self._delta_locks[key] = Lock()
                        self.class_locks[(cls.name, t.value.attr)] = (
                            self._key(cls.name, t.value.attr, "[]")
                        )

    def _collect_funcs(self) -> None:
        def visit(node, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    self.funcs[(cls, child.name)] = _FuncInfo(child, cls)
                    visit(child, cls)  # nested defs keep the class context
                else:
                    visit(child, cls)

        visit(self.sf.tree, None)

    # -- lock-expression resolution ----------------------------------------
    def resolve(self, expr: ast.AST, cls: Optional[str],
                local_locks: Dict[str, str]) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id in local_locks:
                return local_locks[expr.id]
            return self.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                if cls and (cls, expr.attr) in self.class_locks:
                    return self.class_locks[(cls, expr.attr)]
            return None
        if isinstance(expr, ast.Subscript):
            base = self.resolve(expr.value, cls, local_locks)
            if base is not None and not base.endswith("[]"):
                return None
            if base is None and isinstance(expr.value, ast.Attribute):
                return None
            return base
        if isinstance(expr, ast.Call):
            # a with-item calling a lock-returning helper, e.g.
            # `with self._delta_lock_for(key):` — a distinct stable node
            chain = attr_chain(expr.func)
            if chain and "lock" in chain[-1].lower():
                owner = cls if chain[0] == "self" else None
                return self._key(owner, chain[-1] + "()", "")
        return None

    # -- call graph ---------------------------------------------------------
    def _callee(self, call: ast.Call, cls: Optional[str]
                ) -> Optional[Tuple[Optional[str], str]]:
        chain = attr_chain(call.func)
        if not chain:
            return None
        if len(chain) == 1:
            name = chain[0]
            if (None, name) in self.funcs:
                return (None, name)
            if name in self.classes and (name, "__init__") in self.funcs:
                return (name, "__init__")
            return None
        if chain[0] == "self" and len(chain) == 2 and cls:
            if (cls, chain[1]) in self.funcs:
                return (cls, chain[1])
        if chain[0] in self.classes and len(chain) == 2:
            if (chain[0], chain[1]) in self.funcs:
                return (chain[0], chain[1])
        return None

    def _fixpoint_acquires(self) -> Dict[Tuple[Optional[str], str], Set[str]]:
        # first pass: record direct acquisitions + callee lists
        for info in self.funcs.values():
            self._scan_direct(info)
        acquires = {k: set(i.direct_acquires) for k, i in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for k, info in self.funcs.items():
                for callee in info.calls:
                    extra = acquires.get(callee, set()) - acquires[k]
                    if extra:
                        acquires[k] |= extra
                        changed = True
        return acquires

    def _scan_direct(self, info: _FuncInfo) -> None:
        local_locks: Dict[str, str] = {}
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign):
                suffix = _creates_lock(node.value)
                if suffix is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_locks[t.id] = self._key(
                                info.cls, f"<local {t.id}>", suffix
                            )
            if isinstance(node, ast.With):
                for item in node.items:
                    key = self.resolve(item.context_expr, info.cls,
                                       local_locks)
                    if key:
                        info.direct_acquires.add(key)
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain and chain[-1] == "acquire":
                    key = self.resolve(
                        _strip_last(node.func), info.cls, local_locks
                    )
                    if key:
                        info.direct_acquires.add(key)
                callee = self._callee(node, info.cls)
                if callee and callee != (info.cls, info.node.name):
                    info.calls.add(callee)

    # -- the walk -----------------------------------------------------------
    def _walk_function(self, info: _FuncInfo) -> None:
        local_locks: Dict[str, str] = {}
        # pre-scan local lock assignments (they may precede the with)
        for node in ast.walk(info.node):
            if isinstance(node, ast.Assign):
                suffix = _creates_lock(node.value)
                if suffix is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_locks[t.id] = self._key(
                                info.cls, f"<local {t.id}>", suffix
                            )
        self._walk_stmts(info.node.body, [], info, local_locks)

    def _walk_stmts(self, stmts: Sequence[ast.stmt], held: List[str],
                    info: _FuncInfo, local_locks: Dict[str, str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # analyzed as their own function
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                keys = []
                for item in stmt.items:
                    # the context expression runs BEFORE the acquisition
                    self._scan_exprs(item.context_expr, held, info,
                                     local_locks)
                    key = self.resolve(item.context_expr, info.cls,
                                       local_locks)
                    if key:
                        self._acquire(key, held, stmt, info)
                        keys.append(key)
                self._walk_stmts(stmt.body, held, info, local_locks)
                for key in reversed(keys):
                    if key in held:
                        held.remove(key)
                continue
            # explicit acquire()/release() calls toggle the held set
            handled = False
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                chain = attr_chain(stmt.value.func)
                if chain and chain[-1] in ("acquire", "release"):
                    key = self.resolve(
                        _strip_last(stmt.value.func), info.cls, local_locks
                    )
                    if key:
                        handled = True
                        if chain[-1] == "acquire":
                            self._acquire(key, held, stmt, info)
                        elif key in held:
                            held.remove(key)
            if handled:
                continue
            self._scan_stmt_exprs(stmt, held, info, local_locks)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    self._walk_stmts(sub, held, info, local_locks)
            handlers = getattr(stmt, "handlers", None)
            if handlers:
                for h in handlers:
                    self._walk_stmts(h.body, held, info, local_locks)

    def _scan_stmt_exprs(self, stmt: ast.stmt, held: List[str],
                         info: _FuncInfo, local_locks) -> None:
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            for v in value if isinstance(value, list) else [value]:
                if isinstance(v, ast.AST):
                    self._scan_exprs(v, held, info, local_locks)

    def _scan_exprs(self, expr: ast.AST, held: List[str], info: _FuncInfo,
                    local_locks) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if not isinstance(node, ast.Call):
                continue
            if held:
                self._check_blocking(node, held, info, local_locks)
                callee = self._callee(node, info.cls)
                if callee:
                    for k in self._transitive.get(callee, ()):
                        self._edge(held, k, node, info, via=callee)

    def _acquire(self, key: str, held: List[str], stmt, info) -> None:
        if key in held and not key.endswith("[]") and not key.endswith("()"):
            self.findings.append(Finding(
                "TPL103", self.sf.display, stmt.lineno,
                f"lock {key} re-acquired while already held in "
                f"{_fq(info)} — threading.Lock is not reentrant, this "
                "self-deadlocks",
                hint="use one critical section, or an RLock if re-entry "
                "is intended",
            ))
        self._edge(held, key, stmt, info)
        held.append(key)

    def _edge(self, held: List[str], key: str, node, info,
              via: Optional[Tuple[Optional[str], str]] = None) -> None:
        for h in held:
            if h == key:
                continue
            if (h, key) not in self.edges:
                ctx = _fq(info) + (f" -> {_fq_name(via)}" if via else "")
                self.edges[(h, key)] = (self.sf.display, node.lineno, ctx)

    def _check_blocking(self, call: ast.Call, held: List[str],
                        info: _FuncInfo, local_locks) -> None:
        chain = attr_chain(call.func)
        if not chain:
            return
        name = chain[-1]
        blocking = None
        if name in _BLOCKING_ATTRS and len(chain) > 1:
            blocking = f".{name}()"
        elif name == "sleep":
            blocking = "sleep()"
        elif name == "shutdown" and len(chain) > 1:
            wait_kw = next(
                (kw for kw in call.keywords if kw.arg == "wait"), None
            )
            if wait_kw is None or not (
                isinstance(wait_kw.value, ast.Constant)
                and wait_kw.value.value is False
            ):
                blocking = ".shutdown(wait=True)"
        elif name in _WAITY_ATTRS and len(chain) > 1:
            # waiting on the condition variable you hold is the cv
            # protocol (it releases internally) — only foreign waits block
            owner = self.resolve(_strip_last(call.func), info.cls,
                                 local_locks)
            if owner is None or owner not in held:
                blocking = f".{name}()"
        if blocking:
            self.findings.append(Finding(
                "TPL102", self.sf.display, call.lineno,
                f"blocking call {expr_source(call.func)} while holding "
                f"{held[-1]} in {_fq(info)}",
                hint="release the lock before blocking (copy state out, "
                "block, re-acquire) — a blocked holder wedges every "
                "other acquirer",
            ))

    # -- graph analysis -----------------------------------------------------
    def cycle_findings(self) -> List[Finding]:
        out: List[Finding] = []
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(start: str):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in graph.get(node, ()):
                    if nxt == start and len(path) > 1:
                        canon = tuple(sorted(path))
                        if canon not in seen_cycles:
                            seen_cycles.add(canon)
                            yield path + [start]
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))

        for start in sorted(graph):
            for cycle in dfs(start):
                sites = []
                for a, b in zip(cycle, cycle[1:]):
                    f, ln, ctx = self.edges[(a, b)]
                    sites.append(f"{a} -> {b} at {f}:{ln} ({ctx})")
                f, ln, _ = self.edges[(cycle[0], cycle[1])]
                out.append(Finding(
                    "TPL101", self.sf.display, ln,
                    "lock-order cycle: " + "; ".join(sites),
                    hint="impose one global acquisition order (acquire "
                    "the locks in a fixed order everywhere, or merge "
                    "the critical sections)",
                ))
        return out


def _strip_last(attr_node: ast.Attribute) -> ast.AST:
    return attr_node.value


def _fq(info: _FuncInfo) -> str:
    return _fq_name((info.cls, info.node.name))


def _fq_name(key: Tuple[Optional[str], str]) -> str:
    cls, name = key
    return f"{cls}.{name}" if cls else name


def check_file(sf: SourceFile) -> List[Finding]:
    g = ModuleLockGraph(sf)
    return g.findings + g.cycle_findings()
