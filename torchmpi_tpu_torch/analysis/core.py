"""Shared analysis infrastructure: findings, rules, suppressions, baseline.

The port's copy of ``torchmpi_tpu/analysis/core.py``, unchanged: the rule
ids, slugs and messages are the JAX package's.

A :class:`Finding` is one diagnostic; every rule in the table below
produces them. Suppressions are source comments; the baseline is a
checked-in JSON list of accepted findings matched by (rule, file,
message) — line numbers are deliberately excluded so unrelated edits
above a baselined finding don't un-baseline it.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# rule id -> (slug, one-line description, default fix hint)
RULES: Dict[str, Tuple[str, str]] = {
    "TPL001": (
        "rank-divergent-collective",
        "collective issued under rank-dependent control flow",
    ),
    "TPL002": (
        "mismatched-collective-branches",
        "rank-dependent branch arms issue different collective sequences",
    ),
    "TPL003": (
        "leaked-sync-handle",
        "async collective handle escapes scope without wait()/sync_all()",
    ),
    "TPL004": (
        "donated-buffer-reuse",
        "buffer read after being donated to a jitted function",
    ),
    "TPL005": (
        "collective-outside-lifecycle",
        "collective invoked before start() or after stop()",
    ),
    "TPL006": (
        "literal-routing-kwarg",
        "literal routing kwarg (impl=/staged_intra=/ring_impl=) outside "
        "schedule/ bypasses the schedule compiler",
    ),
    "TPL007": (
        "stale-world-cache",
        "cache keyed on world-size-derived state without a generation()/"
        "resize_epoch re-read — stale across a live resize epoch",
    ),
    "TPL101": (
        "lock-order-cycle",
        "cycle in the static lock acquisition graph",
    ),
    "TPL102": (
        "blocking-call-under-lock",
        "blocking call (join/result/wait/shutdown/sleep) while holding a lock",
    ),
    "TPL103": (
        "nested-self-acquisition",
        "non-reentrant lock re-acquired while already held",
    ),
    "TPL201": (
        "knob-unread",
        "constants knob is never read outside constants.py",
    ),
    "TPL202": (
        "knob-not-startable",
        "constants knobs are not settable via start(**kwargs)",
    ),
    "TPL203": (
        "knob-undocumented",
        "constants knob is not mentioned in README or docs/PARITY.md",
    ),
    "TPL204": (
        "metric-undocumented",
        "registered tm_* metric family is not mentioned in README or "
        "docs/PARITY.md",
    ),
    "TPL205": (
        "frame-field-undocumented",
        "PS wire-frame header field is not documented in the PARITY "
        "frame-format table",
    ),
}

_SLUG_TO_ID = {slug: rid for rid, (slug, _) in RULES.items()}


def canonical_rule(name: str) -> Optional[str]:
    """Accept either the id ('TPL001') or the slug; returns the id."""
    name = name.strip()
    if name in RULES:
        return name
    return _SLUG_TO_ID.get(name)


@dataclass
class Finding:
    rule: str  # TPLxxx
    file: str  # path as given (repo-relative when possible)
    line: int
    message: str
    hint: str = ""

    @property
    def slug(self) -> str:
        return RULES[self.rule][0]

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line-number-free so edits above a finding
        don't churn the baseline."""
        return (self.rule, self.file.replace("\\", "/"), self.message)

    def render(self) -> str:
        hint = f"  [hint: {self.hint}]" if self.hint else ""
        return (
            f"{self.file}:{self.line}: {self.rule} ({self.slug}) "
            f"{self.message}{hint}"
        )

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "slug": self.slug,
            "file": self.file.replace("\\", "/"),
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
        }


# ---------------------------------------------------------------------------
# suppressions: `# tpu-lint: disable=rule1,rule2` on the flagged line or the
# line directly above; `# tpu-lint: disable-file=rule1,...` anywhere in the
# file (use `all` to match every rule).
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*tpu-lint:\s*disable=([\w\-, ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*tpu-lint:\s*disable-file=([\w\-, ]+)")


def _parse_rule_list(raw: str) -> set:
    out = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "all":
            out.update(RULES)
            continue
        rid = canonical_rule(tok)
        if rid:
            out.add(rid)
    return out


class SuppressionIndex:
    """Per-file map of line -> suppressed rule ids (plus file-wide set)."""

    def __init__(self, source: str):
        self.by_line: Dict[int, set] = {}
        self.file_wide: set = set()
        for i, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                self.by_line[i] = _parse_rule_list(m.group(1))
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                self.file_wide |= _parse_rule_list(m.group(1))

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_wide:
            return True
        for ln in (line, line - 1):
            if rule in self.by_line.get(ln, ()):
                return True
        return False


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path) -> set:
    """Accepted-finding keys from a baseline JSON file ([] when absent)."""
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text() or "[]")
    if isinstance(data, dict):
        data = data.get("findings", [])
    out = set()
    for item in data:
        out.add(
            (
                str(item.get("rule", "")),
                str(item.get("file", "")).replace("\\", "/"),
                str(item.get("message", "")),
            )
        )
    return out


def write_baseline(path, findings: Sequence[Finding]) -> None:
    payload = [
        {"rule": f.rule, "file": f.file.replace("\\", "/"),
         "message": f.message}
        for f in sorted(findings, key=lambda f: (f.file, f.rule, f.message))
    ]
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


# ---------------------------------------------------------------------------
# source loading
# ---------------------------------------------------------------------------


@dataclass(eq=False)  # identity hash: used as a dict key by the CLI
class SourceFile:
    path: Path  # resolved on disk
    display: str  # path string used in findings (relative when possible)
    source: str
    tree: ast.AST
    suppressions: SuppressionIndex = field(init=False)

    def __post_init__(self):
        self.suppressions = SuppressionIndex(self.source)


def iter_python_files(paths: Iterable) -> List[Path]:
    out: List[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            out.extend(sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts))
        elif p.suffix == ".py":
            out.append(p)
    # stable order, no duplicates
    seen, uniq = set(), []
    for p in out:
        r = p.resolve()
        if r not in seen:
            seen.add(r)
            uniq.append(p)
    return uniq


def load_source(path: Path, root: Optional[Path] = None) -> Optional[SourceFile]:
    """Parse one file; syntax errors yield None (reported by the CLI as a
    warning, not a crash — the linter must not die on one bad file)."""
    try:
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
    except (OSError, SyntaxError, ValueError):
        return None
    display = str(path)
    if root is not None:
        try:
            display = str(path.resolve().relative_to(root.resolve()))
        except ValueError:
            pass
    return SourceFile(path=path, display=display.replace("\\", "/"),
                      source=src, tree=tree)


def attr_chain(node: ast.AST) -> List[str]:
    """['mpi', 'async_', 'allreduce_tensor'] for mpi.async_.allreduce_tensor;
    [] when the expression is not a plain name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def expr_source(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse of exotic nodes
        return "<expr>"


def walk_scope(root: ast.AST, include_root: bool = True):
    """Pre-order walk that does NOT descend into nested function/lambda
    bodies (``ast.walk`` has no pruning). Child order follows the AST
    field order, so statement lists come back in source order."""
    if include_root:
        yield root
    if isinstance(root, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return  # a def IS the boundary, whether met as root or child
    for child in ast.iter_child_nodes(root):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield from walk_scope(child)
