"""Knob/metric-consistency lint (rules TPL201-TPL205).

The port's copy of ``torchmpi_tpu/analysis/knobs.py``; the one change is
that TPL203's base-name strip also strips ``_cuda``, the port's platform
suffix.

``constants.py`` is the single source of truth for every tunable knob.
Three invariants keep it honest:

- **TPL201 knob-unread** — a knob nobody reads is dead configuration:
  either wire it up or delete it. Reads are ``constants.get("name")``,
  attribute access ``constants.name``, and composed f-string reads like
  ``constants.get(f"small_allreduce_size_{suffix}")`` (the
  platform-suffix idiom), matched as a pattern.
- **TPL202 knob-not-startable** — every knob must be settable at the
  single user entry point, ``start(**kwargs)``; a knob that can only be
  set by importing ``constants`` and calling ``set()`` before start is
  a foot-gun (tuned-constant loading may clobber it).
- **TPL203 knob-undocumented** — every knob must appear in README.md or
  docs/PARITY.md (suffix pairs like ``_cpu``/``_tpu`` — and the port's
  ``_cuda`` column — may be documented by their base name).
- **TPL204 metric-undocumented** — every registered ``tm_*`` metric
  family (a ``counter(...)`` / ``gauge(...)`` / ``histogram(...)`` call
  with a ``tm_``-prefixed literal name) must appear in the metrics
  documentation table (README.md or docs/PARITY.md), same shape as
  TPL203 for knobs: an undocumented family is an operator surface
  nobody can discover.
- **TPL205 frame-field-undocumented** — every PS wire-frame header
  field (the ``name uN`` tokens of the ``# frame:`` doc comment that
  precedes ``_HEADER = struct.Struct(...)`` in the transport) must
  appear as a backticked token in the documented frame-format table
  (README.md / docs/PARITY.md). The wire layout is a cross-version
  compatibility contract; a field that ships undocumented (the fate the
  ``trace``/``span`` trace-context fields would otherwise share with
  ``oseq`` before it) cannot be audited against peers.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .core import Finding, SourceFile, attr_chain


def knob_fields(constants_sf: SourceFile) -> Dict[str, int]:
    """name -> definition line of every _Constants dataclass field."""
    out: Dict[str, int] = {}
    for node in ast.walk(constants_sf.tree):
        if isinstance(node, ast.ClassDef) and node.name == "_Constants":
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    out[stmt.target.id] = stmt.lineno
    return out


def _read_patterns(sf: SourceFile) -> List[re.Pattern]:
    """Regexes matching knob names this file reads.

    Besides direct ``constants.get("name")`` / ``constants.name`` reads
    and composed f-string reads, any bare string literal equal to a knob
    name counts: the pools pass the knob name to a reader at
    construction (``_Pool("tm-ps", "parameterserver_thread_pool_size")``)
    and the autotuner templates names as ``"small_{op}_size_{s}"`` —
    knob names are distinctive enough that a matching literal IS a
    reference."""
    pats: List[re.Pattern] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "_" in node.value and node.value.isidentifier():
                pats.append(re.compile(re.escape(node.value) + r"\Z"))
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in ("get", "set") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    pats.append(re.compile(re.escape(arg.value) + r"\Z"))
                elif isinstance(arg, ast.JoinedStr):
                    parts = []
                    for v in arg.values:
                        if isinstance(v, ast.Constant):
                            parts.append(re.escape(str(v.value)))
                        else:
                            parts.append(r"\w+")
                    pats.append(re.compile("".join(parts) + r"\Z"))
        elif isinstance(node, ast.Attribute) and isinstance(
            node.ctx, ast.Load
        ):
            base = attr_chain(node)
            if base and len(base) >= 2 and "constants" in base[-2].lower():
                pats.append(re.compile(re.escape(node.attr) + r"\Z"))
    return pats


def _start_accepts_kwargs(runtime_state_sf: SourceFile) -> Optional[int]:
    """Line of ``def start`` if it lacks a ``**kwargs``; None when fine
    (or when there is no start() to check)."""
    for node in ast.walk(runtime_state_sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
            node.name == "start"
        ):
            if node.args.kwarg is None:
                return node.lineno
            return None
    return None


def check_knobs(
    constants_sf: SourceFile,
    package_files: Sequence[SourceFile],
    doc_paths: Sequence[Path],
    runtime_state_sf: Optional[SourceFile],
) -> List[Finding]:
    knobs = knob_fields(constants_sf)
    if not knobs:
        return []
    findings: List[Finding] = []

    pats: List[re.Pattern] = []
    for sf in package_files:
        if sf.path.resolve() == constants_sf.path.resolve():
            continue
        pats.extend(_read_patterns(sf))

    docs = ""
    for p in doc_paths:
        try:
            docs += Path(p).read_text()
        except OSError:
            pass

    for name, line in sorted(knobs.items(), key=lambda kv: kv[1]):
        if not any(p.fullmatch(name) for p in pats):
            findings.append(Finding(
                "TPL201", constants_sf.display, line,
                f"knob '{name}' is never read outside constants.py",
                hint="wire the knob into the code path it claims to "
                "control, or delete it",
            ))
        base = re.sub(r"_(cpu|tpu|cuda)$", "", name)
        if docs and name not in docs and base not in docs:
            findings.append(Finding(
                "TPL203", constants_sf.display, line,
                f"knob '{name}' is not mentioned in README.md or "
                "docs/PARITY.md",
                hint="add it to the README knob table",
            ))

    if runtime_state_sf is not None:
        bad_line = _start_accepts_kwargs(runtime_state_sf)
        if bad_line is not None:
            findings.append(Finding(
                "TPL202", runtime_state_sf.display, bad_line,
                f"start() accepts no **kwargs — none of the {len(knobs)} "
                "constants knobs are settable at the entry point",
                hint="add **constant_overrides to start() and forward "
                "each to constants.set()",
            ))
    return findings


_METRIC_REGISTRARS = ("counter", "gauge", "histogram")


def registered_metric_families(
    package_files: Sequence[SourceFile],
) -> Dict[str, Tuple[str, int]]:
    """Every ``tm_*`` family registered anywhere in the tree:
    name -> (file display path, first registration line)."""
    out: Dict[str, Tuple[str, int]] = {}
    for sf in package_files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] not in _METRIC_REGISTRARS:
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ) and arg.value.startswith("tm_"):
                if arg.value not in out:
                    out[arg.value] = (sf.display, node.lineno)
    return out


def check_metrics_docs(
    package_files: Sequence[SourceFile],
    doc_paths: Sequence[Path],
) -> List[Finding]:
    """TPL204: every registered ``tm_*`` metric family must appear in
    the metrics documentation (README.md / docs/PARITY.md)."""
    docs = ""
    for p in doc_paths:
        try:
            docs += Path(p).read_text()
        except OSError:
            pass
    findings: List[Finding] = []
    if not docs:
        return findings  # no docs to check against (same rule as TPL203)
    for name, (display, line) in sorted(
        registered_metric_families(package_files).items()
    ):
        if name not in docs:
            findings.append(Finding(
                "TPL204", display, line,
                f"metric family '{name}' is not mentioned in README.md "
                "or docs/PARITY.md",
                hint="add a row (name, type, labels, emitting module) "
                "to the metrics table",
            ))
    return findings


_FRAME_FIELD_RE = re.compile(r"\b([a-z_][a-z0-9_]*) u(?:8|16|32|64)\b")


def frame_header_fields(sf: SourceFile) -> Dict[str, int]:
    """The wire-frame header fields a transport declares: the ``name uN``
    tokens of the contiguous ``# frame:`` comment block (the field list
    ends at the first bare ``#`` line, where the semantic notes start).
    Returns name -> declaration line."""
    out: Dict[str, int] = {}
    in_block = False
    for i, line in enumerate(sf.source.splitlines(), 1):
        stripped = line.strip()
        if stripped.startswith("# frame:"):
            in_block = True
        elif in_block and (not stripped.startswith("#") or stripped == "#"):
            break
        if in_block:
            for m in _FRAME_FIELD_RE.finditer(stripped):
                out.setdefault(m.group(1), i)
    return out


def check_frame_docs(
    package_files: Sequence[SourceFile],
    doc_paths: Sequence[Path],
) -> List[Finding]:
    """TPL205: every PS wire-frame header field must appear as a
    backticked token in the documented frame-format table. Applies to
    any scanned file that both declares a ``# frame:`` field list and
    packs it (``_HEADER = struct.Struct``) — the wire contract and its
    documentation must move together."""
    docs = ""
    for p in doc_paths:
        try:
            docs += Path(p).read_text()
        except OSError:
            pass
    findings: List[Finding] = []
    if not docs:
        return findings  # no docs to check against (same rule as TPL203)
    for sf in package_files:
        if "_HEADER = struct.Struct(" not in sf.source:
            continue
        for name, line in sorted(
            frame_header_fields(sf).items(), key=lambda kv: kv[1]
        ):
            if f"`{name}`" not in docs:
                findings.append(Finding(
                    "TPL205", sf.display, line,
                    f"wire-frame header field '{name}' is not documented "
                    "in the frame-format table (README.md or "
                    "docs/PARITY.md)",
                    hint="add the field (backticked, with width and "
                    "meaning) to the PARITY frame-format table",
                ))
    return findings
