"""tpu-lint command line.

    python -m torchmpi_tpu_torch.analysis <paths...> [options]

The port's copy of ``torchmpi_tpu/analysis/cli.py``: the same rules,
options and exit codes.

Exit codes (the contract CI composes with):

- ``0`` — no non-baselined, non-suppressed findings (or not --strict)
- ``1`` — findings remain under ``--strict``
- ``2`` — usage / input error (no Python files found, bad rule name)

This module is stdlib-only and never initializes an accelerator
backend; the ``-m`` entry point still imports the ``torchmpi_tpu_torch``
parent package (Python's ``-m`` semantics), so torch must be importable.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from . import contracts, epoch as epoch_mod, knobs as knobs_mod, locks
from .core import (
    Finding,
    RULES,
    canonical_rule,
    iter_python_files,
    load_baseline,
    load_source,
    write_baseline,
)


def run_analysis(
    paths: Sequence,
    rules: Optional[Sequence[str]] = None,
    root: Optional[Path] = None,
    doc_paths: Optional[Sequence[Path]] = None,
) -> List[Finding]:
    """Analyze files/dirs; returns suppression-filtered findings.

    ``rules``: restrict to these rule ids (default: all).
    ``root``: base for display paths and for locating README/docs
    (default: the common parent — the current directory).
    """
    root = Path(root) if root is not None else Path.cwd()
    files = iter_python_files(paths)
    sources = []
    for f in files:
        sf = load_source(f, root=root)
        if sf is None:
            print(f"tpu-lint: skipping unparseable {f}", file=sys.stderr)
            continue
        sources.append(sf)

    wanted = set(rules) if rules else set(RULES)
    findings: List[Finding] = []
    per_file = {}
    for sf in sources:
        per_file[sf] = []
        per_file[sf].extend(contracts.check_file(sf))
        per_file[sf].extend(locks.check_file(sf))
        per_file[sf].extend(epoch_mod.check_file(sf))

    if doc_paths is None:
        doc_paths = [root / "README.md", root / "docs" / "PARITY.md"]
    owner = {sf.display: sf for sf in sources}

    def _attribute(repo_findings):
        for f in repo_findings:
            sf = owner.get(f.file)
            if sf is not None:
                per_file.setdefault(sf, []).append(f)
            else:  # pragma: no cover - finding on an unscanned file
                findings.append(f)

    # repo-level knob rules: keyed off a scanned constants.py that
    # defines _Constants
    constants_sf = next(
        (sf for sf in sources
         if sf.path.name == "constants.py" and knobs_mod.knob_fields(sf)),
        None,
    )
    if constants_sf is not None:
        runtime_state_sf = next(
            (sf for sf in sources if sf.path.name == "runtime_state.py"),
            None,
        )
        _attribute(knobs_mod.check_knobs(
            constants_sf, sources, doc_paths, runtime_state_sf
        ))

    # repo-level metric documentation rule (TPL204): every registered
    # tm_* family must be in the docs table — the metrics mirror of
    # TPL203, and not gated on constants.py being in the scan set
    _attribute(knobs_mod.check_metrics_docs(sources, doc_paths))

    # repo-level wire-contract rule (TPL205): every PS frame header
    # field must be in the PARITY frame-format table
    _attribute(knobs_mod.check_frame_docs(sources, doc_paths))

    for sf, flist in per_file.items():
        for f in flist:
            if f.rule not in wanted:
                continue
            if sf.suppressions.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.analysis",
        description="tpu-lint: static collective-contract checker and "
        "lock-order analyzer",
    )
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when non-baselined findings remain")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="JSON baseline of accepted findings (matched by "
                    "rule+file+message, line-free)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to --baseline and "
                    "exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids/slugs to run "
                    "(default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable JSON output")
    ap.add_argument("--root", default=None,
                    help="repo root for display paths and README/docs "
                    "lookup (default: cwd)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, (slug, desc) in sorted(RULES.items()):
            print(f"{rid}  {slug:32s} {desc}")
        return 0

    rules = None
    if args.rules:
        rules = []
        for tok in args.rules.split(","):
            rid = canonical_rule(tok)
            if rid is None:
                print(f"tpu-lint: unknown rule {tok!r}", file=sys.stderr)
                return 2
            rules.append(rid)

    root = Path(args.root) if args.root else None
    # walk the tree ONCE; the expanded file list feeds run_analysis
    # directly (iter_python_files on plain files is a no-op expansion)
    files = iter_python_files(args.paths) if args.paths else []
    if not files:
        print("tpu-lint: no Python files under the given paths",
              file=sys.stderr)
        return 2

    findings = run_analysis(files, rules=rules, root=root)

    if args.write_baseline:
        path = args.baseline or "tpu_lint_baseline.json"
        write_baseline(path, findings)
        print(f"tpu-lint: wrote {len(findings)} finding(s) to {path}")
        return 0

    baselined = load_baseline(args.baseline) if args.baseline else set()
    fresh = [f for f in findings if f.key() not in baselined]

    if args.as_json:
        print(json.dumps(
            {
                "findings": [f.as_dict() for f in fresh],
                "baselined": len(findings) - len(fresh),
            },
            indent=2,
        ))
    else:
        for f in fresh:
            print(f.render())
        known = len(findings) - len(fresh)
        tail = f" ({known} baselined)" if known else ""
        print(f"tpu-lint: {len(fresh)} finding(s){tail}")
    if fresh and args.strict:
        return 1
    return 0
