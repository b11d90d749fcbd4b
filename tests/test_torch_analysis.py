"""The port's tpu-lint (``torchmpi_tpu_torch.analysis``) against the JAX
package's (``torchmpi_tpu.analysis``), on the CPU.

Every snippet test of ``test_analysis.py`` (the rule fixtures, the knob
and metric trees, the suppressions and the CLI: its tests from line 32 to
680 that run the analyzer on files they write) runs as a case here. The
JAX test runs unchanged, and each analyzer call it makes is repeated by
the port's analyzer on a copy of the test's files with ``torchmpi_tpu``
mapped to ``torchmpi_tpu_torch``: the findings must be equal by (rule,
file, line, message, with the package name mapped back), and a CLI call
must give the same exit code and output. ``test_tpl204_shipped_tree_
metrics_all_documented`` lints the JAX tree itself and has no snippet;
its port counterpart is the clean-tree test below.

The clean-tree test lints ``torchmpi_tpu_torch`` as the CLI does: every
finding must be one of :data:`UNREAD_KNOBS`, knobs whose only readers in
the JAX package are code the port has not yet ported (a module, or a
function of a ported module, with no port counterpart; three reads inside
functions the port does have are listed in :data:`UNPORTED_READS` with
the part that waits). A stale entry, or any other finding, fails.
"""

import ast
import contextlib
import functools
import importlib.util
import io
import re
import shutil
import sys
from pathlib import Path

import pytest

from torchmpi_tpu.analysis import cli as jcli
from torchmpi_tpu.analysis import knobs as jknobs
from torchmpi_tpu.analysis.core import iter_python_files as jiter, load_source as jload
from torchmpi_tpu_torch import analysis as tanalysis
from torchmpi_tpu_torch.analysis import cli as tcli
from torchmpi_tpu_torch.analysis import knobs as tknobs
from torchmpi_tpu_torch.analysis.core import iter_python_files, load_source

REPO = Path(__file__).resolve().parent.parent
_SNIPPETS = REPO / "tests" / "test_analysis.py"
_FIRST, _LAST = 32, 680  # the snippet tests of test_analysis.py
_NO_SNIPPET = {"test_tpl204_shipped_tree_metrics_all_documented"}
_ANALYZER_CALLS = ("lint_snippet", "run_analysis", "lint_main")


def _jax_tests():
    """test_analysis.py as a module of its own (its tests are not
    collected from here)."""
    spec = importlib.util.spec_from_file_location("_jax_test_analysis", _SNIPPETS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _snippet_cases():
    tree = ast.parse(_SNIPPETS.read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and _FIRST <= n.lineno <= _LAST and n.name not in _NO_SNIPPET
            and any(c in ast.unparse(n) for c in _ANALYZER_CALLS)]


def _to_port(text: str) -> str:
    return re.sub(r"\btorchmpi_tpu\b", "torchmpi_tpu_torch", text)


def _to_jax(text: str) -> str:
    return text.replace("torchmpi_tpu_torch", "torchmpi_tpu")


class _Mirror:
    """The port's copy of a test's files: ``src`` (the test's tmp_path)
    copied to ``dst`` before each analyzer call, with the package name and
    the directory mapped in every text file."""

    def __init__(self, src: Path):
        self.src = src
        self.dst = src.parent / f"{src.name}_port"
        self.calls = 0

    def sync(self) -> None:
        shutil.rmtree(self.dst, ignore_errors=True)
        for p in sorted(self.src.rglob("*")):
            q = self.dst / p.relative_to(self.src)
            if p.is_dir():
                q.mkdir(parents=True, exist_ok=True)
                continue
            q.parent.mkdir(parents=True, exist_ok=True)
            try:
                text = p.read_text()
            except UnicodeDecodeError:
                shutil.copyfile(p, q)
                continue
            q.write_text(_to_port(text).replace(str(self.src), str(self.dst)))

    def path(self, p):
        s = str(p)
        return type(p)(s.replace(str(self.src), str(self.dst))) if str(self.src) in s else p

    def back(self, text: str) -> str:
        return _to_jax(text.replace(str(self.dst), str(self.src)))

    def finding(self, f):
        return (f.rule, self.back(f.file), f.line, self.back(f.message))


def _recorders(mirror: _Mirror):
    def run_analysis(paths, **kw):
        want = jcli.run_analysis(paths, **kw)
        mirror.sync()
        tkw = {k: ([mirror.path(p) for p in v] if k == "doc_paths" else
                   mirror.path(v) if k == "root" else v) for k, v in kw.items()}
        got = tcli.run_analysis([mirror.path(p) for p in paths], **tkw)
        assert [mirror.finding(f) for f in got] == \
            [(f.rule, f.file, f.line, f.message) for f in want]
        mirror.calls += 1
        return want

    def lint_main(argv):
        out_j, out_t = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_j), contextlib.redirect_stderr(io.StringIO()):
            rc_j = jcli.main(argv)
        mirror.sync()
        with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(io.StringIO()):
            rc_t = tcli.main([str(mirror.path(a)) for a in argv])
        assert rc_t == rc_j
        assert mirror.back(out_t.getvalue()) == out_j.getvalue()
        mirror.calls += 1
        sys.stdout.write(out_j.getvalue())  # the JAX test reads it
        return rc_j

    return run_analysis, lint_main


_JAX = _jax_tests()


@pytest.mark.parametrize("case", _snippet_cases())
def test_snippet_findings_match_jax(case, tmp_path, capsys, monkeypatch):
    mirror = _Mirror(tmp_path / "snippets")
    mirror.src.mkdir()
    run_analysis, lint_main = _recorders(mirror)
    monkeypatch.setattr(_JAX, "run_analysis", run_analysis)
    monkeypatch.setattr(_JAX, "lint_main", lint_main)
    fn = getattr(_JAX, case)
    fixtures = {"tmp_path": mirror.src, "capsys": capsys}
    fn(**{a: fixtures[a] for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]})
    assert mirror.calls > 0


def test_every_snippet_test_is_a_case():
    names = _snippet_cases()
    assert len(names) == 36 and names[0] == "test_tpl001_rank_guarded_collective"
    assert names[-1] == "test_cli_json_output"


def test_rule_table_and_entry_points_match_jax():
    from torchmpi_tpu import analysis as janalysis

    assert tanalysis.RULES == janalysis.RULES
    assert callable(tanalysis.run) and callable(tanalysis.main)
    assert tanalysis.Finding.__dataclass_fields__.keys() == \
        janalysis.Finding.__dataclass_fields__.keys()


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

A7_A13 = "A7+A13"  # the socket transport, replication, the shm lane, the native store
A10 = "A10's rest"  # elastic membership (reshard/elastic.py, launch.py)
SIM = "sim/"  # A12's simulator, which waits for A13

#: knobs the port's tree reads nowhere yet, with the ROADMAP item they wait for
UNREAD_KNOBS = {
    "use_native_runtime": A7_A13,
    "parameterserver_delta_encoding": A7_A13,
    "ps_listen_backlog": A7_A13,
    "ps_pending_frame_budget": A7_A13,
    "ps_busy_retry_ms": A7_A13,
    "ps_replication": A7_A13,
    "ps_dead_peer_retry_s": A7_A13,
    "ps_read_staleness": A7_A13,
    "ps_shm_lane": A7_A13,
    "ps_shm_spin_limit": A7_A13,
    "elastic_heartbeat_seconds": A10,
    "elastic_barrier_timeout_s": A10,
    "sim_step_seconds": SIM,
    "sim_jitter_pct": SIM,
    "sim_control_rtt_us": SIM,
}

#: JAX reads inside functions the port has, of a part the port's function
#: leaves out: (module, function, knob) -> that part
UNPORTED_READS = {
    ("parameterserver/server.py", "_Instance.__init__", "use_native_runtime"):
        "the native shard store (A7's rest)",
    ("parameterserver/server.py", "_Instance.__init__", "ps_replication"):
        "the replica chains over owner processes (A13)",
    ("parameterserver/server.py", "ParameterServer.__init__", "ps_shm_lane"):
        "the shm lane's publisher (A13)",
}


def _scopes(tree: ast.Module):
    """``(qualname, node)`` for each top-level function and method, and
    ``('<module>', the rest)``."""
    rest = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{item.name}", item
                else:
                    rest.append(item)
        else:
            rest.append(node)
    yield "<module>", ast.Module(body=rest, type_ignores=[])


class _Scope:
    def __init__(self, tree):
        self.tree = tree


@functools.lru_cache(maxsize=None)
def _jax_read_scopes():
    """``(module, qualname, read patterns)`` of every scope of the JAX
    package, by the JAX analyzer's own read patterns."""
    out = []
    for f in jiter([REPO / "torchmpi_tpu"]):
        sf = jload(f, root=REPO / "torchmpi_tpu")
        if sf is None or sf.path.name == "constants.py":
            continue
        for qual, node in _scopes(sf.tree):
            out.append((sf.display, qual, jknobs._read_patterns(_Scope(node))))
    return out


def _jax_reads(knob: str):
    """``(module, qualname)`` of every scope of the JAX package that reads
    ``knob``."""
    return [(m, q) for m, q, pats in _jax_read_scopes() if any(p.fullmatch(knob) for p in pats)]


def _port_defines(module: str, qual: str) -> bool:
    path = REPO / "torchmpi_tpu_torch" / module
    if not path.exists():
        return False
    return any(q == qual for q, _ in _scopes(ast.parse(path.read_text())))


def test_port_tree_lints_to_the_stated_list():
    """``run_analysis([torchmpi_tpu_torch], root=REPO)``: exactly the
    TPL201 findings of UNREAD_KNOBS, on constants.py, and nothing else (no
    TPL203 for the ``_cuda`` knobs, no TPL201 for donate_eager_buffers,
    suppressed in place)."""
    findings = tanalysis.run([REPO / "torchmpi_tpu_torch"], root=REPO)
    other = [f.render() for f in findings
             if f.rule != "TPL201" or f.file != "torchmpi_tpu_torch/constants.py"]
    assert other == []
    named = [re.match(r"knob '(\w+)'", f.message).group(1) for f in findings]
    assert sorted(named) == sorted(UNREAD_KNOBS)


@pytest.mark.parametrize("knob", sorted(UNREAD_KNOBS))
def test_unread_knob_waits_for_an_unported_reader(knob):
    """The JAX package reads the knob, and only in code the port has not
    ported: a module or function with no port counterpart, or a part of a
    ported function that UNPORTED_READS names."""
    reads = _jax_reads(knob)
    assert reads, f"the JAX package reads {knob} nowhere"
    for module, qual in reads:
        if _port_defines(module, qual):
            assert (module, qual, knob) in UNPORTED_READS, \
                f"{knob} is read by {module}:{qual}, which the port has"


@pytest.mark.parametrize("entry", sorted(UNPORTED_READS))
def test_unported_reads_are_current(entry):
    module, qual, knob = entry
    assert (module, qual) in _jax_reads(knob)
    assert _port_defines(module, qual)
    assert knob in UNREAD_KNOBS


def test_cuda_knobs_are_documented_by_their_base_names():
    """TPL203 strips ``_cuda`` (and only the knob rule does): the port's
    ``_cuda`` column is documented by the base names README names."""
    readme = (REPO / "README.md").read_text()
    sf = load_source(REPO / "torchmpi_tpu_torch" / "constants.py", root=REPO)
    cuda = [k for k in tknobs.knob_fields(sf) if k.endswith("_cuda")]
    assert len(cuda) == 6
    for k in cuda:
        assert k not in readme and k[:-len("_cuda")] in readme
    findings = tcli.run_analysis([REPO / "torchmpi_tpu_torch" / "constants.py"], root=REPO,
                                 rules=["TPL203"])
    assert findings == []
    jfindings = jcli.run_analysis([REPO / "torchmpi_tpu_torch" / "constants.py"], root=REPO,
                                  rules=["TPL203"])
    assert sorted(f.message.split("'")[1] for f in jfindings) == sorted(cuda)


def test_frame_rule_finds_no_frame_header_in_the_port():
    """TPL205 reports nothing, and raises nothing, on a tree with no PS
    wire-frame header (the port's socket transport waits for A13)."""
    sources = [sf for f in iter_python_files([REPO / "torchmpi_tpu_torch"])
               if (sf := load_source(f, root=REPO)) is not None]
    assert all(tknobs.frame_header_fields(sf) == {} for sf in sources)
    assert tknobs.check_frame_docs(sources, [REPO / "README.md", REPO / "docs" / "PARITY.md"]) == []
    assert tknobs.check_metrics_docs(sources, [REPO / "README.md",
                                               REPO / "docs" / "PARITY.md"]) == []


def test_cli_on_the_port_tree(capsys):
    """``python -m torchmpi_tpu_torch.analysis torchmpi_tpu_torch``: exit 0
    report-only, 1 under --strict (the stated knobs)."""
    root = ["--root", str(REPO)]
    tree = str(REPO / "torchmpi_tpu_torch")
    assert tcli.main([tree] + root) == 0
    assert f"tpu-lint: {len(UNREAD_KNOBS)} finding(s)" in capsys.readouterr().out
    assert tcli.main([tree, "--strict"] + root) == 1
    capsys.readouterr()
