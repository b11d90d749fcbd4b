"""tpu-lint for the port: static collective-contract + concurrency analysis.

The port of ``torchmpi_tpu/analysis``. The runtime observability stack
(flight recorder, hang watchdog, cross-rank analyzer) tells you *which*
rank issued a mismatched collective or deadlocked the world, after the
job already ran; the same bug classes are statically detectable before
a card is allocated. This package walks Python ASTs and checks the
*collective contract* (every rank must issue the same collective
sequence; async handles must be waited; donated buffers must not be
read back; collectives live between ``start()`` and ``stop()``), the
*concurrency contract* of the threaded host modules (a consistent lock
acquisition order, no blocking calls under a lock) and the knob and
metric contract of ``constants.py`` (every knob read, startable and
documented; every ``tm_*`` family documented).

CLI::

    python -m torchmpi_tpu_torch.analysis <paths> [--strict] [--baseline F]

Findings carry ``file:line``, a rule id, and a fix hint. Suppress a
judged false positive with ``# tpu-lint: disable=<rule>`` on (or just
above) the flagged line; ``--baseline`` names a JSON file of accepted
findings. The rule ids, slugs, messages and exit codes are the JAX
package's (TPL001-007, TPL101-103, TPL201-205).

The static lock graph is validated against reality by the opt-in
instrumented-lock runtime monitor (:mod:`.lockmon`,
``TORCHMPI_TPU_LOCK_MONITOR=1``), through which the telemetry core and
the serving tier create their locks.

The analysis modules themselves are stdlib-only (``ast``-based, no
torch imports, no device state touched); ``python -m
torchmpi_tpu_torch.analysis`` still imports the parent package, which
imports torch.
"""

from .core import Finding, RULES, iter_python_files  # noqa: F401


def run(paths, **kw):
    """Analyze ``paths`` (files or directories); returns a list of
    :class:`Finding`. Keyword args as :func:`.cli.run_analysis`."""
    from .cli import run_analysis

    return run_analysis(paths, **kw)


def main(argv=None) -> int:
    from .cli import main as _main

    return _main(argv)
