"""Multi-process launcher of the port: the ``mpirun`` / ``scripts/wrap.sh`` analog.

The core of ``torchmpi_tpu/launch.py`` (the reference's ``mpirun -n N
wrap.sh luajit script.lua``): N identical processes, the world read from
the environment, per-rank log files, and the survivors killed when one
rank dies.

    python -m torchmpi_tpu_torch.launch --nproc 2 train.py -- --lr 0.1
    python -m torchmpi_tpu_torch.launch --nproc 2 --cpu-devices 2 -m pkg.script

- spawns ``--nproc`` copies of the script (or ``-m module``) with
  ``TORCHMPI_TPU_COORDINATOR``, ``TORCHMPI_TPU_NUM_PROCESSES`` and
  ``TORCHMPI_TPU_PROCESS_ID`` set; ``torchmpi_tpu_torch.start()`` reads
  them, so an unmodified script becomes process i of N;
- ``--cpu-devices K`` gives each process K ranks on the CPU
  (``TORCHMPI_TPU_LOCAL_RANKS`` and ``TORCHMPI_TPU_FORCE_CPU``), the
  "several processes without a card" mode of the tests;
- ``--log-dir DIR`` writes ``rank_<i>.log`` per process; by default every
  line streams to the launcher's output prefixed ``[i]``;
- ``--set-constant NAME=VALUE`` overrides a constant in every process
  (``TORCHMPI_TPU_CONSTANTS``);
- one rank failing kills the rest, and the launcher exits with that rank's
  code (128 + signum for a death by signal); ``--nnodes``,
  ``--node-rank`` and ``--coordinator`` extend the same contract across
  launchers that share a coordinator (the port's ranks meet through
  shared memory and CUDA IPC, so its collectives need every process on
  one host).

The elastic and supervised modes, the live telemetry plane, restarts and
the watchdog flag (``--elastic``, ``--supervise``, ``--telemetry-live``,
``--max-restarts``, ``--watchdog-timeout``) are ROADMAP A10's rest: they
raise.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional

# the JAX launcher's flags whose port is ROADMAP A10's rest
_A10_FLAGS = ("elastic", "supervise", "telemetry_live", "max_restarts", "watchdog_timeout")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stream(proc: subprocess.Popen, rank: int) -> None:
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[{rank}] {line}")
        sys.stdout.flush()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.launch",
        description="spawn N torchmpi_tpu_torch processes (mpirun analog)",
    )
    ap.add_argument("--nproc", type=int, required=True, help="processes to launch on this host")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="give each process K ranks on the CPU")
    ap.add_argument("--log-dir", default=None,
                    help="write rank_<i>.log files instead of streaming")
    ap.add_argument("--nnodes", type=int, default=1, help="launchers in the job")
    ap.add_argument("--node-rank", type=int, default=0, help="this launcher's index in [0, nnodes)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (required when nnodes > 1; default: "
                    "localhost:<free port>)")
    ap.add_argument("--set-constant", action="append", default=[], metavar="NAME=VALUE",
                    help="override a torchmpi_tpu_torch.constants knob in every process "
                    "(repeatable); applied by start()")
    ap.add_argument("--elastic", action="store_true", help="ROADMAP A10's rest")
    ap.add_argument("--supervise", action="store_true", help="ROADMAP A10's rest")
    ap.add_argument("--telemetry-live", action="store_true", help="ROADMAP A10's rest")
    ap.add_argument("--max-restarts", type=int, default=0, help="ROADMAP A10's rest")
    ap.add_argument("--watchdog-timeout", type=float, default=0, help="ROADMAP A10's rest")
    ap.add_argument("-m", "--module", default=None,
                    help="run a module (python -m) instead of a script")
    ap.add_argument("script", nargs="?", default=None,
                    help="script path (omit when using --module)")
    ap.add_argument("script_args", nargs=argparse.REMAINDER,
                    help="arguments passed through to the script")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.module is not None and args.script is not None:
        # with -m, the `script` positional eats the first passthrough token
        args.script_args = [args.script] + args.script_args
        args.script = None
    if (args.script is None) == (args.module is None):
        ap.error("exactly one of a script path or --module is required")
    if args.nproc < 1:
        ap.error(f"--nproc must be >= 1, got {args.nproc}")
    if args.nnodes > 1 and args.coordinator is None:
        ap.error("--coordinator host:port is required when nnodes > 1")
    if not 0 <= args.node_rank < args.nnodes:
        ap.error(f"--node-rank {args.node_rank} outside [0, {args.nnodes})")
    if args.cpu_devices < 0:
        ap.error(f"--cpu-devices must be >= 0, got {args.cpu_devices}")
    for spec in args.set_constant:
        if "=" not in spec:
            ap.error(f"--set-constant expects NAME=VALUE, got {spec!r}")
    asked = [f"--{name.replace('_', '-')}" for name in _A10_FLAGS if getattr(args, name)]
    if asked:
        raise NotImplementedError(
            f"launch {' '.join(asked)}: the elastic, supervised, live-telemetry, restart "
            "and watchdog modes of the launcher are ROADMAP A10's rest")
    target = ([sys.executable, "-m", args.module] if args.module
              else [sys.executable, args.script])
    extra = args.script_args
    if extra and extra[0] == "--":
        extra = extra[1:]
    return _run_world(args, target, extra)


def _constants_spec(set_constant) -> str:
    """``--set-constant`` overrides appended to any exported
    ``TORCHMPI_TPU_CONSTANTS`` (``start()`` applies entries in order, so
    the launcher's win)."""
    ambient = os.environ.get("TORCHMPI_TPU_CONSTANTS", "")
    return ";".join([s for s in (ambient,) if s] + list(set_constant))


def _worker_env(args, rank: int, coordinator: str, world: int) -> dict:
    """Process ``rank``'s environment (``_worker_env``,
    ``torchmpi_tpu/launch.py:305-324``): its id and the world, the
    constants overrides, and with ``--cpu-devices`` its CPU ranks."""
    env = dict(
        os.environ,
        TORCHMPI_TPU_COORDINATOR=coordinator,
        TORCHMPI_TPU_NUM_PROCESSES=str(world),
        TORCHMPI_TPU_PROCESS_ID=str(rank),
        TORCHMPI_TPU_RESTART_COUNT="0",
    )
    if args.set_constant:
        env["TORCHMPI_TPU_CONSTANTS"] = _constants_spec(args.set_constant)
    if args.cpu_devices:
        env["TORCHMPI_TPU_LOCAL_RANKS"] = str(args.cpu_devices)
        env["TORCHMPI_TPU_FORCE_CPU"] = "1"
    return env


def _run_world(args, target: List[str], extra: List[str]) -> int:
    """Spawn this launcher's processes and wait for them: the first
    failure's code (128 + signum for a signal), the survivors killed."""
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    world = args.nnodes * args.nproc
    base = args.node_rank * args.nproc
    procs: List[subprocess.Popen] = []
    logs = []
    readers: List[threading.Thread] = []
    log_dir = Path(args.log_dir) if args.log_dir else None
    if log_dir is not None:
        log_dir.mkdir(parents=True, exist_ok=True)
    for i in range(args.nproc):
        rank = base + i
        env = _worker_env(args, rank, coordinator, world)
        if log_dir is not None:
            out = open(log_dir / f"rank_{rank}.log", "w")
            logs.append(out)
            proc = subprocess.Popen(target + extra, env=env, stdout=out,
                                    stderr=subprocess.STDOUT)
        else:
            proc = subprocess.Popen(target + extra, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            reader = threading.Thread(target=_stream, args=(proc, rank), daemon=True)
            reader.start()
            readers.append(reader)
        procs.append(proc)

    rc = 0
    try:
        remaining = set(range(args.nproc))
        while remaining and rc == 0:
            for i in [i for i in remaining if procs[i].poll() is not None]:
                remaining.discard(i)
                code = procs[i].returncode
                if code != 0 and rc == 0:
                    rc = 128 - code if code < 0 else code
                    print(f"[launch] rank {base + i} exited with {code}; terminating the "
                          "remaining ranks", file=sys.stderr)
            if rc == 0 and remaining:
                try:
                    procs[sorted(remaining)[0]].wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    pass
    except KeyboardInterrupt:
        rc = rc or 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for reader in readers:
            reader.join(timeout=5)
        for f in logs:
            f.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
