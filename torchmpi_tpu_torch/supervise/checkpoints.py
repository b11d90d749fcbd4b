"""Last-good-checkpoint registry: the rollback artifact, by name.

A copy of ``torchmpi_tpu/supervise/checkpoints.py`` (standard library
only). Every failure path that ends in "restore from checkpoint" needs
the artifact NAMED: which checkpoint, at which step. This module is that
single fact:

- :func:`register_checkpoint` — called by every checkpoint producer
  (``utils.checkpoint.save_engine_sharded``, and so the engine's
  ``checkpoint_every``) after a save PUBLISHES (the atomic pointer
  swung, the artifact is readable). Records the fact in-process and,
  when ``TORCHMPI_TPU_CHECKPOINT_STATE`` names a file, mirrors it there
  atomically: the same variable as the JAX package's, so a supervisor
  in another process and a relaunched worker read one file.
- :func:`last_checkpoint` — the newest registered record (in-process
  first, the shared state file as fallback), or None.
- :func:`describe_last` — the human/exception fragment that names the
  artifact, or calls out its absence.

The state file holds one JSON object ``{"path", "step", "time"}``.
Replacement rule: a record for the SAME artifact path always wins (the
file on disk was just atomically replaced — the registry must follow,
including across a restart whose step counter started over); a record
for a DIFFERENT path only wins with a step at least as high (a late
async save of an older artifact must not roll the pointer back).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

#: env var naming the cross-process state file (the launcher exports it
#: to every elastic worker; the supervisor reads the same path)
STATE_ENV = "TORCHMPI_TPU_CHECKPOINT_STATE"

_lock = threading.Lock()
_last: Optional[Dict[str, Any]] = None


def state_file() -> Optional[Path]:
    """The shared registry file, when the environment names one."""
    p = os.environ.get(STATE_ENV, "")
    return Path(p) if p else None


def register_checkpoint(path, step: int,
                        extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Record ``path`` (already published) as the newest rollback
    artifact at ``step``. Returns the record. Never raises on I/O — a
    failed mirror write must not fail the save that just succeeded."""
    global _last
    rec = {
        "path": str(Path(path).resolve()),
        "step": int(step),
        "time": time.time(),
        **(extra or {}),
    }
    with _lock:
        if (
            _last is None
            or _last.get("path") == rec["path"]
            or int(_last.get("step", -1)) <= rec["step"]
        ):
            _last = rec
    sf = state_file()
    if sf is not None:
        try:
            prev = _read_file(sf)
            if (
                prev is not None
                and prev.get("path") != rec["path"]
                and int(prev.get("step", -1)) > rec["step"]
            ):
                return rec  # a newer DIFFERENT artifact is registered
            sf.parent.mkdir(parents=True, exist_ok=True)
            tmp = sf.with_name(sf.name + f".tmp.{os.getpid()}")
            tmp.write_text(json.dumps(rec))
            os.replace(tmp, sf)
        except OSError:
            pass
    return rec


def _read_file(sf: Path) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(sf.read_text())
    except (OSError, ValueError):
        return None


def last_checkpoint() -> Optional[Dict[str, Any]]:
    """The newest registered checkpoint record: the in-process one or,
    when another process registered later (higher step) via the shared
    state file, that one."""
    with _lock:
        mine = dict(_last) if _last is not None else None
    sf = state_file()
    shared = _read_file(sf) if sf is not None else None
    if mine is None:
        return shared
    if shared is not None and int(shared.get("step", -1)) > int(
        mine.get("step", -1)
    ):
        return shared
    return mine


def describe_last() -> str:
    """The message fragment every restore-from-checkpoint error embeds:
    the artifact named, or the absence called out."""
    rec = last_checkpoint()
    if rec is None:
        return (
            "restore from checkpoint (none registered — arm "
            "checkpoint_every so a rollback artifact exists)"
        )
    return (
        f"restore from checkpoint {rec['path']} (step {rec['step']})"
    )


def _reset_for_tests() -> None:
    global _last
    with _lock:
        _last = None
