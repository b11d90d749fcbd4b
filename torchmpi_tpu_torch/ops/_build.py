"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). The libraries go to ``torchmpi_tpu_torch/_build/``,
named by a hash of every source and of the compiler command, so an edited
source is rebuilt and an unchanged one is not. :func:`build_all` starts one
``nvcc`` per source, all at once; :func:`library` builds (if needed) and
loads one library. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("reduce_kernel", "ring_kernels", "ring_quant", "ring_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers and spills into the build log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on the PATH); the "
            "port's CUDA kernels are built from csrc/ at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def target(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_log(name: str) -> Path:
    """The compiler's output for the library of ``csrc/<name>.cu``, kept
    beside it when it was built."""
    return target(name).with_suffix(".log")


def build_all(names=SOURCES) -> List[Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together, keeping each
    compiler output (:func:`build_log`). Raises :class:`KernelBuildError`
    with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for name in names:
        out = target(name)
        if out.exists():
            continue
        # each build writes its own temporary file, renamed into place when
        # done, so concurrent builds never load a half-written library
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, cmd, proc))
    failures = []
    for name, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            build_log(name).write_text(log)
    if failures:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return [target(name) for name in names]


def library(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, declaring
    each C function of ``signatures`` (name -> argtypes) as returning an
    int (the ``cudaError_t`` of its launch)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            (path,) = build_all((name,))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
