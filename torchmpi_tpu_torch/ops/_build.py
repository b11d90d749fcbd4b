"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Each ``csrc/<name>.cpp`` of :data:`EXTENSIONS` is a
Python extension module that includes PyTorch's headers, compiled with the
host C++ compiler (tens of seconds) and imported by :func:`extension`. The
libraries go to ``torchmpi_tpu_torch/_build/``, named by a hash of every
source and of the compiler commands, so an edited source is rebuilt and an
unchanged one is not. :func:`build_all` starts one compiler per source,
all at once; :func:`library` builds (if needed) and loads one library.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("reduce_kernel", "ring_kernels", "ring_quant", "ring_attention", "conv_wgrad",
           "rank_bmm")
# Python extension modules (csrc/<name>.cpp, module tm_<name>): the C++
# async issue path and the cross-process slabs (runtime/peers.py)
EXTENSIONS = ("issue", "peer")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers and spills into the build log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelResultError(RuntimeError):
    """A hand-written kernel launched on the card and gave a wrong result."""


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


def cuda_home() -> Path:
    """The CUDA toolkit's root: the directory above ``bin/nvcc``."""
    return Path(nvcc_path()).resolve().parent.parent


def _cxx_command(name: str, out: Path) -> List[str]:
    """The host compiler's command for the extension ``csrc/<name>.cpp``:
    PyTorch's, CUDA's and Python's headers, linked against PyTorch's
    libraries (found again at load through the rpath) and the CUDA
    runtime."""
    import torch

    root = Path(torch.__file__).resolve().parent
    cuda = cuda_home()
    abi = int(getattr(torch._C, "_GLIBCXX_USE_CXX11_ABI", True))
    cxx = os.environ.get("CXX") or shutil.which("c++") or "g++"
    return [
        cxx, *CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
        "-I", str(root / "include"), "-I", str(root / "include/torch/csrc/api/include"),
        "-I", str(cuda / "include"), "-I", sysconfig.get_paths()["include"],
        "-o", str(out), str(CSRC / f"{name}.cpp"),
        "-L", str(root / "lib"), f"-Wl,-rpath,{root / 'lib'}",
        "-lc10", "-lc10_cuda", "-ltorch", "-ltorch_cpu", "-ltorch_cuda", "-ltorch_python",
        "-L", str(cuda / "lib64"), "-lcudart",
    ]


def _digest() -> str:
    import torch

    # the extensions are built against this PyTorch's headers and libraries
    h = hashlib.sha256(" ".join(NVCC_FLAGS + CXX_FLAGS + (torch.__version__,)).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".cpp"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def target(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (or ``.cpp``)
    lives."""
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_log(name: str) -> Path:
    """The compiler's output for the library of ``csrc/<name>.cu``, kept
    beside it when it was built."""
    return target(name).with_suffix(".log")


def build_all(names=SOURCES + EXTENSIONS) -> List[Path]:
    """Compile every library of ``names`` that is not built yet, one
    compiler process per source (``nvcc`` for a kernel source, the host
    C++ compiler for an extension), all started together, keeping each
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
        if name in EXTENSIONS:
            cmd = _cxx_command(name, tmp)
        else:
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


def extension(name: str):
    """Build (if needed) and import the extension ``csrc/<name>.cpp`` as
    the module ``tm_<name>``."""
    with _lock:
        mod = _loaded.get(name)
        if mod is None:
            (path,) = build_all((name,))
            loader = importlib.machinery.ExtensionFileLoader(f"tm_{name}", str(path))
            spec = importlib.util.spec_from_file_location(f"tm_{name}", str(path),
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _loaded[name] = mod
        return mod


def launch(device, call, stream=None):
    """``call(handle)``, ``handle`` the CUDA stream to launch on: ``stream``
    (a ``torch.cuda.Stream``) when given, else the current stream of
    ``device``. A device guard is entered only when ``device`` is not the
    current device: the guard and the current-stream lookup cost more host
    time than a launch's own call."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return call((stream if stream is not None else torch.cuda.current_stream()).cuda_stream)
    with torch.cuda.device(device):
        return call((stream if stream is not None else torch.cuda.current_stream()).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
