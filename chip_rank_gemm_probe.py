#!/usr/bin/env python3
"""What holds the per-rank kernels (``csrc/rank_gemm.cuh``'s mainloop under
``csrc/rank_bmm.cu`` and ``csrc/conv_wgrad.cu``) on one card.

``python3 chip_rank_gemm_probe.py`` does two things and prints one
``{"rank_gemm_probe": ...}`` line with the card's name and power limit:

- **the mainloop with parts taken out.** It builds ``csrc/rank_bmm.cu``
  five times from the repo's sources, each on a copy of the header with
  one substitution (:data:`VARIANTS`): as it is ('base'); the split into
  big and small TF32 terms left out ('no_split'); two of the three
  products left out ('one_term'); every product replaced by an add that
  keeps the fragments live ('no_mma'); no copies after the prologue
  ('no_loads'). Each is timed on a 1024 x 4096 x 1024 product (one rank,
  k-major operands) and at LeNet's ``dense0`` forward. The variants give
  wrong results; they only say where the time goes.
- **the plan's blocks a rank.** For each value of
  ``ops.rank_gemm.BLOCKS_PER_RANK`` in :data:`BLOCKS`, each per-rank
  launch of a LeNet and of a config-5 vmap step
  (``chip_smoke.step_products``, inputs rotated past the L2) and the
  step's total.

Times are medians of CUDA events (``chip_smoke.time_ms``), f32, TF32 off
for the library calls. The variants build in parallel, about a minute.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# name -> {text of csrc/rank_gemm.cuh: its replacement}
_MMAS = ("#pragma unroll\n        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], ab[mt], bs);\n"
         "#pragma unroll\n        for (int mt = 0; mt < MT; ++mt) mma_tf32(part[mt][nt], as[mt], bb);\n")
VARIANTS = {
    "base": {},
    "no_split": {"  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                 "  small = __float_as_uint(x - __uint_as_float(big));":
                 "  big = __float_as_uint(x);\n  small = big;"},
    "one_term": {_MMAS: ""},
    "no_mma": {_MMAS + "#pragma unroll\n        for (int mt = 0; mt < MT; ++mt) "
               "mma_tf32(part[mt][nt], ab[mt], bb);":
               "#pragma unroll\n        for (int mt = 0; mt < MT; ++mt) {\n"
               "          part[mt][nt][0] += __uint_as_float(ab[mt][0] ^ bs[0] ^ as[mt][1] ^ bb[1]);\n"
               "          part[mt][nt][1] += __uint_as_float(ab[mt][2] ^ bb[0] ^ as[mt][3] ^ bs[1]);\n"
               "        }"},
    "no_loads": {"      if (next < nk) {\n        float* slot": "      if (next < 0) {\n        float* slot"},
}
# (R, M, K, N) of the variants' products: a large square-ish one, dense0's forward
SHAPES = ((1, 1024, 4096, 1024), (8, 42, 3136, 256))
BLOCKS = (16, 24, 32, 48, 64)


def build_variants(out: Path) -> dict:
    """name -> the variant's library, built from the repo's sources."""
    from torchmpi_tpu_torch.ops import _build, rank_bmm_kernel

    csrc = ROOT / "torchmpi_tpu_torch" / "csrc"
    header, source = (csrc / "rank_gemm.cuh").read_text(), (csrc / "rank_bmm.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = header
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"chip_rank_gemm_probe: {name}: csrc/rank_gemm.cuh no longer "
                                 f"holds {old[:60]!r}")
            text = text.replace(old, new)
        d = out / name
        d.mkdir()
        (d / "rank_gemm.cuh").write_text(text)
        (d / "rank_bmm.cu").write_text(source)
        procs[name] = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                                        str(d / "lib.so"), str(d / "rank_bmm.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_rank_gemm_probe: {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.tm_rank_bmm.argtypes = rank_bmm_kernel._SIGNATURES["tm_rank_bmm"]
        lib.tm_rank_bmm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants(cs, dev) -> dict:
    from torchmpi_tpu_torch.ops import rank_bmm_kernel

    gen = torch.Generator(device=dev).manual_seed(0)
    kept = rank_bmm_kernel._lib
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        try:
            for R, M, K, N in SHAPES:
                a = torch.randn((R, M, K), generator=gen, device=dev)
                b = torch.randn((R, N, K), generator=gen, device=dev).transpose(1, 2)
                for name, lib in libs.items():
                    rank_bmm_kernel._lib = lambda lib=lib: lib
                    ms = cs.time_ms(lambda: rank_bmm_kernel.rank_bmm(a, b))
                    out[f"{name}_{R}x{M}x{K}x{N}"] = {"ms": ms,
                                                     "tflops": 2 * R * M * N * K / ms / 1e9}
        finally:
            rank_bmm_kernel._lib = kept
    return out


def sweep_blocks(cs, dev) -> dict:
    from torchmpi_tpu_torch import ops
    from torchmpi_tpu_torch.ops import rank_gemm

    calls = cs.step_products(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    kept = rank_gemm.BLOCKS_PER_RANK
    out = {}
    try:
        for blocks in BLOCKS:
            rank_gemm.BLOCKS_PER_RANK = blocks
            row = {}
            for path, path_calls in calls.items():
                ms = []
                for name, args, _ in path_calls:
                    tensors, rest = args[:2], args[2:]

                    def make(tensors=tensors, rest=rest):
                        return (*(cs.strided_like(t, gen) for t in tensors), *rest)

                    ms.append(cs.time_ms(cs.rotating(getattr(ops, name), make,
                                                     sum(t.numel() * 4 for t in tensors))))
                row[path] = {"step_ms": sum(ms), "launch_ms": ms}
            out[blocks] = row
    finally:
        rank_gemm.BLOCKS_PER_RANK = kept
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_rank_gemm_probe: no CUDA device; this run needs one card")
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_build(("conv_wgrad", "rank_bmm"))
    print(json.dumps({"rank_gemm_probe": {"variants": time_variants(cs, dev),
                                          "blocks_per_rank": sweep_blocks(cs, dev)},
                      "card": cs.card()}), flush=True)


if __name__ == "__main__":
    main()
