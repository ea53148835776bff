"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library at
first use and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. Libraries go to ``kernels/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. nvcc's report (``-Xptxas
-v``: registers, shared memory, spills) is kept beside each library as
``<lib>.log``. The hash covers the shared headers (``csrc/*.cuh``) too.

The grid limit the ops share (:func:`batch_slices`) and the blocking of
their plain-op twins (:func:`divisor_block`) live here too.
Nothing here runs at import time, so every module imports on a machine
without the CUDA toolkit (the CPU tests import them all).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

from repro_torch import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives (built or not)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    raises with nvcc's output when the build fails. Counts
    ``kernels.loaded`` (and ``kernels.loaded.<name>``) for a library
    found built, ``kernels.built`` (and ``kernels.built.<name>``) for one
    compiled, in the span ``kernels.build``."""
    out = library_path(name)
    if out.exists():
        tracing.count("kernels.loaded")
        tracing.count(f"kernels.loaded.{name}")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    with tracing.span("kernels.build"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    tracing.count("kernels.built")
    tracing.count(f"kernels.built.{name}")
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))


# a grid's y and z dimensions stop at 65,535 blocks: flash_attention puts
# the batch on z, ssd_scan on y
MAX_GRID_BATCH = 65535


def batch_slices(n: int) -> List[slice]:
    """The launches a batch of ``n`` rows takes: consecutive slices of at
    most :data:`MAX_GRID_BATCH` rows, in order. A batch that vmap folds
    together (testers x models x eval rows) can pass the grid's limit."""
    return [slice(i, min(i + MAX_GRID_BATCH, n))
            for i in range(0, n, MAX_GRID_BATCH)]


def divisor_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (keeps block loops exact)."""
    b = min(target, n)
    while n % b:
        b -= 1
    return b
