# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled for
Hopper (``sm_90a``) into its own shared library under ``_build/`` (listed
in ``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so that an edited source is rebuilt. The
build happens on first use, from the package's sources only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the kernels in ``csrc/`` (one shared library each)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(p.name.encode() + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet.

    Returns ``{name: {"seconds": s, "log": compiler output}}`` for the
    kernels it compiled; raises with the compiler's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = {}
    for name in sources() if names is None else names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode:
            raise RuntimeError(f"kernel build failed: {name}: nvcc exited {proc.returncode}\n{proc.stdout}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": proc.stdout}
    return report


def load(name: str) -> ctypes.CDLL:
    """The shared library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
