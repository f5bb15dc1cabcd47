# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The C reference-parity oracle, built on first use with the host's C compiler
(port of ``rein48_tpu/native/__init__.py``).

``oracle.c`` is the JAX package's source (its header comment aside): a
bit-compatible CPython ``random.Random`` (MT19937) and the reference's game
semantics, about 1000x the Python oracle's step rate, so that parity sweeps
cover many seeded games. It is a host tool for checking games; no device
path reaches it.

Build: one ``cc -O2 -shared -fPIC`` into ``rein48_tpu_torch/_build/``
(ignored by git), the library named by a hash of the source, as
``build.py`` names the CUDA kernels; a build is written under a temporary
name and renamed into place, so that concurrent processes never load half a
file. :func:`available` is False when no compiler builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

from rein48_tpu_torch.engine.core import ACTION_ALIASES

SRC = Path(__file__).resolve().parent / "oracle.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"oracle-{digest}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for cc in ("cc", "gcc", "clang"):
        try:
            proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SRC)], capture_output=True, text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)
            return True
    tmp.unlink(missing_ok=True)
    return False


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled oracle, building it if needed; None when no compiler works."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = library_path()
    if not path.exists() and not _compile(path):
        _load_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.oracle_sizeof.restype = ctypes.c_int
    lib.oracle_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.oracle_reset.argtypes = [ctypes.c_void_p]
    lib.oracle_step.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.oracle_step.restype = ctypes.c_int
    lib.oracle_random_action.argtypes = [ctypes.c_void_p]
    lib.oracle_random_action.restype = ctypes.c_int
    lib.oracle_play_random.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.oracle_play_random.restype = ctypes.c_int64
    lib.oracle_get_board.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.oracle_last_spawn_rank.argtypes = [ctypes.c_void_p]
    lib.oracle_last_spawn_rank.restype = ctypes.c_int32
    lib.oracle_last_spawn_exp.argtypes = [ctypes.c_void_p]
    lib.oracle_last_spawn_exp.restype = ctypes.c_int32
    lib.oracle_spawn_count.argtypes = [ctypes.c_void_p]
    lib.oracle_spawn_count.restype = ctypes.c_int64
    lib.rng_api_sizeof.restype = ctypes.c_int
    lib.rng_api_seed.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rng_api_random.argtypes = [ctypes.c_void_p]
    lib.rng_api_random.restype = ctypes.c_double
    lib.rng_api_uniform.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double]
    lib.rng_api_uniform.restype = ctypes.c_double
    lib.rng_api_randint.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.rng_api_randint.restype = ctypes.c_int32
    lib.rng_api_getrandbits.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rng_api_getrandbits.restype = ctypes.c_uint32
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native oracle unavailable (no C compiler)")
    return lib


class NativeRandom:
    """ctypes wrapper over the C MT19937: CPython's ``random.Random`` surface."""

    def __init__(self, seed: int):
        self._lib = _require()
        self._buf = ctypes.create_string_buffer(self._lib.rng_api_sizeof())
        self._lib.rng_api_seed(self._buf, seed)

    def random(self) -> float:
        return self._lib.rng_api_random(self._buf)

    def uniform(self, a: float, b: float) -> float:
        return self._lib.rng_api_uniform(self._buf, a, b)

    def randint(self, a: int, b: int) -> int:
        return self._lib.rng_api_randint(self._buf, a, b)

    def getrandbits(self, k: int) -> int:
        return self._lib.rng_api_getrandbits(self._buf, k)


class NativeOracleGame:
    """C twin of ``engine.oracle.OracleGame`` (the same API).

    ``state_matrix`` is the raw-value board as a list of rows; ``last_spawn``
    is ``(blank_rank, value_exp)`` of the latest spawn, the decision that
    the parity harness feeds to ``core.place_tile``.
    """

    def __init__(self, seed: int = 0):
        self._lib = _require()
        self._buf = ctypes.create_string_buffer(self._lib.oracle_sizeof())
        self._lib.oracle_init(self._buf, seed)
        self.reset()

    @property
    def state_matrix(self) -> List[List[int]]:
        out = (ctypes.c_int32 * 16)()
        self._lib.oracle_get_board(self._buf, out)
        return [list(out[r * 4 : r * 4 + 4]) for r in range(4)]

    @property
    def last_spawn(self) -> Tuple[int, int]:
        return int(self._lib.oracle_last_spawn_rank(self._buf)), int(self._lib.oracle_last_spawn_exp(self._buf))

    @property
    def spawn_count(self) -> int:
        return int(self._lib.oracle_spawn_count(self._buf))

    def reset(self) -> List[List[int]]:
        self._lib.oracle_reset(self._buf)
        return self.state_matrix

    def step(self, action) -> Tuple[List[List[int]], int, bool]:
        # The reference's whole alias set, ints and strings.
        act = ACTION_ALIASES.get(action)
        if act is None:
            act = int(action)
        changed = ctypes.c_int(0)
        done = self._lib.oracle_step(self._buf, act, ctypes.byref(changed))
        return self.state_matrix, 0, bool(done)

    def random_action(self) -> int:
        return self._lib.oracle_random_action(self._buf)

    def play_random(self, max_steps: int = 1 << 30) -> int:
        """Play one whole game (reset and the random policy); returns its steps."""
        return int(self._lib.oracle_play_random(self._buf, max_steps))
