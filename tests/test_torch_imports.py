# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port imports no JAX and nothing of the JAX package.

Every module of ``rein48_tpu_torch`` and ``chip_smoke.py`` is imported in
a fresh interpreter in which ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax`` and ``rein48_tpu`` cannot be imported.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "rein48_tpu"}

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Blocker())
import rein48_tpu_torch

names = [m.name for m in pkgutil.walk_packages(rein48_tpu_torch.__path__, "rein48_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):
        importlib.import_module(name)
importlib.import_module("chip_smoke")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    # Every module of slices 1-9 was found (slice 5 adds agents.ppo,
    # train.afterstate, utils.checkpoint and utils.flops: 33; slice 6
    # train.ppo and train.a3c: 35; slice 7 ops.ntuple_value: 36; slice 8
    # spec, env, configs, native, engine.oracle, engine.render, agents.dqn,
    # agents.replay, train.dqn, train.ddpg and utils.plot: 47; slice 9
    # parallel, parallel.mesh, parallel.spmd and parallel.multihost: 51).
    assert int(proc.stdout.strip()) >= 51
