# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""rein48-tpu in PyTorch, for NVIDIA Hopper GPUs.

A port of the JAX package ``rein48_tpu`` module by module, with the same
layout and public names. Plain tensor code is PyTorch; the TPU's Pallas
kernels are CUDA C++ kernels for Hopper (``csrc/rollout.cu``,
``csrc/tables.cu``, ``csrc/hbm_tables.cu`` and ``csrc/ntuple_value.cu``,
which fuses the n-tuple value path) built with ``nvcc`` on first use; the
C parity oracle (``native/oracle.c``) is built with the host's C compiler.
Nothing here imports JAX or ``rein48_tpu``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device named it raises rather than
falling back (:func:`rein48_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

from rein48_tpu_torch.env import Game  # noqa: F401,E402
from rein48_tpu_torch.spec import DEFAULT_SPEC, EnvSpec  # noqa: F401,E402
