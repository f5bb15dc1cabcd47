# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""rein48-tpu in PyTorch, for NVIDIA Hopper GPUs.

A port of the JAX package ``rein48_tpu`` module by module, with the same
layout and public names. Plain tensor code is PyTorch; each of the TPU's
Pallas kernels ported so far is a CUDA C++ kernel (``csrc/rollout.cu``,
``csrc/tables.cu``) built with ``nvcc`` on first use. Nothing here imports
JAX or ``rein48_tpu``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no device named it raises rather than
falling back (:func:`rein48_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
