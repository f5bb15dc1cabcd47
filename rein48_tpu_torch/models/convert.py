# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Carry Flax ``ResNetPolicy`` parameters across to the port's module.

The input is the Flax ``params`` tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
Convolution kernels go from HWIO to OIHW and dense kernels from
``[in, out]`` to ``[out, in]``. The port's heads flatten channels last in
the same (h, w, c) order as Flax, so no dense weight is permuted.
"""

from __future__ import annotations

import numpy as np
import torch

from rein48_tpu_torch.models.nets import ResNetPolicy


def _conv(p, prefix):
    return {
        f"{prefix}.weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)),
        f"{prefix}.bias": np.asarray(p["bias"]),
    }


def _dense(p, prefix):
    return {f"{prefix}.weight": np.asarray(p["kernel"]).T, f"{prefix}.bias": np.asarray(p["bias"])}


def _norm(p, prefix):
    return {f"{prefix}.scale": np.asarray(p["scale"]), f"{prefix}.bias": np.asarray(p["bias"])}


def params_from_flax(params) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`ResNetPolicy` from a Flax ``params`` tree."""
    out = {}
    out.update(_conv(params["stem"], "stem"))
    num_blocks = sum(1 for k in params if k.startswith("block"))
    for i in range(num_blocks):
        blk = params[f"block{i}"]
        out.update(_norm(blk["LayerNorm_0"], f"blocks.{i}.norm0"))
        out.update(_conv(blk["Conv_0"], f"blocks.{i}.conv0"))
        out.update(_norm(blk["LayerNorm_1"], f"blocks.{i}.norm1"))
        out.update(_conv(blk["Conv_1"], f"blocks.{i}.conv1"))
    out.update(_norm(params["LayerNorm_0"], "norm"))
    for name in ("policy_fc", "policy_out", "value_fc", "value_out"):
        out.update(_dense(params[name], name))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in out.items()}


def resnet_from_flax(params, dtype=torch.bfloat16) -> ResNetPolicy:
    """A :class:`ResNetPolicy` holding the Flax parameters (on the CPU)."""
    channels = int(np.asarray(params["stem"]["kernel"]).shape[-1])
    num_blocks = sum(1 for k in params if k.startswith("block"))
    model = ResNetPolicy(channels=channels, num_blocks=num_blocks, dtype=dtype)
    model.load_state_dict(params_from_flax(params))
    return model
