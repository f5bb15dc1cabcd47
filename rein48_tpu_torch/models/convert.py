# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Carry the JAX package's weights across to the port.

The inputs are the JAX parameters with their leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

* Flax ``ResNetPolicy``: convolution kernels go from HWIO to OIHW and
  dense kernels from ``[in, out]`` to ``[out, in]``. The port's heads
  flatten channels last in the same (h, w, c) order as Flax, so no dense
  weight is permuted.
* Afterstate-TD trainer state: the ``ResNetPolicy`` parameters as above,
  and optax Adam's ``mu``/``nu`` (trees shaped as the parameters, so they
  map the same way) and ``count`` into the port's optimizer.
* N-tuple tables: the same keys and flat float32 tables. The ``"cached"``
  backend's permutation state comes across as int32 beside them:
  ``t{i}_rm``, one physical row per logical row of 128 entries (a
  permutation of ``16**k / 128`` rows), and ``t{i}_hot``, the distinct
  logical rows of the hot prefix, ``rm[hot[s]] == s``. The tables are
  physical storage, so the port then reads and updates them as JAX does,
  layout included.
"""

from __future__ import annotations

import re
from typing import Mapping

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


def afterstate_state_from_jax(state, params, *, mu=None, nu=None, count=None):
    """Load a JAX ``AfterstateTDState``'s parameters, and optionally its
    optax Adam state, into the port's ``AfterstateTDState`` ``state``.

    ``params``, ``mu`` and ``nu`` are Flax trees with numpy leaves and
    ``count`` the Adam step count (``opt_state[1][0]`` of the JAX trainer's
    ``chain(clip, adam)``); ``state``'s optimizer must be ``adam`` or
    ``adamw``. The tensors are copied onto ``state``'s device; the env and
    the generator are left as they are. Returns ``state``.
    """
    state.model.load_state_dict(params_from_flax(params))
    if mu is not None:
        names = [n for n, _ in state.model.named_parameters()]
        moments = {"mu": params_from_flax(mu), "nu": params_from_flax(nu)}
        state.optimizer.load_state_dict(
            {"name": state.optimizer.name, "count": int(count), **{m: [t[n] for n in names] for m, t in moments.items()}}
        )
    return state


_NTUPLE_KEY = re.compile(r"t(\d+)(_E|_A|_rm|_hot)?")


def _check_rows(key: str, arr: np.ndarray, rm: np.ndarray, table: np.ndarray) -> None:
    """Raise unless ``t{i}_rm``/``t{i}_hot`` are a valid permutation state."""
    rows = table.shape[0] // 128 if table.ndim == 1 and table.shape[0] % 128 == 0 else -1
    if arr.dtype != np.int32 or arr.ndim != 1:
        raise ValueError(f"'{key}' must be a flat int32 array, got {arr.dtype} of shape {arr.shape}")
    if key.endswith("_rm"):
        if arr.shape[0] != rows or not np.array_equal(np.sort(arr), np.arange(rows)):
            raise ValueError(f"'{key}' must be a permutation of the {rows} rows of 128 entries of its table")
        return
    if not 0 < arr.shape[0] <= rows or np.unique(arr).shape[0] != arr.shape[0] or arr.min() < 0 or arr.max() >= rows:
        raise ValueError(f"'{key}' must name at most {rows} distinct rows of its table")
    if rm.shape != (rows,) or not np.array_equal(rm[arr], np.arange(arr.shape[0])):
        raise ValueError(f"'{key}' must name the rows that its row map puts first (rm[hot[s]] == s)")


def ntuple_params_from_jax(params: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The port's n-tuple tables from the JAX package's, on ``device``.

    Keys stay as they are: ``t{i}``, ``t{i}_E``/``t{i}_A`` with temporal
    coherence, and ``t{i}_rm``/``t{i}_hot`` of the ``"cached"`` backend.
    Each table must be flat with ``16**k`` entries and each accumulator as
    long as its table; they arrive as float32. The row map and hot rows
    stay int32 and must describe one permutation (module note); anything
    else raises.
    """
    out = {}
    for key, value in params.items():
        m = _NTUPLE_KEY.fullmatch(key)
        if m is None:
            raise ValueError(f"unexpected n-tuple parameter '{key}'")
        arr = np.asarray(value)
        table = np.asarray(params.get(f"t{m.group(1)}", ()))
        if m.group(2) in ("_rm", "_hot"):
            _check_rows(key, arr, np.asarray(params.get(f"t{m.group(1)}_rm", ())), table)
            out[key] = torch.from_numpy(np.array(arr, order="C")).to(device)
            continue
        n = arr.shape[0] if arr.ndim == 1 else -1
        if n < 16 or 16 ** round(np.log(n) / np.log(16)) != n:
            raise ValueError(f"'{key}' must be a flat table of 16**k entries, got shape {arr.shape}")
        if arr.shape != table.shape:
            raise ValueError(f"'{key}' has shape {arr.shape}, its table 't{m.group(1)}' {table.shape}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C")).to(device)
    return out
