# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Carry the JAX package's weights across to the port.

The inputs are the JAX parameters with their leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

* Flax ``A3CMLP``, ``CNNPolicy``, ``ResNetPolicy`` and ``QNetwork``: convolution kernels
  go from HWIO to OIHW and dense kernels from ``[in, out]`` to ``[out,
  in]``. The port's nets flatten channels last in the same (h, w, c) order
  as Flax, so no dense weight is permuted.
* Trainer states (afterstate TD, PPO with one net or the ``{"policy",
  "after"}`` pair, A3C, DQN, DDPG): the parameters as above, optax's
  ``mu``/``nu`` (trees shaped as the parameters, so they map the same way)
  and ``count`` into the port's optimizers, the env's boards and episode
  counters, and for the replay learners the target nets and the replay
  buffer with its cursor and size.
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
from torch import nn

from rein48_tpu_torch.models import nets
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


def _tensors(out) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in out.items()}


def mlp_params_from_flax(params) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`A3CMLP` from a Flax ``params`` tree."""
    out = {}
    for name in ("actor_fc", "actor_out", "critic_fc", "critic_out"):
        out.update(_dense(params[name], name))
    return _tensors(out)


def cnn_params_from_flax(params) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`CNNPolicy` from a Flax ``params`` tree."""
    out = {}
    for i in range(sum(1 for k in params if k.startswith("conv"))):
        out.update(_conv(params[f"conv{i}"], f"convs.{i}"))
    for name in ("policy", "value"):
        out.update(_dense(params[name], name))
    return _tensors(out)


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
    return _tensors(out)


def qnet_params_from_flax(params) -> dict[str, torch.Tensor]:
    """``state_dict`` of :class:`QNetwork` (dueling or plain) from a Flax ``params`` tree."""
    out = {}
    for i in range(sum(1 for k in params if k.startswith("conv"))):
        out.update(_conv(params[f"conv{i}"], f"convs.{i}"))
    for name in ("trunk", "advantage", "state_value", "q"):
        if name in params:
            out.update(_dense(params[name], name))
    return _tensors(out)


_LOADERS = {"mlp": mlp_params_from_flax, "cnn": cnn_params_from_flax, "resnet": params_from_flax}
_BY_TYPE = {
    nets.A3CMLP: mlp_params_from_flax,
    nets.CNNPolicy: cnn_params_from_flax,
    nets.ResNetPolicy: params_from_flax,
    nets.QNetwork: qnet_params_from_flax,
}


def _shape_kwargs(name: str, params) -> dict:
    """The constructor arguments that the Flax parameters' shapes fix."""
    if name == "mlp":
        kernel = np.asarray(params["actor_fc"]["kernel"])
        return {"hidden": kernel.shape[1], "in_channels": kernel.shape[0] // 16}
    if name == "cnn":
        n = sum(1 for k in params if k.startswith("conv"))
        kernels = [np.asarray(params[f"conv{i}"]["kernel"]) for i in range(n)]
        return {"channels": tuple(k.shape[-1] for k in kernels), "in_channels": kernels[0].shape[2]}
    kernel = np.asarray(params["stem"]["kernel"])
    num_blocks = sum(1 for k in params if k.startswith("block"))
    return {"channels": kernel.shape[-1], "num_blocks": num_blocks, "in_channels": kernel.shape[2]}


def model_from_flax(name: str, params, **kwargs) -> nn.Module:
    """The net ``make_model(name)`` holding the Flax parameters (on the CPU).

    Widths come from the parameters' shapes; ``kwargs`` sets the rest
    (``dtype``, the MLP's parity flags). Raises ``ValueError`` for a name
    that ``make_model`` does not know.
    """
    if name not in _LOADERS:
        raise ValueError(f"unknown model '{name}'; choose from {sorted(_LOADERS)}")
    model = nets.make_model(name, **{**_shape_kwargs(name, params), **kwargs})
    model.load_state_dict(_LOADERS[name](params))
    return model


def state_dict_from_flax(module: nn.Module, params) -> dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` from Flax parameters of the same net."""
    return _BY_TYPE[type(module)](params)


def resnet_from_flax(params, dtype=torch.bfloat16) -> ResNetPolicy:
    """A :class:`ResNetPolicy` holding the Flax parameters (on the CPU)."""
    return model_from_flax("resnet", params, dtype=dtype)


def _load_optimizer(optimizer, modules, moments, count) -> None:
    """Load the optax ``moments`` (name -> a tree per module, shaped as the
    parameters) and ``count`` into ``optimizer``, in the order of its
    parameters (the modules' in turn)."""
    lists = {m: [] for m in moments}
    for i, module in enumerate(modules):
        names = [n for n, _ in module.named_parameters()]
        for m, trees in moments.items():
            sd = state_dict_from_flax(module, trees[i])
            lists[m] += [sd[n] for n in names]
    optimizer.load_state_dict({"name": optimizer.name, "count": int(count or 0), **lists})


def _load_env(dst_env, env) -> None:
    """Copy the JAX env's ``boards``, ``score``, ``steps`` and ``done``; the
    port's Philox counters stay as they are."""
    for name in ("boards", "score", "steps", "done"):
        dst = getattr(dst_env, name)
        dst.copy_(torch.from_numpy(np.array(env[name])).to(dst.dtype))


def _load_trainer_state(state, modules, params, moments, count, env):
    """Load ``params`` (a tree per module) into ``modules``, the optimizer's
    ``moments`` and ``count`` into ``state.optimizer``, and the JAX env's
    fields into ``state.env``."""
    for module, tree in zip(modules, params):
        module.load_state_dict(state_dict_from_flax(module, tree))
    if moments:
        _load_optimizer(state.optimizer, modules, moments, count)
    if env is not None:
        _load_env(state.env, env)
    return state


def _trees(tree, critic: bool):
    return [tree["policy"], tree["after"]] if critic else [tree]


def _load(state, modules, params, mu, nu, count, env, critic=False):
    moments = {m: _trees(t, critic) for m, t in (("mu", mu), ("nu", nu)) if t is not None}
    return _load_trainer_state(state, modules, _trees(params, critic), moments, count, env)


def afterstate_state_from_jax(state, params, *, mu=None, nu=None, count=None, env=None):
    """Load a JAX ``AfterstateTDState``'s parameters, and optionally its
    optax state and env, into the port's ``AfterstateTDState`` ``state``.

    ``params``, ``mu`` and ``nu`` are Flax trees with numpy leaves and
    ``count`` the step count (``opt_state[1][0]`` of the JAX trainer's
    ``chain(clip, adam)``); the moments given must be those of ``state``'s
    optimizer (``mu`` and ``nu`` for adam, ``nu`` alone for rmsprop).
    ``env`` maps the JAX ``EnvState``'s ``boards``, ``score``, ``steps`` and
    ``done`` to numpy arrays; the port's Philox counters stay as they are.
    The tensors are copied onto ``state``'s device. Returns ``state``.
    """
    return _load(state, [state.model], params, mu, nu, count, env)


def ppo_state_from_jax(state, params, *, mu=None, nu=None, count=None, env=None):
    """Load a JAX ``PPOTrainState`` into the port's ``PPOTrainState``, as
    :func:`afterstate_state_from_jax`. With an afterstate critic the trees
    are JAX's ``{"policy": ..., "after": ...}`` pairs; they load into
    ``state.model`` and ``state.after_model`` under the one optimizer."""
    if state.after_model is None:
        return _load(state, [state.model], params, mu, nu, count, env)
    return _load(state, [state.model, state.after_model], params, mu, nu, count, env, critic=True)


def a3c_state_from_jax(state, params, *, mu=None, nu=None, count=None, env=None):
    """Load a JAX ``A3CTrainState`` into the port's ``A3CTrainState``, as
    :func:`afterstate_state_from_jax`."""
    return _load(state, [state.model], params, mu, nu, count, env)


def _load_replay(dst, replay) -> None:
    """The JAX ``ReplayState``'s ``data`` (field -> numpy), ``cursor`` and
    ``size`` into the port's buffer ``dst``, in place."""
    for k, buf in dst.data.items():
        buf.copy_(torch.from_numpy(np.array(replay["data"][k])).to(buf.dtype))
    dst.cursor, dst.size = int(replay["cursor"]), int(replay["size"])


def dqn_state_from_jax(state, params, *, target_params=None, mu=None, nu=None, count=None, env=None, replay=None, env_steps=None):
    """Load a JAX ``DQNTrainState`` into the port's ``DQNTrainState``.

    ``params`` and ``target_params`` are Flax trees with numpy leaves (the
    target defaults to ``params``); ``mu``, ``nu`` and ``count`` the adam
    state (``opt_state[1][0]``), as :func:`afterstate_state_from_jax` takes
    them; ``env`` the env's fields; ``replay`` a dict of the buffer's
    ``data`` (field -> numpy ``[capacity, ...]``), ``cursor`` and ``size``;
    ``env_steps`` the step count. Returns ``state``.
    """
    _load(state, [state.model], params, mu, nu, count, env)
    state.target_model.load_state_dict(state_dict_from_flax(state.target_model, params if target_params is None else target_params))
    if replay is not None:
        _load_replay(state.replay, replay)
    if env_steps is not None:
        state.env_steps = int(env_steps)
    return state


def ddpg_state_from_jax(state, *, actor, critic, target_actor=None, target_critic=None, actor_opt=None, critic_opt=None, env=None, replay=None):
    """Load a JAX ``DDPGTrainState`` into the port's ``DDPGTrainState``.

    ``actor``/``critic`` and their targets (default: the nets) are Flax
    trees with numpy leaves; ``actor_opt``/``critic_opt`` each a dict of the
    adam state's ``mu``, ``nu`` and ``count``; ``env`` and ``replay`` as
    :func:`dqn_state_from_jax` takes them. Returns ``state``.
    """
    pairs = ((state.actor, actor, target_actor, state.target_actor, state.actor_opt, actor_opt),
             (state.critic, critic, target_critic, state.target_critic, state.critic_opt, critic_opt))
    for module, tree, target_tree, target, opt, opt_state in pairs:
        module.load_state_dict(state_dict_from_flax(module, tree))
        target.load_state_dict(state_dict_from_flax(target, tree if target_tree is None else target_tree))
        if opt_state is not None:
            _load_optimizer(opt, [module], {m: [opt_state[m]] for m in ("mu", "nu")}, opt_state["count"])
    if env is not None:
        _load_env(state.env, env)
    if replay is not None:
        _load_replay(state.replay, replay)
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
