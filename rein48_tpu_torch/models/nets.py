# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Policy/value networks (port of ``models/nets.py``).

Only the flagship :class:`ResNetPolicy` is ported so far; the other nets
of the JAX package wait for the trainer slices that use them, and
:func:`make_model` says so.

The modules keep the Flax layout at their public edge: they take the
one-hot ``[..., 4, 4, 16]`` observation (channels last) and return
``(logits float32[..., 4], value float32[...])``. Inside, activations stay
channels last: a convolution sees them as NCHW with channels-last
strides, which is the layout cuDNN wants, and the heads flatten in the
(h, w, c) order the Flax nets use. Parameters are float32 and computation
runs in ``dtype`` (bfloat16 by default), as ``dtype=jnp.bfloat16`` does in
Flax; the layer norms reduce in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NUM_ACTIONS = 4


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> None:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # stddev of N(0,1) cut at +-2
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last (channel) axis.

    Epsilon 1e-6, statistics in float32 with the fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, output cast to ``dtype``.
    """

    def __init__(self, channels: int, dtype=torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.dtype, self.eps = dtype, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class Conv3x3(nn.Module):
    """3x3 ``SAME`` convolution on channels-last ``[N, 4, 4, C]`` tensors."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))  # OIHW
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Input and weight both channels last, so cuDNN runs its NHWC kernel
        # with no layout transposes and returns channels last.
        y = F.conv2d(
            x.to(self.dtype).permute(0, 3, 1, 2),
            self.weight.to(self.dtype, memory_format=torch.channels_last),
            self.bias.to(self.dtype),
            padding=1,
        )
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Flax ``nn.Dense`` computing in ``dtype`` (weight stored ``[out, in]``)."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class ResBlock(nn.Module):
    """Pre-activation residual block (LayerNorm -> relu -> conv) x2."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm0 = LayerNorm(channels, dtype)
        self.conv0 = Conv3x3(channels, channels, dtype)
        self.norm1 = LayerNorm(channels, dtype)
        self.conv1 = Conv3x3(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(F.relu(self.norm0(x)))
        h = self.conv1(F.relu(self.norm1(h)))
        return x + h


class ResNetPolicy(nn.Module):
    """Flagship residual policy+value tower (``nets.py:126-160``).

    One-hot planes -> stem conv -> ``num_blocks`` pre-activation blocks ->
    LayerNorm, relu -> policy head (dense ``channels``, relu, dense 4) and
    value head (dense ``channels``, relu, dense 1).
    """

    def __init__(self, channels: int = 64, num_blocks: int = 4, dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.channels, self.num_blocks, self.dtype = channels, num_blocks, dtype
        self.stem = Conv3x3(16, channels, dtype)
        self.blocks = nn.ModuleList(ResBlock(channels, dtype) for _ in range(num_blocks))
        self.norm = LayerNorm(channels, dtype)
        flat = 16 * channels
        self.policy_fc = Dense(flat, channels, dtype)
        self.policy_out = Dense(channels, NUM_ACTIONS, dtype)
        self.value_fc = Dense(flat, channels, dtype)
        self.value_out = Dense(channels, 1, dtype)
        for m in self.modules():
            if isinstance(m, (Conv3x3, Dense)):
                m.reset_parameters(generator)

    def forward(self, obs: torch.Tensor):
        lead = obs.shape[:-3]
        x = self.stem(obs.reshape((-1,) + obs.shape[-3:]))
        for block in self.blocks:
            x = block(x)
        flat = F.relu(self.norm(x)).flatten(1)  # (h, w, c) order, as in Flax
        logits = self.policy_out(F.relu(self.policy_fc(flat)))
        value = self.value_out(F.relu(self.value_fc(flat)))
        return (
            logits.to(torch.float32).reshape(lead + (NUM_ACTIONS,)),
            value.to(torch.float32).reshape(lead),
        )


_MODELS = {"resnet": ResNetPolicy}
_NOT_YET_PORTED = ("mlp", "cnn", "qnet")


def make_model(name: str, **kwargs) -> nn.Module:
    """Model registry for the CLI (``resnet``; the rest are not yet ported)."""
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"model '{name}' is not yet ported to rein48_tpu_torch; use 'resnet'")
    try:
        return _MODELS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown model '{name}'; choose from {sorted(_MODELS)}") from None
