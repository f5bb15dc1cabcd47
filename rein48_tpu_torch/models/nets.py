# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Policy/value networks (port of ``models/nets.py``).

* :class:`A3CMLP`: the reference A3C's two-tower MLP (float32), with its
  quirks behind the JAX package's flags.
* :class:`CNNPolicy`: two 2x2 ``VALID`` convolutions and linear policy and
  value heads.
* :class:`ResNetPolicy`: the flagship residual policy+value tower.
* :class:`QNetwork`: Q(s, .) over all actions, with optional dueling
  heads, for the DQN family (reached through ``DQNConfig.make_model``,
  not the registry, as in JAX).

The modules keep the Flax layout at their public edge: they take the
``[..., 4, 4, C]`` observation (channels last; ``C`` is 16 for the one-hot
planes, 1 for the other encodings, ``in_channels`` here where Flax infers
it) and return ``(logits float32[..., 4], value float32[...])``. Inside,
activations stay channels last: a convolution sees them as NCHW with
channels-last strides, which is the layout cuDNN wants, and the heads
flatten in the (h, w, c) order the Flax nets use. Parameters are float32
and computation runs in ``dtype``, as ``dtype=`` does in Flax; the layer
norms reduce in float32, each fused with the ReLU that follows it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rein48_tpu_torch.ops import layer_norm

NUM_ACTIONS = 4


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> None:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # stddev of N(0,1) cut at +-2
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class LayerNormReLU(nn.Module):
    """Flax ``nn.LayerNorm`` over the last (channel) axis, then the ReLU
    that follows every norm of the ResNet.

    Epsilon 1e-6, statistics in float32 with the fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, output in the input's type (the
    model's ``dtype``, which the convolutions give it). On the card one
    launch of the kernel of ``ops/layer_norm.py`` (and two backward); on
    the CPU the plain float32 composition.
    """

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm.layer_norm_relu(x, self.scale, self.bias, self.eps)


class Conv(nn.Module):
    """Square convolution on channels-last ``[N, H, W, C]`` tensors: 3x3
    ``SAME`` (``padding=1``) or ``VALID`` (``padding=0``)."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16, size: int = 3, padding: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, size, size))  # OIHW
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype, self.padding = dtype, padding

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
            padding=self.padding,
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


def _reset(module: nn.Module, generator) -> None:
    """Flax's default init (lecun normal, zero bias) of every layer."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)


class A3CMLP(nn.Module):
    """Reference-parity two-tower MLP (``nets.py:44-82``).

    flatten -> [actor] dense ``hidden``, relu6, dropout, dense 4, relu
    (``parity_relu_head``); [critic] dense ``hidden``, relu6, dropout,
    dense 1. Xavier-uniform kernels, zero biases. The reference's dropout
    is a no-op (``parity_noop_dropout``, the default); with it off and
    ``dropout_uniforms`` given, a unit is kept where its uniform is below
    ``1 - dropout_rate`` and scaled by ``1 / (1 - dropout_rate)``, as Flax's
    ``nn.Dropout`` does with its own bits.
    """

    def __init__(
        self,
        hidden: int = 64,
        dropout_rate: float = 0.4,
        parity_noop_dropout: bool = True,
        parity_relu_head: bool = True,
        dtype=torch.float32,
        generator=None,
        in_channels: int = 16,
    ):
        super().__init__()
        self.hidden, self.dropout_rate, self.dtype = hidden, dropout_rate, dtype
        self.parity_noop_dropout, self.parity_relu_head = parity_noop_dropout, parity_relu_head
        features = 16 * in_channels
        self.actor_fc = Dense(features, hidden, dtype)
        self.actor_out = Dense(hidden, NUM_ACTIONS, dtype)
        self.critic_fc = Dense(features, hidden, dtype)
        self.critic_out = Dense(hidden, 1, dtype)
        for m in (self.actor_fc, self.actor_out, self.critic_fc, self.critic_out):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            nn.init.zeros_(m.bias)

    @property
    def dropout_active(self) -> bool:
        """Whether a training forward draws dropout masks."""
        return not self.parity_noop_dropout and self.dropout_rate > 0.0

    def _dropout(self, x: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
        if u is None or not self.dropout_active:
            return x
        keep = 1.0 - self.dropout_rate
        return torch.where(u.reshape(x.shape) < keep, x / keep, torch.zeros_like(x))

    def forward(self, obs: torch.Tensor, dropout_uniforms: torch.Tensor | None = None):
        """``dropout_uniforms``: float ``[2, N, hidden]`` in [0, 1) (actor,
        critic) for a training forward of ``N`` boards; None is ``train=False``."""
        lead = obs.shape[:-3]
        x = obs.reshape(lead + (-1,)).to(self.dtype)
        u = (None, None) if dropout_uniforms is None else dropout_uniforms
        a = self._dropout(F.relu6(self.actor_fc(x)), u[0])
        logits = self.actor_out(a)
        if self.parity_relu_head:
            logits = F.relu(logits)
        c = self._dropout(F.relu6(self.critic_fc(x)), u[1])
        value = self.critic_out(c)
        return logits.to(torch.float32), value.to(torch.float32).squeeze(-1)


class CNNPolicy(nn.Module):
    """The reference DDPG actor's CNN with a value head (``nets.py:85-106``).

    conv 2x2 ``VALID`` 32, relu, conv 2x2 ``VALID`` 64, relu, flatten (h, w,
    c: 256 features), dense 4 logits and dense 1 value; compute in ``dtype``.
    """

    def __init__(self, channels=(32, 64), dtype=torch.bfloat16, generator=None, in_channels: int = 16):
        super().__init__()
        self.dtype = dtype
        cins = (in_channels,) + tuple(channels[:-1])
        self.convs = nn.ModuleList(Conv(i, o, dtype, size=2, padding=0) for i, o in zip(cins, channels))
        flat = (4 - len(channels)) ** 2 * channels[-1]
        self.policy = Dense(flat, NUM_ACTIONS, dtype)
        self.value = Dense(flat, 1, dtype)
        _reset(self, generator)

    def forward(self, obs: torch.Tensor):
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + obs.shape[-3:])
        for conv in self.convs:
            x = F.relu(conv(x))
        flat = x.flatten(1)
        logits, value = self.policy(flat), self.value(flat)
        return logits.to(torch.float32).reshape(lead + (NUM_ACTIONS,)), value.to(torch.float32).reshape(lead)


class ResBlock(nn.Module):
    """Pre-activation residual block (LayerNorm -> relu -> conv) x2."""

    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.norm0 = LayerNormReLU(channels)
        self.conv0 = Conv(channels, channels, dtype)
        self.norm1 = LayerNormReLU(channels)
        self.conv1 = Conv(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(self.norm0(x))
        h = self.conv1(self.norm1(h))
        return x + h


class ResNetPolicy(nn.Module):
    """Flagship residual policy+value tower (``nets.py:126-160``).

    One-hot planes -> stem conv -> ``num_blocks`` pre-activation blocks ->
    LayerNorm, relu -> policy head (dense ``channels``, relu, dense 4) and
    value head (dense ``channels``, relu, dense 1).
    """

    def __init__(self, channels: int = 64, num_blocks: int = 4, dtype=torch.bfloat16, generator=None, in_channels: int = 16):
        super().__init__()
        self.channels, self.num_blocks, self.dtype = channels, num_blocks, dtype
        self.stem = Conv(in_channels, channels, dtype)
        self.blocks = nn.ModuleList(ResBlock(channels, dtype) for _ in range(num_blocks))
        self.norm = LayerNormReLU(channels)
        flat = 16 * channels
        self.policy_fc = Dense(flat, channels, dtype)
        self.policy_out = Dense(channels, NUM_ACTIONS, dtype)
        self.value_fc = Dense(flat, channels, dtype)
        self.value_out = Dense(channels, 1, dtype)
        _reset(self, generator)

    def forward(self, obs: torch.Tensor):
        lead = obs.shape[:-3]
        x = self.stem(obs.reshape((-1,) + obs.shape[-3:]))
        for block in self.blocks:
            x = block(x)
        flat = self.norm(x).flatten(1)  # (h, w, c) order, as in Flax
        logits = self.policy_out(F.relu(self.policy_fc(flat)))
        value = self.value_out(F.relu(self.value_fc(flat)))
        return (
            logits.to(torch.float32).reshape(lead + (NUM_ACTIONS,)),
            value.to(torch.float32).reshape(lead),
        )


class QNetwork(nn.Module):
    """Q(s, .) over all actions; optional dueling heads (``nets.py:163-192``).

    conv 2x2 ``VALID`` ``channels[0]``, relu, conv 2x2 ``VALID``
    ``channels[1]``, relu, flatten (h, w, c), dense ``hidden`` (``trunk``),
    relu, then ``q = v + a - mean(a)`` from the ``advantage`` and
    ``state_value`` heads, or one ``q`` head; computed in ``dtype``,
    returned as float32 ``[..., 4]``.
    """

    def __init__(
        self, channels=(32, 64), hidden: int = 128, dueling: bool = True, dtype=torch.bfloat16, generator=None,
        in_channels: int = 16,
    ):
        super().__init__()
        self.dueling, self.dtype = dueling, dtype
        cins = (in_channels,) + tuple(channels[:-1])
        self.convs = nn.ModuleList(Conv(i, o, dtype, size=2, padding=0) for i, o in zip(cins, channels))
        self.trunk = Dense((4 - len(channels)) ** 2 * channels[-1], hidden, dtype)
        if dueling:
            self.advantage = Dense(hidden, NUM_ACTIONS, dtype)
            self.state_value = Dense(hidden, 1, dtype)
        else:
            self.q = Dense(hidden, NUM_ACTIONS, dtype)
        _reset(self, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + obs.shape[-3:])
        for conv in self.convs:
            x = F.relu(conv(x))
        x = F.relu(self.trunk(x.flatten(1)))
        if self.dueling:
            adv = self.advantage(x)
            q = self.state_value(x) + adv - adv.mean(-1, keepdim=True)
        else:
            q = self.q(x)
        return q.to(torch.float32).reshape(lead + (NUM_ACTIONS,))


_MODELS = {"mlp": A3CMLP, "cnn": CNNPolicy, "resnet": ResNetPolicy}


def make_model(name: str, **kwargs) -> nn.Module:
    """Model registry (``mlp | cnn | resnet``, as in the JAX package)."""
    try:
        cls = _MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model '{name}'; choose from {sorted(_MODELS)}") from None
    return cls(**kwargs)
