# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The fused layer norm and ReLU (``ops/layer_norm.py``) on the CPU.

On the CPU ``layer_norm_relu`` runs its plain version, ``layer_norm_reference``
then ``F.relu``, and must stay bit for bit the composition the port ran
before the kernel (``LayerNorm.forward`` as it was, then ``F.relu``), in its output and in the
gradients autograd gives for ``x``, ``scale`` and ``bias``; the card tests
(``tests/test_torch_cuda.py -k layer_norm``) hold the kernel to the plain
version. Here also: the whole ``ResNetPolicy`` on the CPU equals the tower
run through the old composition, no kernel counter moves, the inputs the
kernel does not take raise on every device, and the plain version agrees
with Flax's ``nn.LayerNorm`` (then ``nn.relu``) at float32 (rtol = atol = 1e-5,
``tests/test_torch_models.py``'s float32 tolerance: the frameworks add the
statistics in other orders).
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rein48_tpu_torch.models import nets, obs
from rein48_tpu_torch.ops import layer_norm as ln
from rein48_tpu_torch.utils import profiling

from test_torch_engine import random_boards

torch.set_num_threads(1)

COUNTERS = ("layer_norm.forward_launches", "layer_norm.backward_launches", "layer_norm.backward_sum_launches",
            "layer_norm.bound_bytes")


def old_layer_norm_relu(x, scale, bias, eps):
    """``nets.LayerNorm.forward`` as it was before the kernel (its ``dtype``
    the input's, as the convolutions give it), then ``F.relu``."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (x - mean) * (torch.rsqrt(var + eps) * scale) + bias
    return F.relu(y.to(dtype))


def inputs(shape, dtype, seed: int = 0, constant_rows: int = 0):
    """``x`` (some rows constant, where the variance clamp acts), a scale
    around 1 and a bias around 0, all requiring gradients."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 1.5 + 0.25).to(dtype)
    flat = x.view(-1, shape[-1])
    rows = min(constant_rows, flat.shape[0])
    flat[:rows] = (torch.arange(rows) * 0.37 - 1.0).to(dtype)[:, None]
    c = shape[-1]
    scale = 1.0 + 0.2 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    return [t.clone().requires_grad_(True) for t in (x, scale, bias)]


def forward_and_grads(fn, x, scale, bias, eps, seed: int = 1):
    out = fn(x, scale, bias, eps)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(out.dtype)
    return (out,) + torch.autograd.grad(out, (x, scale, bias), dy)


CASES = [
    ((7, 4, 4, 64), torch.bfloat16),
    ((5, 4, 4, 64), torch.float32),
    ((33, 8), torch.float32),
    ((3, 4, 4, 128), torch.bfloat16),
    ((9, 48), torch.bfloat16),
    ((9, 256), torch.float32),
    ((6, 1), torch.float32),
    ((2, 3, 4, 4, 64), torch.bfloat16),
    ((3, 2, 4, 4, 16), torch.float32),
    ((17, 16), torch.bfloat16),
    ((1, 256), torch.bfloat16),
    ((40, 24), torch.float32),
    ((0, 64), torch.bfloat16),
]


class TestPlainPath:
    @pytest.mark.parametrize("shape, dtype", CASES)
    def test_bit_equal_to_the_old_composition(self, shape, dtype):
        x, scale, bias = inputs(shape, dtype, constant_rows=3)
        got = forward_and_grads(ln.layer_norm_relu, x, scale, bias, 1e-6)
        want = forward_and_grads(old_layer_norm_relu, x, scale, bias, 1e-6)
        assert got[0].dtype == got[1].dtype == dtype
        for name, a, b in zip(("out", "dx", "dscale", "dbias"), got, want):
            assert torch.equal(a, b), name

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_module_call(self, dtype):
        x, scale, bias = inputs((4, 4, 4, 64), dtype)
        norm = nets.LayerNormReLU(64)
        with torch.no_grad():
            norm.scale.copy_(scale)
            norm.bias.copy_(bias)
        assert torch.equal(norm(x), old_layer_norm_relu(x, scale, bias, 1e-6))
        assert set(dict(norm.named_parameters())) == {"scale", "bias"}

    def test_moves_no_counter(self):
        before = {k: profiling.counters.get(k, 0) for k in COUNTERS}
        x, scale, bias = inputs((16, 4, 4, 64), torch.bfloat16)
        forward_and_grads(ln.layer_norm_relu, x, scale, bias, 1e-6)
        model = nets.ResNetPolicy(8, 2, generator=torch.Generator().manual_seed(0))
        logits, value = model(obs.encode_onehot(torch.from_numpy(random_boards(np.random.default_rng(0), 8))))
        (logits.sum() + value.sum()).backward()
        assert {k: profiling.counters.get(k, 0) for k in COUNTERS} == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resnet_equals_the_old_tower(dtype, monkeypatch):
    """The tower's outputs and every parameter's gradient, through the op
    and through the composition it replaced, bit for bit on the CPU."""
    boards = torch.from_numpy(random_boards(np.random.default_rng(3), 32))
    model = nets.ResNetPolicy(16, 2, dtype=dtype, generator=torch.Generator().manual_seed(4))
    runs = []
    for fn in (ln.layer_norm_relu, old_layer_norm_relu):
        monkeypatch.setattr(ln, "layer_norm_relu", fn)
        model.zero_grad()
        logits, value = model(obs.encode_onehot(boards))
        (logits.square().sum() + value.sum()).backward()
        runs.append([logits, value] + [p.grad.clone() for p in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


class TestRefusals:
    def test_unsupported_dtypes(self):
        x, scale, bias = inputs((4, 64), torch.float32)
        for bad in (torch.float16, torch.float64):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                ln.layer_norm_relu(x.detach().to(bad), scale, bias)
        with pytest.raises(ValueError, match="scale must be contiguous float32"):
            ln.layer_norm_relu(x, scale.detach().double(), bias)
        with pytest.raises(ValueError, match="bias must be contiguous float32"):
            ln.layer_norm_relu(x, scale, bias.detach()[:32])

    def test_rows_not_contiguous(self):
        x, scale, bias = inputs((64, 64), torch.bfloat16)
        for bad in (x.detach().t(), torch.randn(8, 80).to(torch.bfloat16)[:, :64]):
            with pytest.raises(ValueError, match="needs x contiguous"):
                ln.layer_norm_relu(bad, scale, bias)

    def test_channels_above_the_maximum(self):
        c = ln.MAX_CHANNELS + 1
        x, scale, bias = inputs((4, c), torch.bfloat16)
        with pytest.raises(ValueError, match=f"1 to {ln.MAX_CHANNELS} channels"):
            ln.layer_norm_relu(x, scale, bias)
        with pytest.raises(ValueError, match=f"1 to {ln.MAX_CHANNELS} channels"):
            nets.ResNetPolicy(c, 1)(torch.zeros(2, 4, 4, 16))

    def test_other_devices(self):
        x, scale, bias = (t.detach().to("meta") for t in inputs((4, 64), torch.bfloat16))
        with pytest.raises(ValueError, match="no layer norm kernel for device meta"):
            ln.layer_norm_relu(x, scale, bias)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c", [8, 64])
def test_plain_version_matches_flax(c, relu):
    """``layer_norm_relu`` against Flax's norm then ReLU, and
    ``layer_norm_reference`` against the norm alone."""
    x = np.random.default_rng(c).normal(0.3, 1.7, size=(64, c)).astype(np.float32)
    x[:2] = 0.5  # constant rows
    module = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(np.linspace(0.5, 1.5, c), jnp.float32),
                         "bias": jnp.asarray(np.linspace(-0.2, 0.2, c), jnp.float32)}}
    want = module.apply(params, jnp.asarray(x))
    want = np.asarray(jax.nn.relu(want) if relu else want)
    args = (torch.from_numpy(x), torch.tensor(np.asarray(params["params"]["scale"])),
            torch.tensor(np.asarray(params["params"]["bias"])), 1e-6)
    got = ln.layer_norm_relu(*args) if relu else ln.layer_norm_reference(*args, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
