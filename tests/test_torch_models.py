# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's ResNetPolicy and encoders against the Flax versions.

Parameters come from a Flax init and are carried across by
``params_from_flax``; the same boards go through both nets.

Tolerances. float32 on both sides: the two frameworks sum the
convolutions and layer-norm statistics in different orders, which moves
outputs of size ~1 by a few float32 ulps (1.2e-6 measured at the full
width), so ``atol = rtol = 1e-5`` leaves a margin of ~8x. bfloat16 compute
on both sides: the frameworks round to bfloat16 at different points (a
fused conv bias, the order of the dense sums), and the outputs, of size
~1.5, differed by up to one bfloat16 ulp (2**-7) at the full width;
``atol = 0.03`` (4 ulps) bounds that with margin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rein48_tpu.models import nets as jnets
from rein48_tpu.models import obs as jobs
from rein48_tpu_torch.models import convert, nets, obs

from test_torch_engine import random_boards

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 0.03


def _pair(channels, num_blocks, jdtype, tdtype):
    jm = jnets.ResNetPolicy(channels=channels, num_blocks=num_blocks, dtype=jdtype)
    params = jm.init(jax.random.key(1), jobs.encode_onehot(jnp.zeros((1, 4, 4), jnp.uint8)))["params"]
    tm = convert.resnet_from_flax(jax.tree.map(np.asarray, params), dtype=tdtype)
    return jm, params, tm


def _outputs(jm, params, tm, boards):
    jl, jv = jm.apply({"params": params}, jobs.encode_onehot(jnp.asarray(boards)))
    with torch.no_grad():
        tl, tv = tm(obs.encode_onehot(torch.from_numpy(boards)))
    return (np.asarray(jl), np.asarray(jv)), (tl.numpy(), tv.numpy())


@pytest.mark.parametrize("channels, num_blocks", [(8, 2), (64, 4)])
class TestResNetPolicy:
    def test_float32_matches_flax(self, channels, num_blocks):
        boards = random_boards(np.random.default_rng(0), 256)
        (jl, jv), (tl, tv) = _outputs(*_pair(channels, num_blocks, jnp.float32, torch.float32), boards)
        assert tl.shape == (256, 4) and tv.shape == (256,)
        np.testing.assert_allclose(tl, jl, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(tv, jv, atol=F32_TOL, rtol=F32_TOL)
        assert np.abs(jv).max() > 0.1  # a live net, not a zero output

    def test_bfloat16_matches_flax(self, channels, num_blocks):
        boards = random_boards(np.random.default_rng(1), 256)
        (jl, jv), (tl, tv) = _outputs(*_pair(channels, num_blocks, jnp.bfloat16, torch.bfloat16), boards)
        np.testing.assert_allclose(tl, jl, atol=BF16_ATOL, rtol=0)
        np.testing.assert_allclose(tv, jv, atol=BF16_ATOL, rtol=0)


def _flax_pair(name, jdtype, tdtype, encoding="onehot", **kwargs):
    """A Flax net of the registry, one init, and the port's net holding it."""
    jm = jnets.make_model(name, dtype=jdtype, **kwargs)
    obs_fn = jobs.encode_onehot if encoding == "onehot" else (lambda b: jobs.encode_raw(b)[..., None])
    params = jm.init(jax.random.key(2), obs_fn(jnp.zeros((1, 4, 4), jnp.uint8)))["params"]
    tm = convert.model_from_flax(name, jax.tree.map(np.asarray, params), dtype=tdtype, **kwargs)
    return jm, params, tm, obs_fn


A3C_NETS = [("mlp", "onehot", {}), ("mlp", "raw", {}), ("mlp", "onehot", {"parity_relu_head": False}), ("cnn", "onehot", {})]


class TestA3CNets:
    """``A3CMLP`` and ``CNNPolicy`` loaded from Flax against Flax. Raw tiles
    stay below 2**13, where the JAX encoder's float exp2 is exact."""

    def _outputs(self, name, encoding, kwargs, jdtype, tdtype, seed):
        jm, params, tm, obs_fn = _flax_pair(name, jdtype, tdtype, encoding, **kwargs)
        boards = np.minimum(random_boards(np.random.default_rng(seed), 256), 12)
        jl, jv = jm.apply({"params": params}, obs_fn(jnp.asarray(boards)))
        tobs = obs.encode_onehot(torch.from_numpy(boards)) if encoding == "onehot" else obs.encode_raw(torch.from_numpy(boards))[..., None]
        with torch.no_grad():
            tl, tv = tm(tobs)
        assert tl.shape == (256, 4) and tv.shape == (256,) and tl.dtype == tv.dtype == torch.float32
        assert set(tm.state_dict()) == set(convert.state_dict_from_flax(tm, jax.tree.map(np.asarray, params)))
        assert nets.count_params(tm) == sum(int(np.asarray(p).size) for p in jax.tree.leaves(params))
        return (np.asarray(jl), np.asarray(jv)), (tl.numpy(), tv.numpy())

    @pytest.mark.parametrize("name, encoding, kwargs", A3C_NETS)
    def test_float32_matches_flax(self, name, encoding, kwargs):
        (jl, jv), (tl, tv) = self._outputs(name, encoding, kwargs, jnp.float32, torch.float32, 4)
        scale = max(1.0, float(np.abs(jv).max()))  # raw tiles reach 4096: outputs in the hundreds
        np.testing.assert_allclose(tl, jl, atol=F32_TOL * scale, rtol=F32_TOL)
        np.testing.assert_allclose(tv, jv, atol=F32_TOL * scale, rtol=F32_TOL)
        assert np.abs(jv).max() > 0.1

    @pytest.mark.parametrize("name, encoding, kwargs", [c for c in A3C_NETS if c[1] == "onehot"])
    def test_bfloat16_matches_flax(self, name, encoding, kwargs):
        (jl, jv), (tl, tv) = self._outputs(name, encoding, kwargs, jnp.bfloat16, torch.bfloat16, 5)
        np.testing.assert_allclose(tl, jl, atol=BF16_ATOL, rtol=0)
        np.testing.assert_allclose(tv, jv, atol=BF16_ATOL, rtol=0)


class TestModule:
    def test_leading_dims_and_state_dict_keys(self):
        jm, params, tm = _pair(8, 1, jnp.float32, torch.float32)
        assert set(convert.params_from_flax(jax.tree.map(np.asarray, params))) == set(tm.state_dict())
        boards = torch.from_numpy(random_boards(np.random.default_rng(2), 24)).reshape(2, 3, 4, 4, 4)
        with torch.no_grad():
            logits, value = tm(obs.encode_onehot(boards))
            flat_logits, flat_value = tm(obs.encode_onehot(boards.reshape(24, 4, 4)))
        assert logits.shape == (2, 3, 4, 4) and value.shape == (2, 3, 4)
        assert torch.equal(logits.reshape(24, 4), flat_logits)
        assert nets.count_params(tm) == sum(int(np.asarray(p).size) for p in jax.tree.leaves(params))

    def test_seeded_init_is_reproducible(self):
        a = nets.ResNetPolicy(8, 1, generator=torch.Generator().manual_seed(3))
        b = nets.ResNetPolicy(8, 1, generator=torch.Generator().manual_seed(3))
        for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(va, vb), k

    def test_registry(self):
        # JAX's registry: exactly mlp | cnn | resnet, ValueError for any other name.
        assert set(nets._MODELS) == set(jnets._MODELS) == {"mlp", "cnn", "resnet"}
        assert isinstance(nets.make_model("resnet", channels=8, num_blocks=1), nets.ResNetPolicy)
        assert isinstance(nets.make_model("mlp"), nets.A3CMLP)
        assert isinstance(nets.make_model("cnn"), nets.CNNPolicy)
        for name in ("qnet", "transformer"):
            with pytest.raises(ValueError, match="unknown model"):
                nets.make_model(name)
            with pytest.raises(ValueError, match="unknown model"):
                jnets.make_model(name)


class TestEncoders:
    def test_encoders_bit_equal(self):
        boards = np.random.default_rng(3).integers(0, 16, (512, 4, 4)).astype(np.uint8)
        tb, jb = torch.from_numpy(boards), jnp.asarray(boards)
        np.testing.assert_array_equal(
            obs.encode_onehot(tb).to(torch.float32).numpy(), np.asarray(jobs.encode_onehot(jb), np.float32)
        )
        assert obs.encode_onehot(tb).dtype == torch.bfloat16
        raw = obs.encode_raw(tb).numpy()
        np.testing.assert_array_equal(raw, np.where(boards > 0, 2.0 ** boards, 0.0))
        # The JAX encoder takes float exp2, which XLA:CPU rounds wrongly at
        # exponents 13 and 15 (8192.0039, 32767.984); the port's integer
        # shifts are exact. Elsewhere the two are bit-equal.
        exact = (boards != 13) & (boards != 15)
        np.testing.assert_array_equal(raw[exact], np.asarray(jobs.encode_raw(jb))[exact])
        np.testing.assert_array_equal(
            obs.encode_log2_scalar(tb).numpy(), np.asarray(jobs.encode_log2_scalar(jb))
        )
