# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Card-only tests of the port's CUDA kernels against their plain versions.

They skip without a CUDA device. This file imports no JAX, so that it runs
where the card is and JAX is not; there, from the repository root:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

from __future__ import annotations

import pytest
import torch

from rein48_tpu_torch.engine import fused, philox, vector

pytestmark = pytest.mark.cuda

STAT_FIELDS = ("episodes", "episode_length_sum", "episode_score_sum", "max_exponent")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these comparisons on the card")
    return torch.device("cuda")


def assert_same(got, want):
    (gs, gt), (ws, wt) = got, want
    for name in ("boards", "score", "steps"):
        assert torch.equal(getattr(gs, name).cpu(), getattr(ws, name).cpu()), name
    for name in STAT_FIELDS:
        assert torch.equal(getattr(gt, name).cpu(), getattr(wt, name).cpu()), name


@pytest.mark.parametrize("batch, steps", [(1000, 67), (128, 1), (8192, 64)])
def test_rollout_kernel_matches_plain(cuda, batch, steps):
    # Ragged batches mask the last block; T % 4 != 0 ends inside a word group.
    state = vector.reset_batch(1, batch, cuda)
    bits = philox.philox_bits(4, steps, batch, device=cuda)
    want = fused.rollout_bits_reference(state, bits)
    before = fused.launches
    assert_same(fused.rollout_random_fused(state, 0, steps, bits=bits), want)
    assert_same(fused.rollout_random_fused(state, 4, steps), want)
    assert fused.launches == before + 2


def test_rollout_kernel_rejects_bad_words(cuda):
    state = vector.reset_batch(1, 256, cuda)
    before = fused.launches
    with pytest.raises(ValueError, match="bits must be"):
        fused.rollout_random_fused(state, 0, 8, bits=philox.philox_bits(0, 7, 256, device=cuda))
    assert fused.launches == before
