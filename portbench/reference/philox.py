"""Philox4x32-10 and the streams the 2048 engine and the learners draw from.

A frozen plain copy of the published generator (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011) and of the project's stream
layout, so that the reference steps the same games as the program without
importing it:

* env stream ``(seed, env)``: key ``(seed mod 2**32, seed >> 32)``, block
  ``b`` at counter ``(b mod 2**32, b >> 32, env mod 2**32, env >> 32)``;
  step ``n`` of an env reads words ``5n .. 5n+4`` (action, spawn rank,
  spawn value, reset rank, reset value);
* learner stream ``(seed, update, purpose, index)``: counter ``(block,
  update, purpose << 16 | index, 0x4C524E52)``.

Words are int64 tensors holding 32-bit values.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
LEARNER_TAG = 0x4C524E52
SHUFFLE, SAMPLE = 1, 3


def _mul(a: torch.Tensor, m: int):
    lo16 = a * (m & 0xFFFF)
    hi16 = a * (m >> 16)
    mid = ((hi16 & 0xFFFF) << 16) + lo16
    return (hi16 >> 16) + (mid >> 32), mid & M32


def philox(c0, c1, c2, c3, k0, k1):
    """Ten rounds; every argument an int64 tensor (or int) of 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & M32
            k1 = (k1 + _W1) & M32
        h0, l0 = _mul(c0, _M0)
        h1, l1 = _mul(c2, _M1)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def env_step_words(seed: int, env: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """int64 ``[N, 5]``: the five words of step ``step[i]`` of env ``env[i]``."""
    first = step * 5
    blocks = (first >> 2)[:, None] + torch.arange(2, device=env.device)
    e = env[:, None].expand_as(blocks)
    seed_t = torch.full_like(blocks, seed)
    w = philox(blocks & M32, (blocks >> 32) & M32, e & M32, (e >> 32) & M32, seed_t & M32, (seed_t >> 32) & M32)
    words = torch.stack(w, dim=-1).reshape(env.shape[0], 8)
    lane = (first & 3)[:, None] + torch.arange(5, device=env.device)
    return torch.gather(words, 1, lane)


def learner_words(seed: int, update: int, purpose: int, shape, device, index: int = 0) -> torch.Tensor:
    n = math.prod(shape)
    blocks = torch.arange(-(-n // 4), dtype=torch.int64, device=device)

    def const(v):
        return torch.full_like(blocks, v & M32)

    w = philox(blocks, const(update), const((purpose << 16) | index), const(LEARNER_TAG), const(seed), const(seed >> 32))
    return torch.stack(w, dim=-1).reshape(-1)[:n].reshape(shape)


def gumbel(seed: int, update: int, shape, device) -> torch.Tensor:
    """Standard Gumbel noise from the ``SAMPLE`` stream: odd multiples of
    2**-24 from the top 23 bits as the open uniform, then ``-log(-log u)``."""
    w = learner_words(seed, update, SAMPLE, shape, device)
    u = ((w >> 9) * 2 + 1).to(torch.float32) * 2.0**-24
    return -torch.log(-torch.log(u))


def shuffles(seed: int, update: int, epochs: int, steps: int, batch: int, device) -> torch.Tensor:
    """Per epoch a permutation of the time axis within each env (stable
    argsort of the ``SHUFFLE`` words): int64 ``[epochs, T, B]``."""
    w = learner_words(seed, update, SHUFFLE, (epochs, steps, batch), device)
    return w.argsort(dim=1, stable=True)
