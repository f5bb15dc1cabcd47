# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Counter-based random words: Philox4x32-10 in plain PyTorch.

The port's counterpart of ``jax.random`` (the JAX engine's per-env
threefry keys) and of the TPU core's hardware PRNG (the Pallas rollout
kernel's ``pltpu.prng_random_bits``). Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011) maps a 128-bit
counter and a 64-bit key to four 32-bit words with ten rounds of
multiply/xor; the CUDA rollout kernel (``csrc/rollout.cu``) computes the
same function in registers, so the plain version here is what the kernel
is held against bit for bit.

Stream layout, shared with the kernel. Each environment owns a stream
keyed by ``(seed, env)``: the key is ``(seed mod 2**32, seed >> 32)`` and
block ``b`` of the stream is the Philox output for the counter
``(b mod 2**32, b >> 32, env mod 2**32, env >> 32)``. The stream's words
are the blocks' four lanes in order, and step ``n`` of an environment
consumes words ``5n .. 5n+4``:

====  ================  ==============================================
word  name              use
====  ================  ==============================================
0     ``ACTION``        uniform-random action ``word & 3``
1     ``SPAWN_RANK``    blank cell of the spawned tile
2     ``SPAWN_VALUE``   2 or 4 (``core.spawn_exp_from_bits``)
3     ``RESET_RANK``    cell of the fresh tile of a reset board
4     ``RESET_VALUE``   its value
====  ================  ==============================================

A trajectory therefore depends only on its seed, its env index and its
actions, never on the batch it runs in (the property ``rein48_tpu``'s
``core.EnvState`` promises for its per-env keys). The numbers differ from
threefry's: the tests feed both packages the same words instead.

Learner streams. A trainer's own randomness (its shuffles, its exploration
draws, its action-sampling noise, its dropout masks) comes from the same
function under the same key, with the counter ``(block mod 2**32,
update_step, purpose, LEARNER_TAG)``. ``LEARNER_TAG`` is nonzero and an env
stream's last counter word is ``env >> 32``, which is 0 for any batch under
2**32 games, so no env stream reaches a learner block. A draw is therefore
named by ``(seed, update_step, purpose)`` and a draw index, and a state that
holds the seed and the step as integers resumes the same draws on any
device. Each draw is one call over a whole update's or phase's words.

Words are carried as ``int64`` holding values in ``[0, 2**32)``: CPU torch
has no ``>>`` on ``uint32``, and the 32x32-bit products are taken in
16-bit limbs so that no intermediate overflows a signed 64-bit integer.
"""

from __future__ import annotations

import math

import torch

WORDS_PER_STEP = 5
ACTION, SPAWN_RANK, SPAWN_VALUE, RESET_RANK, RESET_VALUE = range(WORDS_PER_STEP)

# The last counter word of every learner block ("LRNR").
LEARNER_TAG = 0x4C524E52
# Learner purposes: the high 16 bits of the third counter word; the low 16
# bits number the draws of one purpose within an update (an epoch).
SHUFFLE, EPSILON, SAMPLE, DROPOUT, REPLAY = 1, 2, 3, 4, 5

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9  # golden ratio
PHILOX_W1 = 0xBB67AE85  # sqrt(3) - 1
PHILOX_ROUNDS = 10


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` words of ``a * m`` for 32-bit ``a`` (int64) and ``m``."""
    t = a * (m & 0xFFFF)  # < 2**48
    u = a * (m >> 16)  # < 2**48
    mid = ((u & 0xFFFF) << 16) + t  # < 2**49
    return (u >> 16) + (mid >> 32), mid & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors of 32-bit words (broadcasting).

    Returns the four output words as int64 tensors in ``[0, 2**32)``.
    """
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def stream_blocks(seed, env: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Block ``block`` of the stream ``(seed, env)``: int64 ``[..., 4]``.

    ``seed`` is an int or an int64 tensor; all arguments broadcast.
    """
    if not torch.is_tensor(seed):
        seed = torch.tensor(seed, dtype=torch.int64, device=env.device)
    words = philox4x32(
        block & MASK32,
        (block >> 32) & MASK32,
        env & MASK32,
        (env >> 32) & MASK32,
        seed & MASK32,
        (seed >> 32) & MASK32,
    )
    return torch.stack(torch.broadcast_tensors(*words), dim=-1)


def step_words(seed, env: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """The five words of step ``step`` of streams ``(seed, env)``.

    Returns int64 ``[..., 5]`` over the broadcast shape of the arguments,
    ordered as the module's table says (action first).
    """
    if torch.is_tensor(seed) and seed.ndim:
        seed = seed.unsqueeze(-1)
    first = step * WORDS_PER_STEP
    block = (first >> 2).unsqueeze(-1) + torch.arange(2, device=env.device)
    # Five consecutive words always span exactly two blocks.
    words = stream_blocks(seed, env.unsqueeze(-1), block)  # [..., 2, 4]
    words = words.flatten(-2)
    lane = (first & 3).unsqueeze(-1) + torch.arange(WORDS_PER_STEP, device=env.device)
    return torch.gather(words, -1, lane.expand(words.shape[:-1] + (WORDS_PER_STEP,)))


def philox_bits(
    seed, num_steps: int, batch: int, *, start_step: int = 0, device=None
) -> torch.Tensor:
    """Random words of envs ``0..batch-1`` for steps ``start_step..+T``.

    Returns int64 ``[T, 5, B]``: the layout the rollout kernel consumes in
    its injected-bits mode and generates itself in Philox mode.
    """
    env = torch.arange(batch, dtype=torch.int64, device=device)
    step = torch.arange(start_step, start_step + num_steps, dtype=torch.int64, device=device)
    words = step_words(seed, env[None, :], step[:, None])  # [T, B, 5]
    return words.permute(0, 2, 1).contiguous()


def learner_words(seed: int, update_step: int, purpose: int, shape, *, index: int = 0, device=None) -> torch.Tensor:
    """Words of the learner stream ``(seed, update_step, purpose, index)``.

    Returns int64 of ``shape`` in ``[0, 2**32)``: the stream's first
    ``prod(shape)`` words, block by block, in row-major order.
    """
    if not (0 <= seed < 1 << 64 and 0 <= update_step <= MASK32 and 0 <= index <= 0xFFFF):
        raise ValueError(f"learner stream out of range: seed {seed}, update_step {update_step}, index {index}")
    n = math.prod(shape)
    blocks = torch.arange(-(-n // 4), dtype=torch.int64, device=device)

    def word(v):
        return torch.tensor(v & MASK32, dtype=torch.int64, device=device)

    words = philox4x32(
        blocks, word(update_step), word((purpose << 16) | index), word(LEARNER_TAG), word(seed), word(seed >> 32)
    )
    return torch.stack(torch.broadcast_tensors(*words), dim=-1).flatten()[:n].reshape(shape)


def below_from_words(words: torch.Tensor, n) -> torch.Tensor:
    """Integers in ``[0, n)`` from 32-bit words: ``(word * n) >> 32``, exact in
    int64 for ``n <= 2**31`` (an int or an int64 tensor that broadcasts)."""
    return (words * n) >> 32


def uniform_from_words(words: torch.Tensor) -> torch.Tensor:
    """float32 in ``[0, 1)``: the top 24 bits of each word times ``2**-24`` (exact)."""
    return (words >> 8).to(torch.float32) * 2.0**-24


def open_uniform_from_words(words: torch.Tensor) -> torch.Tensor:
    """float32 in ``(0, 1)``: the odd multiples of ``2**-24`` from the top 23
    bits (exact), so that neither ``log(u)`` nor ``log(1 - u)`` is infinite."""
    return ((words >> 9) * 2 + 1).to(torch.float32) * 2.0**-24


def learner_uniform(seed: int, update_step: int, purpose: int, shape, *, index: int = 0, device=None) -> torch.Tensor:
    """float32 uniforms in ``[0, 1)`` of the learner stream, one per word."""
    return uniform_from_words(learner_words(seed, update_step, purpose, shape, index=index, device=device))


def learner_gumbel(seed: int, update_step: int, shape, *, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of the ``SAMPLE`` stream:
    ``argmax(logits + noise)`` samples ``softmax(logits)``."""
    u = open_uniform_from_words(learner_words(seed, update_step, SAMPLE, shape, device=device))
    return -torch.log(-torch.log(u))
