# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Fused rollout: whole random-policy rollouts in one CUDA kernel.

Port of ``rein48_tpu/engine/fused.py``, whose Pallas kernel
(``_rollout_kernel``) keeps a block of boards in VMEM for the whole
rollout and draws its randomness from the TPU's hardware PRNG. Here the
kernel is ``csrc/rollout.cu``: one thread owns one env for the whole
rollout, its board packed in one 64-bit word in registers, its moves
looked up in the row-merge table of ``engine/lut.py`` held in shared
memory (:func:`row_tables`), its random words from Philox4x32-10 computed
in registers (``engine/philox.py`` gives the layout). Device memory is
read once at entry and written once at exit.

:func:`rollout_random_fused` is the wrapper. A CUDA state launches the
kernel; a CPU state runs the plain version (:func:`rollout_bits_reference`
on the same Philox words). Nothing falls back: a CUDA state either
launches the kernel or raises. The counter ``fused.rollout_launches``
(``utils/profiling.counters``) counts kernel launches.

Semantics are those of the JAX reference's ``fused_step_soa``: a uniform
action from the ``ACTION`` word, the move, a spawn iff the board changed,
the game-over test, an in-place reset, and per-env episode statistics.
The env index of the Philox stream is the env's position in the batch,
counted from ``env_base``: a data-parallel rank that holds envs ``lo..hi``
of the global batch passes ``env_base=lo`` and rolls them on their own
streams. ``state.seed/env_id/counter`` are left untouched, as the JAX
kernel leaves ``state.key``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Sequence

import numpy as np
import torch

from rein48_tpu_torch.engine import core, lut, philox
from rein48_tpu_torch.engine.core import EnvState
from rein48_tpu_torch.utils import profiling

NUM_CELLS = 16
NUM_RAND_PLANES = philox.WORDS_PER_STEP

# Steps of Philox words the plain version draws at a time: bounds its
# memory at B * 64 * 8 words.
_PLAIN_CHUNK = 64


def fused_step_soa(
    cells: Sequence[torch.Tensor],
    score: torch.Tensor,
    steps: torch.Tensor,
    bits: Sequence[torch.Tensor],
):
    """One autoreset env step on 16 cell planes (row-major cell order).

    Port of the JAX ``fused_step_soa``, op for op; the CUDA kernel runs the
    same algebra on registers. ``cells``, ``score`` and ``steps`` are int32;
    ``bits`` are the 5 word planes (int64 holding 32-bit words).

    Returns ``(new_cells, new_score, new_steps, aux)`` with ``aux`` holding
    ``done``, ``changed``, ``reward``, ``episode_score``,
    ``episode_length`` and ``board_max_exp`` (pre-reset values).
    """
    c = list(cells)
    b_act, b_rank, b_val, b_rrank, b_rval = bits
    action = b_act & 3
    is_vert = action <= core.DOWN
    is_rev = (action & 1) == 1

    t = [[torch.where(is_vert, c[4 * p + l], c[4 * l + p]) for p in range(4)] for l in range(4)]
    merged = []
    merge_score = torch.zeros_like(score)
    for l in range(4):
        line = [torch.where(is_rev, t[l][3 - p], t[l][p]) for p in range(4)]
        line, line_score = core.merge_cells_left(*line)
        merged.append(line)
        merge_score = merge_score + line_score

    u = [[torch.where(is_rev, merged[l][3 - p], merged[l][p]) for p in range(4)] for l in range(4)]
    moved = [torch.where(is_vert, u[i % 4][i // 4], u[i // 4][i % 4]) for i in range(NUM_CELLS)]

    changed = moved[0] != c[0]
    for i in range(1, NUM_CELLS):
        changed = changed | (moved[i] != c[i])

    blanks = [m == 0 for m in moved]
    n_blanks = blanks[0].to(torch.int32)
    for i in range(1, NUM_CELLS):
        n_blanks = n_blanks + blanks[i].to(torch.int32)
    rank = core.spawn_rank_from_bits(b_rank, n_blanks)
    value_exp = core.spawn_exp_from_bits(b_val).to(torch.int32)
    enabled = changed & (n_blanks > 0)
    # A disabled spawn targets rank -1, which no running count can hit.
    rank1 = torch.where(enabled, rank + 1, 0)
    spawned = []
    csum = torch.zeros_like(n_blanks)
    for i in range(NUM_CELLS):
        csum = csum + blanks[i].to(torch.int32)
        hit = blanks[i] & (csum == rank1)
        spawned.append(torch.where(hit, value_exp, moved[i]))

    # Post-spawn blanks == n_blanks - enabled.
    full = n_blanks == enabled.to(torch.int32)
    neigh = torch.zeros_like(full)
    for r in range(4):
        for cc in range(3):
            neigh = neigh | (spawned[4 * r + cc] == spawned[4 * r + cc + 1])
    for r in range(3):
        for cc in range(4):
            neigh = neigh | (spawned[4 * r + cc] == spawned[4 * (r + 1) + cc])
    done = full & ~neigh

    episode_score = score + merge_score
    episode_length = steps + 1
    board_max_exp = spawned[0]
    for i in range(1, NUM_CELLS):
        board_max_exp = torch.maximum(board_max_exp, spawned[i])

    r_rank = core.spawn_rank_from_bits(b_rrank, NUM_CELLS)
    r_val = core.spawn_exp_from_bits(b_rval).to(torch.int32)
    new_cells = [
        torch.where(done, torch.where(r_rank == i, r_val, 0), spawned[i])
        for i in range(NUM_CELLS)
    ]
    new_score = torch.where(done, 0, episode_score)
    new_steps = torch.where(done, 0, episode_length)

    aux = dict(
        done=done,
        changed=changed,
        reward=merge_score,
        episode_score=episode_score,
        episode_length=episode_length,
        board_max_exp=board_max_exp,
    )
    return new_cells, new_score, new_steps, aux


@dataclasses.dataclass
class FusedRolloutStats:
    """Per-env episode statistics of one rollout (all ``int32[B]``).

    Attributes:
        episodes: episodes finished during the rollout.
        episode_length_sum: total length of the finished episodes.
        episode_score_sum: total merge score of the finished episodes.
        max_exponent: largest tile exponent seen on the board.
    """

    episodes: torch.Tensor
    episode_length_sum: torch.Tensor
    episode_score_sum: torch.Tensor
    max_exponent: torch.Tensor


def _rollout_plain(state: EnvState, bit_chunks):
    """Scan :func:`fused_step_soa` over ``[t, 5, B]`` word chunks."""
    n = state.boards.shape[0]
    flat = state.boards.reshape(n, NUM_CELLS).to(torch.int32)
    cells = list(flat.unbind(-1))
    score = state.score.to(torch.int32)
    steps = state.steps.to(torch.int32)
    zeros = torch.zeros(n, dtype=torch.int32, device=state.boards.device)
    epc, elen, escore, mxe = zeros, zeros, zeros, zeros
    for chunk in bit_chunks:
        for bits_t in chunk:
            cells, score, steps, aux = fused_step_soa(cells, score, steps, bits_t.unbind(0))
            done = aux["done"]
            epc = epc + done.to(torch.int32)
            elen = elen + torch.where(done, aux["episode_length"], 0)
            escore = escore + torch.where(done, aux["episode_score"], 0)
            mxe = torch.maximum(mxe, aux["board_max_exp"])
    return _result(
        state, torch.stack(cells, -1), score, steps, torch.stack([epc, elen, escore, mxe])
    )


def _result(state, cells, score, steps, stats):
    """Assemble ``(EnvState, FusedRolloutStats)`` from the rollout's outputs."""
    n = state.boards.shape[0]
    new_state = dataclasses.replace(
        state,
        boards=cells.reshape(n, 4, 4).to(torch.uint8),
        score=score.to(torch.float32),
        steps=steps.to(torch.int32),
        done=torch.zeros(n, dtype=torch.bool, device=state.boards.device),
    )
    return new_state, FusedRolloutStats(*stats.to(torch.int32).unbind(0))


def rollout_bits_reference(state: EnvState, bits: torch.Tensor):
    """Plain version of the kernel on injected words ``[T, 5, B]``.

    The counterpart of the JAX ``fused.rollout_bits_reference``; ``bits``
    holds 32-bit words in any integer dtype wide enough (int64 here).
    """
    return _rollout_plain(state, [bits.to(torch.int64)])


def rollout_random_reference(state: EnvState, seed: int, num_steps: int, env_base: int = 0):
    """Plain version of the kernel's Philox mode.

    Equal to ``rollout_bits_reference(state, philox_bits(seed, T, B,
    first_env=env_base))``, drawing the words a chunk of steps at a time.
    """
    n = state.boards.shape[0]
    dev = state.boards.device
    chunks = (
        philox.philox_bits(seed, min(_PLAIN_CHUNK, num_steps - t0), n, start_step=t0, first_env=env_base, device=dev)
        for t0 in range(0, num_steps, _PLAIN_CHUNK)
    )
    return _rollout_plain(state, chunks)


@functools.lru_cache(maxsize=1)
def row_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's form of ``lut.build_row_lut()``: ``(codes, offsets, quarters)``.

    ``codes`` is ``uint16[65536]``, each row's merged code; ``quarters`` is
    ``uint16[128]``, the distinct merge scores / 4 in increasing order, then
    zeros; ``offsets`` is ``uint8[65536]``, the byte offset in ``quarters``
    of each row's score (2 x its position). Row ``r``'s packed entry is
    ``codes[r] | quarters[offsets[r] // 2] << 16``.
    """
    packed = lut.build_row_lut()
    values, position = np.unique(packed >> 16, return_inverse=True)
    if len(values) > 128:
        raise AssertionError(f"{len(values)} distinct row scores do not fit a one-byte offset")
    quarters = np.zeros(128, np.uint16)
    quarters[: len(values)] = values
    return lut.lut_new_code(packed).astype(np.uint16), (2 * position).astype(np.uint8), quarters


def row_table_bytes() -> np.ndarray:
    """:func:`row_tables` as the kernel reads them, little-endian and back
    to back: codes, offsets, quarters (``uint8[196864]``)."""
    codes, offsets, quarters = row_tables()
    return np.concatenate([codes.astype("<u2").view(np.uint8), offsets, quarters.astype("<u2").view(np.uint8)])


# The row table on each device, uploaded once.
_device_tables: dict[torch.device, torch.Tensor] = {}


def _device_table(dev: torch.device) -> torch.Tensor:
    table = _device_tables.get(dev)
    if table is None:
        table = _device_tables[dev] = torch.from_numpy(row_table_bytes()).to(dev)
    return table


_ROLLOUT_ARGTYPES = (ctypes.c_void_p,) * 9 + (
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_ulonglong,
    ctypes.c_longlong,
    ctypes.c_void_p,
)


def _words_as_int32(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words in a wider dtype -> int32 with the same bit pattern."""
    if bits.dtype == torch.int32:
        return bits.contiguous()
    bits = bits.to(torch.int64)
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).contiguous()


def _launch(state: EnvState, seed: int, num_steps: int, bits, env_base: int):
    from rein48_tpu_torch import build

    n = state.boards.shape[0]
    if state.boards.shape[1:] != (4, 4) or state.boards.dtype != torch.uint8:
        raise ValueError(f"boards must be uint8[B, 4, 4], got {state.boards.dtype} {tuple(state.boards.shape)}")
    if not 0 <= num_steps < 2**31 or n >= 2**31 or not 0 <= env_base < 2**62:
        raise ValueError(f"num_steps {num_steps}, batch {n} or env_base {env_base} out of range")
    dev = state.boards.device
    for name in ("score", "steps"):
        t = getattr(state, name)
        if t.shape != (n,) or t.device != dev:
            raise ValueError(f"state.{name} must be [{n}] on {dev}, got {tuple(t.shape)} on {t.device}")
    boards = state.boards.reshape(n, NUM_CELLS).contiguous()
    if boards.data_ptr() % 16:  # the kernel loads a board as one 16-byte word
        boards = boards.clone()
    score = state.score.to(torch.int32).contiguous()
    steps = state.steps.to(torch.int32).contiguous()
    words = None
    if bits is not None:
        if tuple(bits.shape) != (num_steps, NUM_RAND_PLANES, n) or bits.device != dev:
            raise ValueError(f"bits must be [{num_steps}, 5, {n}] on {dev}, got {tuple(bits.shape)} on {bits.device}")
        words = _words_as_int32(bits)
    boards_out = torch.empty_like(boards)
    score_out = torch.empty(n, dtype=torch.int32, device=dev)
    steps_out = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty((4, n), dtype=torch.int32, device=dev)
    table = _device_table(dev)

    fn = build.bind("rollout", "rein48_rollout", _ROLLOUT_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(
            boards.data_ptr(),
            score.data_ptr(),
            steps.data_ptr(),
            None if words is None else words.data_ptr(),
            table.data_ptr(),
            boards_out.data_ptr(),
            score_out.data_ptr(),
            steps_out.data_ptr(),
            stats.data_ptr(),
            n,
            num_steps,
            seed & (2**64 - 1),
            env_base,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    profiling.count("fused.rollout_launches")
    if err:
        raise RuntimeError(f"rollout kernel launch failed with CUDA error {err}")
    return _result(state, boards_out, score_out, steps_out, stats)


# Boards known to be legal, by id: the rollouts' outputs and the inputs
# already checked, each with its version counter at the time (an in-place
# edit raises it). Entries go when their tensor does.
_legal: dict[int, tuple[weakref.ref, int]] = {}


def _version(t: torch.Tensor) -> int | None:
    return None if t.is_inference() else t._version  # inference tensors keep no version


def _remember_legal(boards: torch.Tensor) -> None:
    version = _version(boards)
    if version is None:
        return
    key = id(boards)

    def forget(ref):
        if _legal.get(key, (None,))[0] is ref:
            del _legal[key]

    _legal[key] = (weakref.ref(boards, forget), version)


def _check_legal(boards: torch.Tensor) -> None:
    """Raise unless every exponent is at most ``lut.MAX_EXPONENT``: the
    kernel packs a cell into 4 bits. Boards a rollout returned, unchanged
    since, are not read again; others cost one reduction (and, on the card,
    one wait for it)."""
    known = _legal.get(id(boards))
    if known is not None and known[0]() is boards and known[1] == _version(boards):
        return
    top = int(boards.max()) if boards.numel() else 0
    if top > lut.MAX_EXPONENT:
        raise ValueError(f"board exponents must be at most {lut.MAX_EXPONENT}, got {top}")
    _remember_legal(boards)


def rollout_random_fused(
    state: EnvState, seed: int, num_steps: int, bits: torch.Tensor | None = None, env_base: int = 0
):
    """Run ``num_steps`` of uniform-random autoreset play over the batch.

    Args:
        state: batched :class:`EnvState` (leading axis B, any B), its
            boards legal: exponents of at most ``lut.MAX_EXPONENT``.
        seed: key of the Philox streams (an int; env ``i`` of the batch
            uses stream ``(seed, env_base + i)`` from step 0).
        num_steps: rollout length T.
        bits: optional injected words ``[T, 5, B]`` replacing Philox, so
            that the kernel can be held bit for bit against the plain
            version.
        env_base: the global index of the batch's first env, where the
            batch is a slice of a larger one (a rank's share).

    Returns:
        ``(final_state, FusedRolloutStats)``.

    Raises:
        ValueError: a board holds an exponent above ``lut.MAX_EXPONENT``.
    """
    dev = state.boards.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no rollout kernel for device {dev}")
    _check_legal(state.boards)
    if dev.type == "cuda":
        out = _launch(state, int(seed), num_steps, bits, int(env_base))
    elif bits is not None:
        out = rollout_bits_reference(state, bits)
    else:
        out = rollout_random_reference(state, int(seed), num_steps, int(env_base))
    _remember_legal(out[0].boards)
    return out
