"""The 2048 game in plain PyTorch, written from the rules.

Boards are ``uint8[N, 4, 4]`` tile exponents (0 empty). A move slides every
line toward one side and merges equal neighbours once, nearest the wall
first, paying the merged tile's value; a move that changes nothing is
illegal. After a legal move a tile spawns on a uniform blank cell (a 4 with
probability 0.1, else a 2) drawn from the env's stream words; a full board
with no equal neighbours is over, and an auto-reset game starts again from a
blank board with one tile. Actions: 0 up, 1 down, 2 left, 3 right.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import philox

SPAWN4_BELOW = 1677722  # round(0.1 * 2**24): a 24-bit uniform under it spawns a 4
TOP_EXPONENT = 15


def _to_rows(boards: torch.Tensor, action: int) -> torch.Tensor:
    """Lines ``[N, 4, 4]`` that slide toward index 0 of the last axis."""
    if action == 0:
        return boards.transpose(1, 2)
    if action == 1:
        return boards.transpose(1, 2).flip(2)
    if action == 2:
        return boards
    return boards.flip(2)


def _from_rows(rows: torch.Tensor, action: int) -> torch.Tensor:
    if action == 0:
        return rows.transpose(1, 2)
    if action == 1:
        return rows.flip(2).transpose(1, 2)
    if action == 2:
        return rows
    return rows.flip(2)


def slide_left(rows: torch.Tensor):
    """Slide lines ``[M, 4]`` (int64) to index 0: ``(lines, score)``."""
    m = rows.shape[0]
    pos = torch.arange(4, device=rows.device)
    order = ((rows == 0).long() * 4 + pos).argsort(-1)
    packed = rows.gather(1, order)
    out = torch.zeros_like(rows)
    write = torch.zeros(m, dtype=torch.int64, device=rows.device)
    held = torch.zeros(m, dtype=torch.int64, device=rows.device)
    score = torch.zeros(m, dtype=torch.int64, device=rows.device)
    one = torch.ones(m, dtype=torch.int64, device=rows.device)

    def put(mask, value):
        hot = (pos[None, :] == write[:, None]) & mask[:, None]
        out.copy_(torch.where(hot, value[:, None], out))
        write.add_(mask.long())

    for j in range(4):
        v = packed[:, j]
        merge = (v != 0) & (held == v)
        put(merge, torch.clamp(v + 1, max=TOP_EXPONENT))
        score.add_(torch.where(merge, one << (v + 1), 0))
        flush = (v != 0) & ~merge & (held != 0)
        put(flush, held)
        held = torch.where(merge, 0, torch.where(v != 0, v, held))
    put(held != 0, held)
    return out, score


def move(boards: torch.Tensor, actions: torch.Tensor):
    """``(afterstates uint8[N,4,4], merge score float32[N], changed bool[N])``."""
    b = boards.long()
    after = torch.zeros_like(b)
    score = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    for a in range(4):
        lines, s = slide_left(_to_rows(b, a).reshape(-1, 4))
        moved = _from_rows(lines.reshape(-1, 4, 4), a)
        sel = actions == a
        after = torch.where(sel[:, None, None], moved, after)
        score = torch.where(sel, s.reshape(-1, 4).sum(-1), score)
    changed = (after != b).flatten(1).any(-1)
    return after.to(torch.uint8), score.to(torch.float32), changed


def all_moves(boards: torch.Tensor):
    """Every action of every board: ``[N, 4, 4, 4]`` afterstates, ``[N, 4]``
    scores and legality."""
    n = boards.shape[0]
    rep = boards[:, None].expand(n, 4, 4, 4).reshape(-1, 4, 4)
    acts = torch.arange(4, device=boards.device).repeat(n)
    after, score, changed = move(rep, acts)
    return after.reshape(n, 4, 4, 4), score.reshape(n, 4), changed.reshape(n, 4)


def place(boards: torch.Tensor, word: torch.Tensor, value_word: torch.Tensor, enabled: torch.Tensor) -> torch.Tensor:
    """Spawn on the ``((word >> 8) * blanks) >> 24``-th blank cell, row-major."""
    flat = boards.reshape(-1, 16).clone()
    blank = flat == 0
    nblank = blank.sum(-1)
    rank = ((word >> 8) * nblank) >> 24
    nth = torch.cumsum(blank.long(), -1) - 1
    exp = torch.where((value_word >> 8) < SPAWN4_BELOW, 2, 1).to(flat.dtype)
    hit = blank & (nth == rank[:, None]) & (enabled & (nblank > 0))[:, None]
    flat = torch.where(hit, exp[:, None], flat)
    return flat.reshape(boards.shape)


def game_over(boards: torch.Tensor) -> torch.Tensor:
    full = (boards != 0).flatten(1).all(-1)
    pairs = (boards[:, :, 1:] == boards[:, :, :-1]).flatten(1).any(-1) | (boards[:, 1:, :] == boards[:, :-1, :]).flatten(1).any(-1)
    return full & ~pairs


@dataclasses.dataclass
class Games:
    """Auto-reset games: boards, episode score and length, stream counters."""

    seed: int
    boards: torch.Tensor
    score: torch.Tensor
    length: torch.Tensor
    counter: torch.Tensor

    @property
    def env(self) -> torch.Tensor:
        return torch.arange(self.boards.shape[0], dtype=torch.int64, device=self.boards.device)


def new_games(seed: int, n: int, device) -> Games:
    env = torch.arange(n, dtype=torch.int64, device=device)
    w = philox.env_step_words(seed, env, torch.zeros_like(env))
    blank = torch.zeros((n, 4, 4), dtype=torch.uint8, device=device)
    boards = place(blank, w[:, 3], w[:, 4], torch.ones(n, dtype=torch.bool, device=device))
    zero = torch.zeros(n, dtype=torch.float32, device=device)
    return Games(seed, boards, zero, zero.clone(), torch.ones_like(env))


def step(games: Games, actions: torch.Tensor):
    """One auto-reset step: ``(games, reward, done, after)``; ``after`` is the
    afterstate before the spawn."""
    w = philox.env_step_words(games.seed, games.env, games.counter)
    after, reward, changed = move(games.boards, actions)
    spawned = place(after, w[:, 1], w[:, 2], changed)
    done = game_over(spawned)
    fresh = place(torch.zeros_like(spawned), w[:, 3], w[:, 4], done)
    boards = torch.where(done[:, None, None], fresh, spawned)
    score = torch.where(done, 0.0, games.score + reward)
    length = torch.where(done, 0.0, games.length + 1)
    return Games(games.seed, boards, score, length, games.counter + 1), reward, done, after


def log2_reward(r: torch.Tensor) -> torch.Tensor:
    return torch.log2(1.0 + r)
