"""Expectimax over an n-tuple network's values, in plain PyTorch.

The equations of ``reference/search.py``, one level deeper, with the raw
merge score as the reward and no discount:

``Q(s, a) = r + E_spawn[max_a' (r' + E_spawn'[max_a'' (r'' + V(after''))])]``

over the legal moves of each max node. An expectation runs over every blank
cell of an afterstate and both spawned tiles (2 with probability 0.9, 4
with 0.1), a max node with no legal move is worth 0, and ``V`` is
``reference/ntuple.Network``'s value of an afterstate. ``depth`` counts the
chance levels between a board and its leaves (2 above, 1 in
``reference/search.py``, 0 for greedy play on ``r + V(after)``).

Only the nodes the tree needs are built: the blank-cell children of legal
afterstates, and the leaves of their legal moves. Boards go through in
blocks, so that the deepest level fits in memory.
"""

from __future__ import annotations

import torch

from portbench.reference import engine
from portbench.reference.search import children

# Boards of one block: at depth 2 a board has at most 4 x 32 x 4 x 32 = 16,384
# grandchildren and 65,536 leaves.
BLOCK = 32


def _chance(net, tables, after: torch.Tensor, depth: int) -> torch.Tensor:
    """Values of afterstates ``[M, 4, 4]``: ``V`` at depth 0, else the
    expectation over their spawns of the max nodes one level down."""
    if depth == 0:
        return net.value(tables, after)
    kids, probs = children(after)
    live = probs > 0
    v = torch.zeros(probs.shape, dtype=torch.float32, device=after.device)
    if bool(live.any()):
        v[live] = _max(net, tables, kids[live], depth - 1)
    return (probs * v).sum(-1)


def _q(net, tables, boards: torch.Tensor, depth: int):
    """``(Q [M, 4], legal [M, 4])`` of max nodes ``[M, 4, 4]``, ``-inf`` where illegal."""
    after, score, legal = engine.all_moves(boards)
    v = torch.zeros(legal.shape, dtype=torch.float32, device=boards.device)
    if bool(legal.any()):
        v[legal] = _chance(net, tables, after[legal], depth)
    return torch.where(legal, score + v, -torch.inf), legal


def _max(net, tables, boards: torch.Tensor, depth: int) -> torch.Tensor:
    q, legal = _q(net, tables, boards, depth)
    return torch.where(legal.any(-1), q.max(-1).values, 0.0)


@torch.no_grad()
def action_values(net, tables, boards: torch.Tensor, depth: int = 2, block: int = BLOCK) -> torch.Tensor:
    """``Q [N, 4]`` of boards ``[N, 4, 4]`` in float32, ``-inf`` for illegal
    moves. ``tables`` are ``net``'s tables in order; a table stored in
    another type is read as float32 (the control's bfloat16)."""
    tables = [t.float() for t in tables]
    return torch.cat([_q(net, tables, b, depth)[0] for b in boards.split(block)])


def _count(boards: torch.Tensor, depth: int) -> int:
    if boards.shape[0] == 0:
        return 0
    after, _, legal = engine.all_moves(boards)
    if depth == 0:
        return int(legal.sum())
    kids, probs = children(after[legal])
    return _count(kids[probs > 0], depth - 1)


@torch.no_grad()
def needed_leaves(boards: torch.Tensor, depth: int = 2, block: int = BLOCK) -> int:
    """How many leaf values the boards' trees need: the legal afterstates of
    the max nodes ``depth`` chance levels down."""
    return sum(_count(b, depth) for b in boards.split(block))
