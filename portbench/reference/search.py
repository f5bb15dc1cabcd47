"""Depth-1 expectimax over a value tower, in plain PyTorch.

``Q(s, a) = f(r(s, a)) + gamma * E_spawn[max_a' (f(r') + gamma * V(after'))]``
over the legal moves ``a`` of ``s``: the expectation runs over every blank
cell of the afterstate and both spawned tiles (2 with probability 0.9, 4
with 0.1), a child with no legal move is worth 0, and ``V`` is the tower's
value of the child's afterstate ``after'``. Only the leaves a legal
afterstate's blank-cell children reach through a legal move are evaluated.
"""

from __future__ import annotations

import torch

from portbench.reference import engine, resnet


def children(after: torch.Tensor):
    """Spawn outcomes of afterstates ``[M, 4, 4]``: ``[M, 32, 4, 4]`` boards
    and probabilities ``[M, 32]`` (0 where the cell is taken)."""
    flat = after.reshape(-1, 16)
    blank = (flat == 0).float()
    p = blank / blank.sum(-1, keepdim=True).clamp(min=1.0)
    eye = torch.eye(16, dtype=after.dtype, device=after.device)
    kids = torch.cat([flat[:, None] + eye, flat[:, None] + 2 * eye], dim=1)
    return kids.reshape(-1, 32, 4, 4), torch.cat([0.9 * p, 0.1 * p], dim=-1)


def leaves(boards: torch.Tensor):
    """Everything the tree needs of boards ``[N, 4, 4]``."""
    n = boards.shape[0]
    after, score, legal = engine.all_moves(boards)  # [N, 4, ...]
    kids, probs = children(after.reshape(-1, 4, 4))  # [4N, 32, ...]
    kids, probs = kids.reshape(n, 4, 32, 4, 4), probs.reshape(n, 4, 32)
    live = legal[:, :, None] & (probs > 0)
    k_after, k_score, k_legal = engine.all_moves(kids.reshape(-1, 4, 4))
    k_after = k_after.reshape(n, 4, 32, 4, 4, 4)
    need = live[..., None] & k_legal.reshape(n, 4, 32, 4)
    return {"score": score, "legal": legal, "probs": probs, "k_after": k_after, "k_score": k_score.reshape(n, 4, 32, 4),
            "need": need}


def needed_leaves(boards: torch.Tensor) -> int:
    """How many leaf values the boards' trees need."""
    return int(leaves(boards)["need"].sum())


def action_values(params: dict, spec: dict, boards: torch.Tensor, gamma: float, quant=None) -> torch.Tensor:
    """``Q [N, 4]``, ``-inf`` for illegal moves."""
    t = leaves(boards)
    need = t["need"]
    v = torch.zeros(need.shape, dtype=torch.float32, device=boards.device)
    with torch.no_grad(), resnet.exact_float32():
        if bool(need.any()):
            v[need] = resnet.forward_blocks(params, t["k_after"][need], spec, quant)[1]
    kid_q = torch.where(need, engine.log2_reward(t["k_score"]) + gamma * v, -torch.inf)
    kid_v = torch.where(need.any(-1), kid_q.max(-1).values, 0.0)
    expect = (t["probs"] * kid_v).sum(-1)
    q = engine.log2_reward(t["score"]) + gamma * expect
    return torch.where(t["legal"], q, -torch.inf)


def gaps(q: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """How far each chosen action's value lies below the best, relative to
    ``max(1, |best|)``; 0 for a board with no legal move."""
    best = q.max(-1).values
    chosen = q.gather(1, actions[:, None].long())[:, 0]
    dead = torch.isinf(best)
    return torch.where(dead, 0.0, (best - chosen) / best.abs().clamp(min=1.0))
