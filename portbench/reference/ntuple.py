"""Afterstate TD(0) learning of an n-tuple network in plain PyTorch.

After Szubert & Jaskowski (CIG 2014) and Yeh et al. (TCIAIG 2017): a
board's value is the sum of one table entry per (tuple, board symmetry),
each entry indexed by the tuple's cells' exponents in base 16. The games
act greedily on ``reward + V(afterstate)``; each step backs the previous
afterstate up toward ``r + V(afterstate')`` and, where the spawn ended the
game, the chosen afterstate toward 0. The "delayed" update (Jaskowski,
TCIAIG 2018) gathers a window's backups with the tables frozen, then moves
each touched entry with ``h`` nonzero hits of mean error ``m`` by
``(1 - (1 - s)**h) * m / L`` (``L`` lookups per board), where temporal
coherence gives ``s = clamp(alpha * |E| / A, 0, 1)`` (1 while ``A`` is 0)
and then adds the window's error sum to ``E`` and its absolute sum to
``A``.

With ``follow`` (each step's boards and actions from another side) the
learner takes those actions, counts the boards that differ from its own
game, and reads the widest gap, relative to ``max(1, |best|)``, by which a
followed action's value lies below the best legal one. ``bf16`` stores the
tables and accumulators in bfloat16 (the control).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import engine


def symmetries() -> np.ndarray:
    """The eight rotations and reflections of the 4x4 grid as cell maps."""
    grid = np.arange(16).reshape(4, 4)
    maps = []
    for g in (grid, grid.T):
        for k in range(4):
            maps.append(np.rot90(g, k).reshape(-1))
    return np.stack(maps)


class Network:
    def __init__(self, tuples, device):
        syms = symmetries()
        self.sizes = [16 ** len(t) for t in tuples]
        self.cells = [torch.as_tensor(syms[:, list(t)], device=device) for t in tuples]  # [8, k]
        self.powers = [16 ** torch.arange(len(t), device=device) for t in tuples]
        self.lookups = 8 * len(tuples)

    def index(self, boards: torch.Tensor):
        flat = boards.reshape(-1, 16).long()
        return [(flat[:, c] * p).sum(-1) for c, p in zip(self.cells, self.powers)]  # [N, 8] each

    def value(self, tables, boards: torch.Tensor) -> torch.Tensor:
        shape = boards.shape[:-2]
        total = torch.zeros(boards.reshape(-1, 16).shape[0], dtype=torch.float32, device=boards.device)
        for t, idx in zip(tables, self.index(boards)):
            total = total + t[idx].float().sum(-1)
        return total.reshape(shape)


@dataclasses.dataclass
class Learner:
    net: Network
    tables: list  # per table [t, E, A]
    games: engine.Games
    prev_after: torch.Tensor
    prev_valid: torch.Tensor


def new_learner(tuples, seed: int, batch: int, device, bf16: bool = False) -> Learner:
    net = Network(tuples, device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    tables = [[torch.zeros(n, dtype=dtype, device=device) for _ in range(3)] for n in net.sizes]
    games = engine.new_games(seed, batch, device)
    return Learner(net, tables, games, torch.zeros_like(games.boards), torch.zeros(batch, device=device))


def apply_window(lr: Learner, boards: torch.Tensor, err: torch.Tensor, alpha: float) -> None:
    for (t, e_acc, a_acc), idx in zip(lr.tables, lr.net.index(boards)):
        ids = idx.reshape(-1)
        d = err[:, None].expand(idx.shape).reshape(-1)
        n = t.shape[0]
        err_sum = torch.zeros(n, device=d.device).index_add_(0, ids, d)
        abs_sum = torch.zeros(n, device=d.device).index_add_(0, ids, d.abs())
        hits = torch.zeros(n, device=d.device).index_add_(0, ids, (d != 0).float())
        e32, a32 = e_acc.float(), a_acc.float()
        rate = torch.where(a32 > 0, e32.abs() / a32.clamp(min=1e-30), 1.0)
        s = (alpha * rate).clamp(0.0, 1.0)
        gain = 1.0 - torch.pow(1.0 - s, hits)
        t.copy_((t.float() + gain / lr.net.lookups * (err_sum / hits.clamp(min=1.0))).to(t.dtype))
        e_acc.copy_((e32 + err_sum).to(e_acc.dtype))
        a_acc.copy_((a32 + abs_sum).to(a_acc.dtype))


@torch.no_grad()
def update(lr: Learner, steps: int, window: int, alpha: float, follow=None) -> dict:
    """``steps`` steps in windows of ``window``; readings."""
    B = lr.games.boards.shape[0]
    rows = torch.arange(B, device=lr.games.boards.device)
    differ, gap, td_abs, td_n = 0, 0.0, 0.0, 0.0
    trace = {"boards": [], "actions": []}
    for w in range(steps // window):
        ub, ue = [], []
        for s in range(window):
            boards = lr.games.boards
            after, reward, legal = engine.all_moves(boards)
            tables = [tab[0] for tab in lr.tables]
            v_after = lr.net.value(tables, after)
            q = torch.where(legal, reward + v_after, -torch.inf)
            if follow is None:
                a = q.argmax(-1)
            else:
                k = w * window + s
                differ += int((follow["boards"][k] != boards).flatten(1).any(-1).sum())
                a = follow["actions"][k].long()
                best = q.max(-1).values
                g = (best - q[rows, a]) / best.abs().clamp(min=1.0)
                gap = max(gap, float(g.max()))
            trace["boards"].append(boards)
            trace["actions"].append(a)
            chosen = after[rows, a]
            err_prev = (reward[rows, a] + v_after[rows, a] - lr.net.value(tables, lr.prev_after)) * lr.prev_valid
            td_abs += float(err_prev.abs().sum())
            td_n += float(lr.prev_valid.sum())
            lr.games, _, done, _ = engine.step(lr.games, a)
            err_term = -v_after[rows, a] * done.float()
            ub += [lr.prev_after, chosen]
            ue += [err_prev, err_term]
            lr.prev_after, lr.prev_valid = chosen, 1.0 - done.float()
        apply_window(lr, torch.cat(ub), torch.cat(ue), alpha)
    return {"td_abs_err": td_abs / max(td_n, 1.0), "boards_differ": differ, "action_gap": gap,
            "boards": trace["boards"], "actions": trace["actions"]}


def leaf_norms(lr: Learner) -> dict:
    out = {}
    for i, tab in enumerate(lr.tables):
        for name, x in zip(("", "_E", "_A"), tab):
            out[f"t{i}{name}"] = float(torch.linalg.vector_norm(x.float()))
    return out
