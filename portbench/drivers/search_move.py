"""One lockstep move of the port's depth-1 expectimax player per unit: the
policy that ``train.evaluate._build_search_policy`` returns (what ``eval
--algo search`` serves), then the engine's auto-reset step, for every game.

The leaf is a ResNet built as the afterstate-TD trainer builds it, with
weights the benchmark draws on the device from the seed; the games start
from the seed and restart when they end, so the batch stays full. Each move
waits for the one before (a closed loop). Every move's boards and actions
are kept; the check steps the games again along the port's actions and
compares every board, and judges the actions of a sample of the window's
moves, drawn from the seed, against float32 expectimax
(``reference/search.py``).
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference import engine as ref_engine
from portbench.reference import resnet as ref_resnet
from portbench.reference import search as ref_search

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_policy(cell, weights, device):
    from rein48_tpu_torch.train.afterstate import AfterstateTDConfig
    from rein48_tpu_torch.train.evaluate import _build_search_policy

    c, t = cell.config, cell.traffic
    kwargs = (("channels", c["channels"]), ("num_blocks", c["num_blocks"]), ("dtype", DTYPES[c["dtype"]]))
    model = AfterstateTDConfig(model=c["model"], model_kwargs=kwargs, obs_encoding=c["obs_encoding"]).make_model()
    # Loading checks every shape the configuration states.
    model.load_state_dict(weights)
    if any(p.dtype != DTYPES[c["param_dtype"]] for p in model.parameters()):
        raise ValueError(f"the port's parameters are not {c['param_dtype']}")
    model = model.to(device)
    policy = _build_search_policy(t["depth"], model, c["obs_encoding"], t["gamma"], t["reward_transform"], t["chance_chunk"])
    return model, policy


def sample_moves(first: int, last: int, count: int, seed: int) -> list:
    """``count`` distinct moves of ``first..last-1`` drawn from the seed, and the last."""
    gen = torch.Generator().manual_seed(seed)
    picks = torch.randperm(last - first, generator=gen)[: max(count - 1, 0)] + first
    return sorted(set(picks.tolist()) | {last - 1})


def judge(side: dict, weights: dict, cell, seed: int, device, control=None) -> dict:
    """Step the games along ``side``'s actions and judge a sample of moves.

    With ``control`` (a rounding applied inside the tower) the actions
    judged are those the control's expectimax puts first on the same boards."""
    t, spec = cell.traffic, cell.config
    games = ref_engine.new_games(seed, t["games"], device)
    differ = 0
    for boards, actions in zip(side["boards"], side["actions"]):
        differ += int((boards != games.boards).flatten(1).any(-1).sum())
        games = ref_engine.step(games, actions.long())[0]
    differ += int((side["final"] != games.boards).flatten(1).any(-1).sum())
    w = {k: v.float() for k, v in weights.items()}
    gap = 0.0
    for i in sample_moves(side["first_timed"], len(side["boards"]), cell.workload["checked_moves"], seed):
        boards = side["boards"][i]
        q = ref_search.action_values(w, spec, boards, t["gamma"])
        actions = side["actions"][i]
        if control is not None:
            qc = ref_search.action_values(w, spec, boards, t["gamma"], quant=control)
            actions = qc.argmax(-1)
        gap = max(gap, float(ref_search.gaps(q, actions).max()))
    return {"boards_differ": differ, "action_gap": gap}


class Run:
    def __init__(self, ctx):
        from rein48_tpu_torch.engine import vector

        self.ctx, self.vector = ctx, vector
        cell, dev, t = ctx.cell, ctx.device, ctx.cell.traffic
        self.weights = ref_resnet.make_params(cell.config, ctx.seed, dev)
        self.model, self.policy = build_policy(cell, self.weights, dev)
        self.env = vector.reset_batch(ctx.seed, t["games"], dev)
        self.side = {"boards": [], "actions": []}
        for _ in range(cell.workload["warmup_moves"]):
            self.unit(None)
        self.side["first_timed"] = len(self.side["boards"])
        self.trace_units = cell.workload["traced_moves"]

    def unit(self, spans) -> None:
        ctx = spans.span("policy") if spans is not None else contextlib.nullcontext()
        boards = self.env.boards
        with ctx:
            actions = self.policy(boards)
        self.env, _ = self.vector.step_autoreset(self.env, actions)
        self.side["boards"].append(boards)
        self.side["actions"].append(actions)

    def counters(self) -> dict:
        """Leaf values the timed moves' trees needed, counted from their boards."""
        timed = self.side["boards"][self.side["first_timed"]: self.side["first_timed"] + self.ctx.window["units"]]
        return {"leaves_needed": sum(ref_search.needed_leaves(b) for b in timed)}

    def release(self) -> None:
        self.side["final"] = self.env.boards
        del self.model, self.policy, self.env

    def check(self) -> dict:
        return judge(self.side, self.weights, self.ctx.cell, self.ctx.seed, self.ctx.device)


def setup(ctx) -> Run:
    return Run(ctx)


def tiny(cell):
    """The cell at a CPU test's size: few games and moves, a narrow tower."""
    cell.traffic.update(games=4)
    cell.workload.update(warmup_moves=2, traced_moves=2, checked_moves=3)
    cell.config.update(channels=8, num_blocks=1, head_hidden=8)
    return cell
