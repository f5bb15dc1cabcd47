"""One lockstep move of the port's n-tuple expectimax player per unit: the
policy that ``train.ntuple._get_ntuple_policy`` returns (what ``eval --algo
ntuple --depth 2 --chance-chunk 8`` serves), under ``torch.no_grad()`` as
``evaluate_ntuple`` serves it, then the engine's auto-reset step, for every
game.

The network is the configuration's (Yeh et al.'s four 6-tuples under the 8
symmetries: 4 float32 tables of 16^6 entries). Play reads the tables
``t0..t3`` alone, no temporal-coherence accumulators. They are drawn on the
device from the seed in one call, normal of the traffic's standard
deviation in score units (1: the player is close to a depth-2 score
maximiser and reaches mid-game boards, as a trained one does). The games
start from the seed and restart when they end, so the batch stays full.
Each move waits for the one before (a closed loop). On the card the
player replays a CUDA graph of its move from its second call on, as
``eval`` serves it; the traced segments, with the program's spans on, run
it op by op.

The cell measures the leaf as one launch of the value kernel of
``csrc/ntuple_value.cu`` per leaf call: set-up stops, before the window,
a program whose first move launches it otherwise (one whose leaf
composes the value from gathers cannot run the cell).

Every move's boards and actions are kept. The check steps the games again
along the port's actions and compares every board, and judges the actions
of a sample of the window's moves, drawn from the seed, against float32
depth-2 expectimax (``reference/search_ntuple.py``): the widest gap by which
the port's action lies below the reference's best, relative to
``max(1, |best|)``. ``counters()`` gives ``leaves_needed``, the leaf values
the window's trees needed: counted by the reference on ``counted_moves``
window moves drawn from the seed, and scaled to the window's moves. The
check prints the window's distribution of each board's largest tile on
standard error: the spread of the table indices, which sets how many of the
value's gathers the L2 serves.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from portbench.drivers.search_move import sample_moves
from portbench.reference import engine as ref_engine
from portbench.reference import ntuple as ref_ntuple
from portbench.reference import search as ref_search
from portbench.reference import search_ntuple as ref


def make_tables(cell, seed: int, device) -> list:
    """The tables ``t0..`` in order, float32, drawn on ``device`` in one call."""
    c, draw = cell.config, cell.traffic["tables"]
    if c["table_dtype"] != "float32" or draw["draw"] != "normal":
        raise ValueError("the benchmark draws float32 tables from a normal distribution")
    sizes = [16 ** len(t) for t in c["tuples"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(float(draw["std"]))
    return list(flat.split(sizes))


def build_policy(cell, device):
    from rein48_tpu_torch.train import ntuple as port

    c, t = cell.config, cell.traffic
    config = port.NTupleTrainConfig(
        tuples=tuple(tuple(x) for x in c["tuples"]),
        symmetric=c["symmetric"],
        optimistic_init=c["optimistic_init"],
        table_backend=c["table_backend"],
        cache_prefix_rows=c["cache_prefix_rows"],
    ).network_config(device)
    if config.backend == "cached":
        raise ValueError("the benchmark's tables are logical: no row maps")
    return port._get_ntuple_policy(config, t["depth"], t["chance_chunk"])


def judge(side: dict, tables: list, cell, seed: int, device, control=None) -> dict:
    """Step the games along ``side``'s actions and judge a sample of moves.

    With ``control`` (a table type) the actions judged are those that the
    reference puts first with its tables stored in that type, on the same
    boards."""
    t, c = cell.traffic, cell.config
    games = ref_engine.new_games(seed, t["games"], device)
    differ = 0
    for boards, actions in zip(side["boards"], side["actions"]):
        differ += int((boards != games.boards).flatten(1).any(-1).sum())
        games = ref_engine.step(games, actions.long())[0]
    differ += int((side["final"] != games.boards).flatten(1).any(-1).sum())
    net = ref_ntuple.Network(c["tuples"], device)
    gap = 0.0
    for i in sample_moves(side["first_timed"], len(side["boards"]), cell.workload["checked_moves"], seed):
        boards = side["boards"][i]
        q = ref.action_values(net, tables, boards, t["depth"])
        actions = side["actions"][i]
        if control is not None:
            actions = ref.action_values(net, [x.to(control) for x in tables], boards, t["depth"]).argmax(-1)
        gap = max(gap, float(ref_search.gaps(q, actions).max()))
    return {"boards_differ": differ, "action_gap": gap}


def leaf_calls(traffic) -> int:
    """Leaf calls a move: one per chance chunk of each chance level."""
    chunk = traffic["chance_chunk"] or 32
    return (32 // chunk) ** traffic["depth"]


def fused_leaf(launched: int, traffic) -> None:
    """Stop the run unless the move launched the value kernel of
    ``csrc/ntuple_value.cu`` once per leaf call: the cell measures that
    leaf (``ntuple_value_roofline.search`` reads its kernel), and a program
    that composes the value from gathers cannot run it."""
    want = leaf_calls(traffic)
    if launched != want:
        raise SystemExit(f"search_ntuple: a move launched the n-tuple value kernel {launched} times, not once "
                         f"for each of its {want} leaf calls: this program cannot run the cell")


def max_tiles(boards: list) -> dict:
    """Boards of a list of moves by the exponent of their largest tile."""
    if not boards:
        return {}
    top = torch.stack([b.flatten(1).amax(1) for b in boards]).flatten().long()
    return {e: n for e, n in enumerate(torch.bincount(top, minlength=16).tolist()) if n}


class Run:
    def __init__(self, ctx):
        from rein48_tpu_torch.engine import vector

        self.ctx, self.vector = ctx, vector
        cell, dev, t = ctx.cell, ctx.device, ctx.cell.traffic
        self.tables = make_tables(cell, ctx.seed, dev)
        self.params = {f"t{i}": x for i, x in enumerate(self.tables)}
        self.policy = build_policy(cell, dev)
        self.env = vector.reset_batch(ctx.seed, t["games"], dev)
        self.side = {"boards": [], "actions": []}
        for i in range(cell.workload["warmup_moves"]):
            launched = self.launches()
            self.unit(None)
            if i == 0 and dev.type == "cuda":
                fused_leaf(self.launches() - launched, t)
        self.side["first_timed"] = len(self.side["boards"])
        self.trace_units = cell.workload["traced_moves"]

    @staticmethod
    def launches() -> int:
        from rein48_tpu_torch.utils import profiling

        return profiling.counters.get("ntuple_value.launches", 0)

    def unit(self, spans) -> None:
        ctx = spans.span("policy") if spans is not None else contextlib.nullcontext()
        boards = self.env.boards
        with ctx, torch.no_grad():
            actions = self.policy(self.params, boards)
        self.env, _ = self.vector.step_autoreset(self.env, actions)
        self.side["boards"].append(boards)
        self.side["actions"].append(actions)

    def counters(self) -> dict:
        """Leaf values the window's trees needed: the mean over a seeded
        sample of ``counted_moves`` window moves, times the window's moves."""
        first, units = self.side["first_timed"], self.ctx.window["units"]
        picks = sample_moves(first, first + units, self.ctx.cell.workload["counted_moves"], self.ctx.seed + 1)
        depth = self.ctx.cell.traffic["depth"]
        counted = [ref.needed_leaves(self.side["boards"][i], depth) for i in picks]
        return {"leaves_needed": sum(counted) / len(counted) * units}

    def release(self) -> None:
        self.side["final"] = self.env.boards
        del self.policy, self.env, self.params

    def check(self) -> dict:
        first = self.side["first_timed"]
        window = self.side["boards"][first:first + self.ctx.window.get("units", 0)]
        print(f"portbench: window boards by largest tile exponent {max_tiles(window)}", file=sys.stderr)
        return judge(self.side, self.tables, self.ctx.cell, self.ctx.seed, self.ctx.device)


def setup(ctx) -> Run:
    return Run(ctx)


def tiny(cell):
    """The cell at a CPU test's size: two games, few moves, two small tuples."""
    cell.traffic.update(games=2)
    cell.workload.update(warmup_moves=2, traced_moves=2, checked_moves=3, counted_moves=2)
    cell.config.update(tuples=[[0, 1, 2], [0, 4, 8]])
    return cell
