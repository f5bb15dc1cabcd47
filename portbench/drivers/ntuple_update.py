"""One update of the port's n-tuple TD trainer per unit: the step that
``make_ntuple_step`` builds, from ``init_ntuple``, at the configuration's
tables and the traffic's batch and windows.

The tables start as the configuration states (constant ``optimistic_init``)
and the games from the seed. Set-up drives the first ``CHECK_UPDATES``
updates through the window's own call and keeps what they produced: every
step's boards and actions (read where the trainer hands them to the
engine), each update's ``td_abs_err``, and the norm of every table and TC
accumulator after the first update and after the last. The check replays
those steps in plain PyTorch (``reference/ntuple.py``) along the port's
actions.
"""

from __future__ import annotations

import statistics
import sys

import torch

from portbench.reference import ntuple as ref_ntuple

CHECK_UPDATES = 3


def port_config(cell):
    from rein48_tpu_torch.train.ntuple import NTupleTrainConfig

    c, t = cell.config, cell.traffic
    return NTupleTrainConfig(
        batch_size=t["batch_size"],
        steps_per_update=t["steps_per_update"],
        tuples=tuple(tuple(x) for x in c["tuples"]),
        symmetric=c["symmetric"],
        alpha=c["alpha"],
        optimistic_init=c["optimistic_init"],
        collision=t["collision"],
        tc=c["tc"],
        update_mode=t["update_mode"],
        delay_window=t["delay_window"],
        table_backend=c["table_backend"],
        cache_prefix_rows=c["cache_prefix_rows"],
        cache_refresh_every=c["cache_refresh_every"],
    )


def leaf_gap(side: dict, ref: dict) -> float:
    med = statistics.median(ref.values())
    return max(abs(side[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def judge(side: dict, cell, seed: int, device) -> dict:
    """Replay ``side``'s steps in float32 and read the numbers compared."""
    t, c = cell.traffic, cell.config
    if not (c["tc"] and c["symmetric"] and t["update_mode"] == "delayed" and c["optimistic_init"] == 0.0):
        raise NotImplementedError("the reference implements symmetric delayed TC updates from zero tables")
    lr = ref_ntuple.new_learner(c["tuples"], seed, t["batch_size"], device)
    differ, gap, td_gap, first = 0, 0.0, 0.0, None
    for u, rec in enumerate(side["updates"]):
        out = ref_ntuple.update(lr, t["steps_per_update"], t["delay_window"], c["alpha"], follow=rec)
        differ += out["boards_differ"]
        gap = max(gap, out["action_gap"])
        td_gap = max(td_gap, abs(rec["td_abs_err"] - out["td_abs_err"]) / max(out["td_abs_err"], 1e-30))
        if u == 0:
            first = ref_ntuple.leaf_norms(lr)
    return {
        "boards_differ": differ,
        "action_gap": gap,
        "td_gap": td_gap,
        "first_tables_gap": leaf_gap(side["first"], first),
        "tables_gap": leaf_gap(side["last"], ref_ntuple.leaf_norms(lr)),
    }


class Recorder:
    """Wraps the engine step the trainer calls, keeping each step's boards
    and actions; the wrapped call is unchanged."""

    def __init__(self, vector):
        self.vector, self.inner = vector, vector.step_autoreset
        self.boards, self.actions = [], []

    def __call__(self, env, actions, *args, **kwargs):
        self.boards.append(env.boards)
        self.actions.append(actions)
        return self.inner(env, actions, *args, **kwargs)

    def __enter__(self):
        self.vector.step_autoreset = self
        return self

    def __exit__(self, *exc):
        self.vector.step_autoreset = self.inner


def norms(params: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in params.items() if not k.endswith(("_rm", "_hot"))}


class Run:
    def __init__(self, ctx):
        from rein48_tpu_torch.engine import vector
        from rein48_tpu_torch.train import ntuple as port

        self.ctx = ctx
        self.config = port_config(ctx.cell)
        self.state, net = port.init_ntuple(self.config, ctx.seed, ctx.device)
        print(f"portbench: table backend {net.config.backend!r}", file=sys.stderr)
        self.step = port.make_ntuple_step(self.config, ctx.device)
        self.side = {"updates": []}
        steps = self.config.steps_per_update
        for u in range(CHECK_UPDATES):
            with Recorder(vector) as rec:
                self.state, metrics = self.step(self.state)
            self.side["updates"].append(
                {"boards": rec.boards[:steps], "actions": rec.actions[:steps], "td_abs_err": metrics["td_abs_err"]}
            )
            if u == 0:
                self.side["first"] = norms(self.state.params)
        self.side["last"] = norms(self.state.params)
        for rec in self.side["updates"]:
            rec["td_abs_err"] = float(rec["td_abs_err"])
        self.trace_units = 1

    def unit(self, spans) -> None:
        self.state, _ = self.step(self.state)

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        del self.state, self.step

    def check(self) -> dict:
        return judge(self.side, self.ctx.cell, self.ctx.seed, self.ctx.device)


def setup(ctx) -> Run:
    return Run(ctx)


def tiny(cell):
    """The cell at a CPU test's size: few games and steps, two small tuples."""
    cell.traffic.update(batch_size=8, steps_per_update=8)
    cell.config.update(tuples=[[0, 1, 2], [0, 4, 8]])
    return cell
