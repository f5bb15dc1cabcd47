"""One PPO update of the port per unit: ``PPOStep.rollout`` then
``PPOStep.learn`` (what ``PPOStep.__call__`` runs), from ``init_ppo`` and
``make_ppo_step`` at the traffic's ``PPOConfig``.

The benchmark draws the tower's weights on the device from the seed and
loads them into the port's model; the port's env and learner streams take
the same seed. Set-up drives the first ``CHECK_UPDATES`` updates through
the window's own call and keeps what they produced: each update's boards,
actions and loss, and every leaf's change after the last. Through
read-only hooks on the model (:class:`Tap`) it also keeps, from the first
update, the boards of every forward that learns (the minibatches as the
loss saw them), the rows whose outputs no gradient reached, and each
leaf's first gradient as autograd hands it to the optimizer. The check
replays those updates in float32 (``reference/ppo.py``) along the port's
actions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics

import torch

from portbench.reference import ppo as ref_ppo
from portbench.reference import resnet as ref_resnet

CHECK_UPDATES = 3
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cell):
    from rein48_tpu_torch.engine.core import RewardMode
    from rein48_tpu_torch.train.ppo import PPOConfig

    model = cell.config
    kwargs = dict(cell.traffic["ppo"])
    kwargs["reward_mode"] = RewardMode(kwargs["reward_mode"])
    kwargs["model_kwargs"] = (
        ("channels", model["channels"]), ("num_blocks", model["num_blocks"]), ("dtype", DTYPES[model["dtype"]]),
    )
    kwargs["model"] = model["model"]
    kwargs["obs_encoding"] = model["obs_encoding"]
    return PPOConfig(**kwargs)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gap(side: dict, ref: dict, keep=None) -> float:
    """Worst leaf of ``|side norm - ref norm| / max(ref norm, median ref norm)``."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(side.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in names)


def rows_differ(side: list, ref: list) -> int:
    """Minibatch rows whose board differs, in order, counting each row that
    one side has and the other lacks."""
    n = 0
    for i in range(max(len(side), len(ref))):
        a = side[i] if i < len(side) else side[0][:0]
        b = ref[i] if i < len(ref) else ref[0][:0]
        m = min(len(a), len(b))
        n += int((a[:m].to(b.device) != b[:m]).flatten(1).any(-1).sum()) + abs(len(a) - len(b))
    return n


def judge(side: dict, w0: dict, cell, seed: int, device) -> dict:
    """Replay ``side``'s updates in float32 and read the numbers compared."""
    cfg = cell.traffic["ppo"]
    implemented = {"reward_mode": "merge_score", "reward_transform": "log2", "use_legal_mask": True, "clip_value": False,
                   "normalize_advantage": True, "optimizer": "adam", "shard_friendly_perm": True, "afterstate_critic": False}
    if any(cfg[k] != v for k, v in implemented.items()) or cell.config["obs_encoding"] != "onehot":
        raise NotImplementedError(f"the reference implements PPO with {implemented} on one-hot planes")
    lr = ref_ppo.new_learner(w0, seed, cfg["batch_size"], device)
    differ, gap = 0, 0.0
    for u, rec in enumerate(side["updates"]):
        out = ref_ppo.update(lr, cfg, seed, cell.config, follow=rec)
        differ += out["boards_differ"]
        gap = max(gap, out["action_gap"])
        if u == 0:
            loss_gap = abs(rec["loss"] - out["loss"]) / max(abs(out["loss"]), 1e-30)
    change = {k: float(torch.linalg.vector_norm(lr.params[k] - w0[k].float())) for k in w0}
    first = norms(lr.first_grad)
    # Leaves whose gradient is nought to rounding move by round-off alone.
    med = statistics.median(first.values())
    moving = {k for k, v in first.items() if v >= 1e-3 * med}
    return {
        "boards_differ": differ,
        "action_gap": gap,
        # Later updates' losses part by chaos, not by precision (PERF.md).
        "update1_loss_gap": loss_gap,
        "change_gap": leaf_gap(side["change"], change, moving),
        "first_grad_gap": leaf_gap(side["first_grad"], first),
        "minibatch_rows_differ": rows_differ(side["minibatches"], lr.first_minibatches),
        "unused_rows_gap": abs(side["unused"] - lr.first_unused),
    }


class Tap:
    """Read-only hooks on the port's model, for one update: the boards of
    each forward that learns (decoded from its one-hot planes), the rows of
    those forwards whose outputs no gradient reaches, and each parameter's
    first gradient. Nothing the program computes changes."""

    def __init__(self, model: torch.nn.Module):
        self.minibatches, self.used, self.first_grad = [], [], {}
        self.handles = [model.register_forward_hook(self._forward)]
        for name, p in model.named_parameters():
            self.handles.append(p.register_hook(self._grad(name)))

    def _forward(self, module, args, out):
        logits, value = out
        if not (logits.requires_grad or value.requires_grad):
            return
        self.minibatches.append(args[0].argmax(-1).to(torch.uint8))
        used = torch.zeros(value.shape[0], dtype=torch.bool, device=value.device)
        self.used.append(used)

        def mark(g):
            used.logical_or_((g != 0).reshape(used.shape[0], -1).any(-1))

        for t in (logits, value):
            if t.requires_grad:
                t.register_hook(mark)

    def _grad(self, name):
        def keep(g):
            if name not in self.first_grad:
                self.first_grad[name] = g.detach().clone()

        return keep

    def close(self) -> dict:
        for h in self.handles:
            h.remove()
        return {"minibatches": self.minibatches, "unused": int(sum(int((~u).sum()) for u in self.used)),
                "first_grad": norms(self.first_grad)}


class Run:
    def __init__(self, ctx):
        from rein48_tpu_torch.train import ppo as port

        self.ctx = ctx
        cell, dev = ctx.cell, ctx.device
        self.config = port_config(cell)
        self.w0 = ref_resnet.make_params(cell.config, ctx.seed, dev)
        state, model, optimizer = port.init_ppo(self.config, ctx.seed, dev)
        # Loading checks every shape the configuration states.
        model.load_state_dict(self.w0)
        if any(p.dtype != DTYPES[cell.config["param_dtype"]] for p in model.parameters()):
            raise ValueError(f"the port's parameters are not {cell.config['param_dtype']}")
        self.step = port.make_ppo_step(self.config, model, optimizer)
        self.model, self.optimizer, self.state = model, optimizer, state
        self.side = {"updates": []}
        for u in range(CHECK_UPDATES):
            tap = Tap(model) if u == 0 else None
            batch, metrics = self._update(None)
            if tap is not None:
                self.side.update(tap.close())
            self.side["updates"].append(
                {"boards": batch["boards"], "actions": batch["actions"], "loss": metrics["loss"]}
            )
        self.side["change"] = {
            k: float(torch.linalg.vector_norm(p.detach() - self.w0[k])) for k, p in model.named_parameters()
        }
        for rec in self.side["updates"]:
            rec["loss"] = float(rec["loss"])
        self.trace_units = 2

    def _update(self, spans):
        def span(name):
            return spans.span(name) if spans is not None else contextlib.nullcontext()

        with span("rollout"):
            env, batch, _ = self.step.rollout(self.state)
        with span("learn"):
            metrics = self.step.learn(self.state, batch)
        self.state = dataclasses.replace(self.state, env=env, update_step=self.state.update_step + 1)
        return batch, metrics

    def unit(self, spans) -> None:
        self._update(spans)

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        del self.step, self.model, self.optimizer, self.state

    def check(self) -> dict:
        return judge(self.side, self.w0, self.ctx.cell, self.ctx.seed, self.ctx.device)


def setup(ctx) -> Run:
    return Run(ctx)


def tiny(cell):
    """The cell at a CPU test's size: few games, steps and minibatches, a
    narrow tower."""
    cell.traffic["ppo"].update(batch_size=8, unroll_len=4, num_minibatches=2)
    cell.config.update(channels=8, num_blocks=1, head_hidden=8)
    return cell
