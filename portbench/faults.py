"""Faults planted in the port underneath a run, to show that the check
catches them (``tests/test_portbench_faults.py``) and to read them on the
card at a cell's size (``calibrate.py``).

Each fault patches one function of the port for the length of a ``with``
block: the timed path is broken, nothing of the benchmark is. Per driver:

* ``unchanged``: the step returns its state unchanged (the optimizer or
  the table update does nothing; the engine returns the same games);
* ``half``: half of the batch is left out and the mean taken over the rest;
* ``altered``: a quarter of the games' actions are altered where they are
  produced.

The PPO update can leave half of its batch out in more places, each its own
fault: ``half_minibatches`` (the minibatches cut to half their rows),
``repeated`` (each minibatch's second half a copy of its first),
``unshuffled`` (the epochs' shuffles left out) and ``half_masked`` (the
tower sees every row, the loss's means only half of them).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {
    "ppo_update": ("unchanged", "half", "half_minibatches", "repeated", "unshuffled", "half_masked", "altered"),
    "ntuple_update": ("unchanged", "half", "altered"),
    "search_move": ("unchanged", "half", "altered"),
}


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _quarter(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) % 4 == 0


def ppo_update(fault: str):
    from rein48_tpu_torch.agents import ppo as agent
    from rein48_tpu_torch.train import a3c, common, ppo

    if fault == "unchanged":
        return _patch(common.Optimizer, "step", lambda self, grads: None)
    if fault == "half":
        inner = ppo.PPOStep.minibatch_loss

        def half(self, mb, loss_cfg):
            n = mb["returns"].shape[0]
            return inner(self, {k: v[: n // 2] for k, v in mb.items()}, loss_cfg)

        return _patch(ppo.PPOStep, "minibatch_loss", half)
    if fault in ("half_minibatches", "repeated"):
        inner_mbs = ppo.PPOStep.minibatches

        def cut(self, batch, perm):
            out = {}
            for k, v in inner_mbs(self, batch, perm).items():
                h = v[:, : v.shape[1] // 2]
                out[k] = h if fault == "half_minibatches" else torch.cat([h, h], 1)
            return out

        return _patch(ppo.PPOStep, "minibatches", cut)
    if fault == "unshuffled":
        inner_perms = ppo.PPOStep.permutations

        def unshuffled(self, state, device):
            p = inner_perms(self, state, device)
            return torch.arange(p.shape[1], device=p.device).reshape(1, -1, 1).expand_as(p)

        return _patch(ppo.PPOStep, "permutations", unshuffled)
    if fault == "half_masked":
        inner_loss = agent.ppo_loss

        def masked(*args):
            n = args[0].shape[0] // 2
            return inner_loss(*(a[:n] if torch.is_tensor(a) else a for a in args))

        return _patch(agent, "ppo_loss", masked)
    if fault == "altered":
        inner = a3c.rollout_policy

        def altered(config, policy, env, noise, **kw):
            def bent(boards):
                logits, value = policy(boards)
                rows = _quarter(logits.shape[0], logits.device)[:, None]
                return torch.where(rows, logits.roll(1, -1) + 5.0, logits), value

            return inner(config, bent, env, noise, **kw)

        return _patch(a3c, "rollout_policy", altered)
    raise ValueError(fault)


def ntuple_update(fault: str):
    from rein48_tpu_torch.agents import ntuple as agent
    from rein48_tpu_torch.train import ntuple

    if fault == "unchanged":
        return _patch(agent.NTupleNetwork, "td_apply_delayed", lambda self, params, *a, **k: params)
    if fault == "half":
        inner = agent.NTupleNetwork.td_apply_delayed

        def half(self, params, boards, err, alpha, tc=True):
            n = boards.shape[0] // 2
            return inner(self, params, boards[:n], err[:n], alpha, tc)

        return _patch(agent.NTupleNetwork, "td_apply_delayed", half)
    if fault == "altered":
        inner = ntuple._all_afterstates

        def altered(boards):
            after, reward, legal = inner(boards)
            rows = _quarter(boards.shape[0], boards.device)[:, None]
            bonus = torch.zeros_like(reward)
            bonus[:, 3] = 1e6
            return after, torch.where(rows & legal, reward + bonus, reward), legal

        return _patch(ntuple, "_all_afterstates", altered)
    raise ValueError(fault)


def search_move(fault: str):
    from rein48_tpu_torch.engine import vector

    if fault == "unchanged":
        inner = vector.step_autoreset

        def unchanged(env, actions, *a, **k):
            _, out = inner(env, actions, *a, **k)
            return env, out

        return _patch(vector, "step_autoreset", unchanged)
    from rein48_tpu_torch.train import evaluate

    inner_build = evaluate._build_search_policy

    def build(*args, **kw):
        policy = inner_build(*args, **kw)

        def half(boards):
            n = boards.shape[0] // 2
            return torch.cat([policy(boards[:n]), torch.zeros(boards.shape[0] - n, dtype=torch.int64, device=boards.device)])

        def altered(boards):
            a = policy(boards)
            return torch.where(_quarter(a.shape[0], a.device), (a + 1) % 4, a)

        return {"half": half, "altered": altered}[fault]

    if fault not in ("half", "altered"):
        raise ValueError(fault)
    return _patch(evaluate, "_build_search_policy", build)
