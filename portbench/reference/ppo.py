"""One PPO update in plain float32 PyTorch: acting, GAE, clipped-surrogate
epochs with Adam behind a global-norm clip.

The update follows the published algorithm (Schulman et al. 2017, with GAE
from Schulman et al. 2016) at the project's settings: actions sampled as
``argmax(masked logits + Gumbel noise)`` from the learner's ``SAMPLE``
stream, illegal moves masked to -1e9, rewards ``log2(1 + merge score)``,
per-minibatch advantage normalisation, each epoch a permutation of the time
axis within each env, the loss ``actor + value_coef * critic - beta *
entropy``, and optax's Adam (bias-corrected, eps outside the root) with a
cosine learning rate over the optimizer's steps.

With ``follow`` (the boards and actions another side produced) the update
takes those actions, counts the boards that differ from its own game, and
reads the widest gap by which a followed action's sampling score lies below
the best; otherwise it acts itself. ``quant`` runs the tower through
:func:`resnet.fp8` (the control).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench.reference import engine, philox, resnet


@dataclasses.dataclass
class Learner:
    params: dict
    mu: dict
    nu: dict
    count: int
    games: engine.Games
    update: int
    # The first update's minibatch boards, its rows whose outputs no gradient
    # reached, and its first minibatch's gradient of every leaf.
    first_minibatches: list = dataclasses.field(default_factory=list)
    first_unused: int = 0
    first_grad: dict = None


def new_learner(params: dict, seed: int, batch: int, device) -> Learner:
    params = {k: v.detach().clone().float() for k, v in params.items()}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return Learner(params, zeros, {k: v.clone() for k, v in zeros.items()}, 0, engine.new_games(seed, batch, device), 0)


def learning_rate(cfg: dict, count: int) -> float:
    steps = cfg["lr_decay_updates"] * cfg["num_epochs"] * cfg["num_minibatches"]
    if steps <= 0:
        return cfg["learning_rate"]
    decay = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    return cfg["learning_rate"] * ((1.0 - cfg["lr_final_frac"]) * decay + cfg["lr_final_frac"])


def entropy_beta(cfg: dict, update: int) -> float:
    if cfg.get("entropy_beta_final") is None or cfg["entropy_decay_updates"] <= 0:
        return cfg["entropy_beta"]
    frac = min(max(update / cfg["entropy_decay_updates"], 0.0), 1.0)
    return cfg["entropy_beta"] + frac * (cfg["entropy_beta_final"] - cfg["entropy_beta"])


def _masked(logits, legal):
    return torch.where(legal, logits, torch.full_like(logits, -1e9))


def act(lr: Learner, cfg: dict, seed: int, spec: dict, follow=None, quant=None):
    """``unroll_len`` steps: returns the trajectory and the followed side's
    readings ``(boards_differ, widest_gap)``."""
    T, B = cfg["unroll_len"], cfg["batch_size"]
    dev = lr.games.boards.device
    noise = philox.gumbel(seed, lr.update, (T, B, 4), dev)
    traj = {k: [] for k in ("boards", "actions", "legal", "logp", "value", "reward", "done")}
    differ, gap = 0, 0.0
    with torch.no_grad():
        for t in range(T):
            boards = lr.games.boards
            logits, value = resnet.forward_blocks(lr.params, boards, spec, quant)
            legal = engine.all_moves(boards)[2]
            masked = _masked(logits, legal)
            score = masked + noise[t]
            if follow is None:
                a = score.argmax(-1)
            else:
                differ += int((follow["boards"][t] != boards).flatten(1).any(-1).sum())
                a = follow["actions"][t].long()
                chosen = score.gather(1, a[:, None])[:, 0]
                gap = max(gap, float((score.max(-1).values - chosen).max()))
            logp = torch.log_softmax(masked, -1).gather(1, a[:, None])[:, 0]
            lr.games, reward, done, _ = engine.step(lr.games, a)
            for k, v in (("boards", boards), ("actions", a), ("legal", legal), ("logp", logp), ("value", value),
                         ("reward", engine.log2_reward(reward)), ("done", done)):
                traj[k].append(v)
        bootstrap = resnet.forward_blocks(lr.params, lr.games.boards, spec, quant)[1]
    traj = {k: torch.stack(v) for k, v in traj.items()}
    traj["bootstrap"] = bootstrap
    return traj, differ, gap


def gae(traj: dict, gamma: float, lam: float):
    cont = 1.0 - traj["done"].float()
    values = traj["value"]
    nxt = torch.cat([values[1:], traj["bootstrap"][None]])
    delta = traj["reward"] + gamma * cont * nxt - values
    adv = torch.zeros_like(values)
    run = torch.zeros_like(values[0])
    for t in range(values.shape[0] - 1, -1, -1):
        run = delta[t] + gamma * lam * cont[t] * run
        adv[t] = run
    return adv, adv + values


def loss_fn(params, mb, cfg, beta, spec, quant=None):
    """The minibatch's loss, with the tower's outputs it was taken from."""
    logits, values = resnet.forward(params, mb["boards"], spec, quant)
    logp = torch.log_softmax(_masked(logits, mb["legal"]), -1)
    adv = mb["adv"]
    adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-6)
    ratio = torch.exp(logp.gather(1, mb["actions"][:, None])[:, 0] - mb["logp"])
    eps = cfg["clip_eps"]
    actor = -torch.minimum(ratio * adv, ratio.clamp(1 - eps, 1 + eps) * adv).mean()
    critic = ((values - mb["ret"]) ** 2).mean()
    entropy = -(logp.exp() * logp).sum(-1).mean()
    return actor + cfg["value_coef"] * critic - beta * entropy, logits, values


def adam_step(lr: Learner, grads: dict, cfg: dict):
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    clip = cfg["max_grad_norm"]
    rate = learning_rate(cfg, lr.count)
    lr.count += 1
    bc1, bc2 = 1.0 - 0.9**lr.count, 1.0 - 0.999**lr.count
    for k, g in grads.items():
        g = torch.where(norm < clip, g, g / norm * clip)
        lr.mu[k] = 0.9 * lr.mu[k] + 0.1 * g
        lr.nu[k] = 0.999 * lr.nu[k] + 0.001 * g * g
        lr.params[k] = lr.params[k] - rate * (lr.mu[k] / bc1) / (torch.sqrt(lr.nu[k] / bc2) + 1e-8)


def learn(lr: Learner, traj: dict, cfg: dict, seed: int, spec: dict, quant=None) -> float:
    """The epochs; returns the last epoch's mean minibatch loss."""
    T, B, E, M = cfg["unroll_len"], cfg["batch_size"], cfg["num_epochs"], cfg["num_minibatches"]
    adv, ret = gae(traj, cfg["gamma"], cfg["gae_lambda"])
    data = {"boards": traj["boards"], "actions": traj["actions"], "legal": traj["legal"], "logp": traj["logp"],
            "adv": adv, "ret": ret}
    perms = philox.shuffles(seed, lr.update, E, T, B, adv.device)
    beta = entropy_beta(cfg, lr.update)
    names = list(lr.params)
    for e in range(E):
        losses = []
        for m in range(M):
            rows = perms[e][m * T // M : (m + 1) * T // M]
            mb = {}
            for k, x in data.items():
                idx = rows.reshape(rows.shape + (1,) * (x.ndim - 2)).expand(rows.shape + x.shape[2:])
                mb[k] = torch.gather(x, 0, idx).reshape((-1,) + x.shape[2:])
            leaves = {k: lr.params[k].detach().requires_grad_(True) for k in names}
            loss, logits, values = loss_fn(leaves, mb, cfg, beta, spec, quant)
            *grads, g_logits, g_values = torch.autograd.grad(loss, [leaves[k] for k in names] + [logits, values])
            if lr.update == 0:
                lr.first_minibatches.append(mb["boards"])
                lr.first_unused += int(((g_logits == 0).all(-1) & (g_values == 0)).sum())
                if lr.first_grad is None:
                    lr.first_grad = dict(zip(names, grads))
            lr.params = {k: v.detach() for k, v in leaves.items()}
            adam_step(lr, dict(zip(names, grads)), cfg)
            losses.append(float(loss.detach()))
    return sum(losses) / len(losses)


def update(lr: Learner, cfg: dict, seed: int, spec: dict, follow=None, quant=None) -> dict:
    """One whole update in place; its readings."""
    with resnet.exact_float32():
        traj, differ, gap = act(lr, cfg, seed, spec, follow, quant)
        loss = learn(lr, traj, cfg, seed, spec, quant)
    out = {"loss": loss, "boards_differ": differ, "action_gap": gap, "boards": traj["boards"], "actions": traj["actions"]}
    lr.update += 1
    return out
