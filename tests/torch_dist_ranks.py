# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The rank side of the port's multi-process tests (``tests/test_torch_distributed.py``).

Each case is a function ``case(mesh, arg) -> dict`` that trains a few
updates of one family and returns what the test compares. The test calls
it in its own process with ``mesh=None`` (the one-process run) and, through
:func:`spawn`, in every rank of a gloo group on the CPU with the group's
mesh. This module imports no JAX: the ranks run the port alone. Ranks join
through a file store under the test's temporary directory, so concurrent
test workers never compete for a port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from rein48_tpu_torch.agents import ntuple as ntuple_lib
from rein48_tpu_torch.parallel import mesh as mesh_lib
from rein48_tpu_torch.parallel import multihost, spmd
from rein48_tpu_torch.train import a3c, afterstate, common, dqn, ntuple, ppo
from rein48_tpu_torch.utils.checkpoint import Checkpointer

TINY = (("channels", 8), ("num_blocks", 1), ("dtype", torch.float32))
CASES = {}
# Where the cases run: the CPU, or "cuda" in the card's tests.
DEVICE = "cpu"


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@contextlib.contextmanager
def one_rank():
    """A one-rank gloo group in this process, left on exit."""
    multihost.initialize(num_processes=1, process_id=0, device="cpu")
    try:
        yield multihost.global_mesh()
    finally:
        multihost.shutdown()


def _rank_main(rank: int, world: int, store: str, jobs, out: str, tp: int, device: str, backend) -> None:
    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    try:
        multihost.initialize(f"file://{store}", world, rank, device=device, backend=backend)
        mesh = mesh_lib.make_mesh(mesh_lib.MeshConfig(tp=tp))
        results = {label: CASES[name](mesh, arg) for label, (name, arg) in jobs.items()}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


def spawn(tmp_path, jobs, world: int = 2, tp: int = 1, device: str = "cpu", backend=None, timeout: float = 240.0) -> list[dict]:
    """Run ``jobs`` (``{label: (case name, arg)}``) in ``world`` spawned
    ranks on ``device`` (all ranks on one card on "cuda": gloo, unless
    ``backend`` says otherwise); returns each rank's ``{label: result}``. A
    rank that fails or does not finish in ``timeout`` seconds fails the test."""
    out = tmp_path / f"ranks-{len(os.listdir(tmp_path))}"
    out.mkdir()
    ctx = mp.get_context("spawn")
    args = (world, str(out / "store"), jobs, str(out), tp, device, backend)
    procs = [ctx.Process(target=_rank_main, args=(r, *args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    errors = [(out / f"rank{r}.err").read_text() for r in range(world) if (out / f"rank{r}.err").exists()]
    assert not errors, "\n".join(errors)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _metrics(ms):
    return [{k: float(v) for k, v in m.items()} for m in ms]


def _params(model, mesh):
    sd = model.state_dict() if mesh is None else mesh_lib.full_state_dict(model, mesh)
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _two_updates(mesh, state, step, models, first):
    """``first(state)`` (what the first update's acting chose), then two updates."""
    chosen = first(state)
    state, m1 = step(state)
    state, m2 = step(state)
    return {
        "chosen": chosen,
        "boards": state.env.boards.detach().cpu().clone(),
        "metrics": _metrics([m1, m2]),
        "params": [_params(m, mesh) for m in models],
    }


A3C_CFG = a3c.A3CConfig(batch_size=16, unroll_len=3, model="mlp")


@case
def a3c_update(mesh, cfg=A3C_CFG):
    """Two A3C updates (the MLP, advantages normalized over the batch)."""
    state, model, opt = a3c.init_a3c(cfg, 0, device=DEVICE)
    state = common.place_on_mesh(mesh, state, opt, model)
    step = a3c.make_a3c_step(cfg, model, opt, mesh)
    return _two_updates(mesh, state, step, [model], lambda s: step.rollout(s)[1]["actions"])


@case
def a3c_grads(mesh, arg):
    """The learner's gradient on a fixed batch (``arg``: params and the
    global batch as numpy), this rank's rows of it."""
    params, batch = arg
    cfg = dataclasses.replace(A3C_CFG, batch_size=batch["boards"].shape[1], unroll_len=batch["boards"].shape[0])
    state, model, opt = a3c.init_a3c(cfg, 0, device=DEVICE)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    state = common.place_on_mesh(mesh, state, opt, model)
    step = a3c.make_a3c_step(cfg, model, opt, mesh)
    local = {k: torch.as_tensor(v)[:, step.rows] for k, v in batch.items()}
    aux, grads = step.loss_and_grads(state, local)
    names = [n for n, _ in model.named_parameters()]
    return {"loss": float(aux["loss"]), "grads": dict(zip(names, [g.detach().cpu().clone() for g in grads]))}


PPO_CFG = ppo.PPOConfig(
    batch_size=8, unroll_len=4, num_epochs=2, num_minibatches=2, model_kwargs=TINY,
    afterstate_critic=True, after_model_kwargs=TINY,
)


@case
def ppo_update(mesh, cfg=PPO_CFG):
    """Two PPO updates with the afterstate critic, shard-friendly shuffles,
    2 epochs x 2 minibatches."""
    state, model, opt = ppo.init_ppo(cfg, 0, device=DEVICE)
    state = common.place_on_mesh(mesh, state, opt, model, state.after_model)
    step = ppo.make_ppo_step(cfg, model, opt, state.after_model, mesh)
    return _two_updates(mesh, state, step, [model, state.after_model], lambda s: step.rollout(s)[1]["actions"])


AFTERSTATE_CFG = afterstate.AfterstateTDConfig(
    batch_size=8, unroll_len=4, num_minibatches=2, model_kwargs=TINY, epsilon=0.25
)


@case
def afterstate_update(mesh, cfg=AFTERSTATE_CFG):
    """Two afterstate-TD updates of a tiny ResNet (epsilon-greedy acting)."""
    state, model, opt = afterstate.init_afterstate_td(cfg, 0, device=DEVICE)
    state = common.place_on_mesh(mesh, state, opt, model)
    step = afterstate.make_afterstate_td_step(cfg, model, opt, mesh)
    return _two_updates(mesh, state, step, [model], lambda s: step.rollout(s)[1]["after_boards"])


NTUPLE_CASES = {
    "tiny-torch-step": dict(tuples=ntuple_lib.TINY_2X3, table_backend="torch", update_mode="step"),
    "tiny-torch-delayed": dict(tuples=ntuple_lib.TINY_2X3, table_backend="torch", update_mode="delayed", delay_window=2),
    "sj-torch-step": dict(tuples=ntuple_lib.SJ_2X4, table_backend="torch", update_mode="step", tc=False, collision="sum"),
    "sj-mxu-step": dict(tuples=ntuple_lib.SJ_2X4, table_backend="mxu", update_mode="step"),
    "sj-mxu-delayed": dict(tuples=ntuple_lib.SJ_2X4, table_backend="mxu", update_mode="delayed", delay_window=2),
    "sj-cached-delayed": dict(
        tuples=ntuple_lib.SJ_2X4, table_backend="cached", update_mode="delayed", delay_window=2, cache_prefix_rows=4
    ),
    "sj-cached-step": dict(tuples=ntuple_lib.SJ_2X4, table_backend="cached", update_mode="step", cache_prefix_rows=4),
}


@case
def ntuple_update(mesh, name):
    """Two n-tuple updates of the configuration ``NTUPLE_CASES[name]``."""
    cfg = ntuple.NTupleTrainConfig(batch_size=16, steps_per_update=4, alpha=0.5, **NTUPLE_CASES[name])
    state, net = ntuple.init_ntuple(cfg, 0, device=DEVICE)
    state = dataclasses.replace(state, params=net.refresh_cache(state.params))
    state = common.place_on_mesh(mesh, state, None, batched=ntuple.BATCHED)
    step = ntuple.make_ntuple_step(cfg, DEVICE, mesh)
    state, m1 = step(state)
    state, m2 = step(state)
    return {
        "chosen": state.prev_after.detach().cpu().clone(),
        "boards": state.env.boards.detach().cpu().clone(),
        "metrics": _metrics([m1, m2]),
        "tables": {k: v.detach().cpu().clone() for k, v in state.params.items()},
    }


DQN_CFG = dqn.DQNConfig(
    num_envs=16, model="qnet", model_kwargs=(("dtype", torch.float32),), replay_capacity=256, learn_batch_size=32,
    min_replay_before_learn=32, epsilon_decay_steps=64, tau=0.9,
)


def _dqn_state(cfg, mesh, checkpointer=None):
    state, model, opt = dqn.init_dqn(cfg, 0, device=DEVICE)
    if checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(state)
    if mesh is not None:
        state = dataclasses.replace(state, replay=dqn.shard_replay(state.replay, cfg.num_envs, mesh))
    state = common.place_on_mesh(mesh, state, opt, model)
    return state, dqn.make_dqn_step(cfg, model, state.target_model, opt, mesh)


@case
def dqn_update(mesh, n_step):
    """Four DQN updates (1-step or n-step): cold, then learning from update 2."""
    cfg = dataclasses.replace(DQN_CFG, n_step=n_step)
    state, step = _dqn_state(cfg, mesh)
    ms = []
    for _ in range(4):
        state, m = step(state)
        ms.append(m)
    replay = state.replay if mesh is None else dqn.gather_replay(state.replay, cfg.num_envs, mesh)
    return {
        "boards": state.env.boards.detach().cpu().clone(),
        "metrics": _metrics(ms),
        "params": [_params(state.model, mesh), _params(state.target_model, mesh)],
        "replay": ({k: v.detach().cpu().clone() for k, v in replay.data.items()}, replay.cursor, replay.size),
    }


@case
def dqn_resume(mesh, directory):
    """``train_dqn`` for one update from the checkpoint under ``directory``
    (or three updates, saving at 2, into an empty one)."""
    ckpt = Checkpointer(directory, save_every=2)
    updates = 1 if ckpt.latest_step() is not None else 3
    state, history = dqn.train_dqn(DQN_CFG, updates, mesh=mesh, log_every=1, checkpointer=ckpt, device=DEVICE)
    return {
        "history": without_rate(history),
        "params": _params(state.model, mesh),
        "boards": state.env.boards.detach().cpu().clone(),
    }


@case
def replicated(mesh, arg=None):
    """``assert_replicated`` passes on equal tensors and raises on a rank's own."""
    spmd.assert_replicated([torch.arange(4.0)], mesh.group)
    try:
        spmd.assert_replicated([torch.arange(4.0) + mesh.rank], mesh.group)
    except RuntimeError as e:
        return {"raised": "differ between ranks" in str(e)}
    return {"raised": False}


def assert_replicated(results, *keys):
    """Every rank returned the same bits under ``keys`` (nested lists and
    dicts of tensors and floats)."""

    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif torch.is_tensor(a):
            assert torch.equal(a, b), where
        else:
            assert a == b, where

    for other in results[1:]:
        for key in keys:
            same(results[0][key], other[key], key)


def assert_metrics_close(got, want, rtol=1e-5):
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6, err_msg=k)


def assert_params_close(got, want, adam_bound=None):
    """JAX's tolerances, atol 1e-5 and rtol 1e-4; with ``adam_bound`` the
    per-entry bound of Adam's moment signs and rtol 1e-4 over the set."""
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if adam_bound is None:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            assert np.abs(g - w).max() <= adam_bound, k
    if adam_bound is not None:
        flat = lambda d: np.concatenate([d[k].numpy().ravel() for k in want])  # noqa: E731
        np.testing.assert_allclose(np.linalg.norm(flat(got) - flat(want)), 0.0, atol=1e-4 * np.linalg.norm(flat(want)))


def check_family(results, ref, chosen_dim, adam_bound=None):
    assert_replicated(results, "metrics", "params")
    assert torch.equal(torch.cat([r["chosen"] for r in results], dim=chosen_dim), ref["chosen"])
    assert torch.equal(global_env(results), ref["boards"])
    assert_metrics_close(results[0]["metrics"], ref["metrics"])
    for got, want in zip(results[0]["params"], ref["params"], strict=True):
        assert_params_close(got, want, adam_bound)


def layout(world: int = 2, rank: int = 0):
    """A mesh layout of ``world`` ranks without a process group."""
    return mesh_lib.make_mesh(mesh_lib.MeshConfig(), world=world, rank=rank)


def global_env(results, key="boards"):
    """Every rank's rows of ``key``, in rank order."""
    return torch.cat([r[key] for r in results])


def without_rate(history):
    """Records without their wall-clock rate."""
    return [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in history]
