"""The plain reference agrees with the port on small inputs."""

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED
from portbench import harness
from portbench.reference import engine, ntuple, philox, resnet, search

CPU = torch.device("cpu")


def spec(channels, blocks):
    """The flagship configuration's file at another width and depth."""
    c = harness.load_json(ROOT / "portbench" / "configs" / "resnet64x4.json")
    return {**c, "channels": channels, "num_blocks": blocks, "head_hidden": channels}


def random_boards(n, seed=0, fill=0.6):
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(1, 12, (n, 4, 4), generator=g, dtype=torch.uint8)
    keep = torch.rand((n, 4, 4), generator=g) < fill
    return torch.where(keep, b, torch.zeros_like(b))


def test_philox_matches_port():
    from rein48_tpu_torch.engine import philox as port

    env = torch.arange(37, dtype=torch.int64)
    step = torch.arange(37, dtype=torch.int64) * 3 + 1
    seeds = torch.full_like(env, SEED)
    assert torch.equal(philox.env_step_words(SEED, env, step), port.step_words(seeds, env, step))
    assert torch.equal(philox.learner_words(SEED, 5, 3, (3, 7), CPU), port.learner_words(SEED, 5, 3, (3, 7)))
    assert torch.equal(philox.gumbel(SEED, 2, (4, 5, 4), CPU), port.learner_gumbel(SEED, 2, (4, 5, 4)))


def test_shuffles_match_port():
    from rein48_tpu_torch.train import common

    for update in (0, 3):
        mine = philox.shuffles(SEED, update, 4, 32, 16, CPU)
        assert torch.equal(mine, common.shuffles(SEED, update, 4, 32, 16, True, CPU))


def test_moves_match_port():
    from rein48_tpu_torch.engine import core

    boards = random_boards(512)
    for a in range(4):
        acts = torch.full((512,), a)
        mine = engine.move(boards, acts)
        theirs = core.move_boards(boards, acts)
        for x, y in zip(mine, theirs):
            assert torch.equal(x, y)
    assert torch.equal(engine.all_moves(boards)[2], core.legal_action_mask(boards))
    assert torch.equal(engine.game_over(boards), core.is_game_over(boards))


def test_games_match_port():
    from rein48_tpu_torch.engine import vector

    n = 64
    mine, port = engine.new_games(SEED, n, CPU), vector.reset_batch(SEED, n, CPU)
    g = torch.Generator().manual_seed(1)
    for _ in range(300):
        assert torch.equal(mine.boards, port.boards)
        a = torch.randint(0, 4, (n,), generator=g)
        mine, reward, done, _ = engine.step(mine, a)
        port, out = vector.step_autoreset(port, a)
        assert torch.equal(reward, out.reward) and torch.equal(done, out.done)


def test_resnet_matches_port_in_float32():
    from rein48_tpu_torch.models import nets

    params = resnet.make_params(spec(16, 2), SEED, CPU)
    model = nets.ResNetPolicy(16, 2, dtype=torch.float32)
    model.load_state_dict(params)
    boards = random_boards(64)
    obs = (boards.long()[..., None] == torch.arange(16)).to(torch.float32)
    logits, value = model(obs)
    mine = resnet.forward(params, boards, spec(16, 2))
    torch.testing.assert_close(mine[0], logits, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mine[1], value, rtol=1e-4, atol=1e-5)


def test_fp8_rounds_coarser_than_bf16():
    x = torch.randn(4096)
    e8 = (resnet.fp8(x) - x).abs().max() / x.abs().max()
    e16 = (x.bfloat16().float() - x).abs().max() / x.abs().max()
    assert e8 > 4 * e16


def test_ntuple_value_matches_port():
    from rein48_tpu_torch.agents import ntuple as port

    tuples = ((0, 1, 2), (0, 4, 8))
    net = port.NTupleNetwork(port.NTupleConfig(tuples=tuples, backend="torch"))
    g = torch.Generator().manual_seed(3)
    params = {f"t{i}": torch.randn(n, generator=g) for i, n in enumerate(net.table_sizes)}
    boards = random_boards(100)
    mine = ntuple.Network(tuples, CPU).value([params["t0"], params["t1"]], boards)
    torch.testing.assert_close(mine, net.value(params, boards), rtol=1e-5, atol=1e-5)


def test_ntuple_window_matches_port():
    from rein48_tpu_torch.agents import ntuple as port

    tuples = ((0, 1, 2), (0, 4, 8))
    net = port.NTupleNetwork(port.NTupleConfig(tuples=tuples, backend="torch"))
    params = net.init_tc(CPU)
    lr = ntuple.new_learner(tuples, SEED, 4, CPU)
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        boards = random_boards(40, seed=int(torch.randint(0, 1000, (1,), generator=g)))
        err = torch.randn(40, generator=g) * (torch.rand(40, generator=g) > 0.2)
        net.td_apply_delayed(params, boards, err, 1.0, tc=True)
        ntuple.apply_window(lr, boards, err, 1.0)
    for i, tab in enumerate(lr.tables):
        for suffix, x in zip(("", "_E", "_A"), tab):
            torch.testing.assert_close(x, params[f"t{i}{suffix}"], rtol=1e-5, atol=1e-6)


def test_expectimax_matches_port_in_float32():
    from rein48_tpu_torch.control import search as port
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import common

    params = resnet.make_params(spec(8, 1), SEED, CPU)
    model = nets.ResNetPolicy(8, 1, dtype=torch.float32)
    model.load_state_dict(params)
    boards = random_boards(6, fill=0.5)
    q, legal = port._action_values(
        boards, 1, port.make_value_leaf(model), lambda r: common.transform_reward(r, "log2"), 0.997, 0.0, 4
    )
    mine = search.action_values(params, spec(8, 1), boards, 0.997)
    torch.testing.assert_close(mine, torch.where(legal, q, -torch.inf), rtol=1e-4, atol=1e-4)
    assert search.needed_leaves(boards) <= 6 * 512


def test_ppo_update_is_deterministic():
    from portbench.reference import ppo

    cfg = {"batch_size": 4, "unroll_len": 4, "num_epochs": 2, "num_minibatches": 2, "gamma": 0.997, "gae_lambda": 0.95,
           "clip_eps": 0.2, "value_coef": 0.5, "max_grad_norm": 0.5, "learning_rate": 3e-4, "lr_decay_updates": 10,
           "lr_final_frac": 0.1, "entropy_beta": 0.01, "entropy_beta_final": 0.002, "entropy_decay_updates": 8}
    params = resnet.make_params(spec(8, 1), SEED, CPU)
    outs = []
    for _ in range(2):
        lr = ppo.new_learner(params, SEED, 4, CPU)
        outs.append(ppo.update(lr, cfg, SEED, spec(8, 1))["loss"])
        assert lr.count == 4 and lr.update == 1
    assert outs[0] == outs[1] and np.isfinite(outs[0])
