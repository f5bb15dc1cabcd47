# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's checkpoints, its train -> eval CLI, and its FLOP count.

Checkpoints are exact: a restored state equals the saved one tensor for
tensor, env counters and the learner's seed included, and a resumed run
equals an uninterrupted one bit for bit. The CLI's evaluation of a
checkpoint equals ``evaluate_search``/``evaluate_ntuple`` called directly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rein48_tpu_torch import cli
from rein48_tpu_torch.agents import ntuple
from rein48_tpu_torch.engine.core import RewardMode
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.engine import philox
from rein48_tpu_torch.train import a3c, afterstate, dqn, evaluate, ppo
from rein48_tpu_torch.train import ntuple as nt
from rein48_tpu_torch.utils import flops
from rein48_tpu_torch.utils.checkpoint import Checkpointer

torch.set_num_threads(1)

SMALL = (("channels", 8), ("num_blocks", 1), ("dtype", torch.float32))
CFG = afterstate.AfterstateTDConfig(batch_size=8, unroll_len=4, num_minibatches=2, model_kwargs=SMALL, lr_decay_updates=4)


def assert_states_equal(a: afterstate.AfterstateTDState, b: afterstate.AfterstateTDState):
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"] and sa["name"] == sb["name"]
    for m in a.optimizer.moments:
        assert all(torch.equal(x, y) for x, y in zip(sa[m], sb[m])), m
    for f in dataclasses.fields(a.env):
        assert torch.equal(getattr(a.env, f.name), getattr(b.env, f.name)), f.name
    assert a.seed == b.seed and a.update_step == b.update_step
    # The learner's draws are named by (seed, update_step): the next update shuffles alike.
    perms = [afterstate.make_afterstate_td_step(CFG, s.model, s.optimizer).permutations(s, "cpu") for s in (a, b)]
    assert torch.equal(*perms)


class TestAfterstateCheckpoint:
    def test_round_trip_is_bit_exact(self, tmp_path):
        state, _ = afterstate.train_afterstate_td(CFG, 2, seed=1, log_every=2, device="cpu")
        ck = Checkpointer(str(tmp_path))
        ck.save(2, state)
        other, _, _ = afterstate.init_afterstate_td(CFG, 99, device="cpu")
        restored = ck.restore(other)
        assert_states_equal(restored, state)
        # The optimizer still updates the restored module's own parameters.
        assert all(p is q for p, q in zip(restored.optimizer.params, restored.model.parameters()))

    def test_resume_continues_bit_for_bit(self, tmp_path, capsys):
        full, full_hist = afterstate.train_afterstate_td(CFG, 4, seed=2, log_every=1, device="cpu")
        ck = Checkpointer(str(tmp_path), save_every=2)
        afterstate.train_afterstate_td(CFG, 2, seed=2, log_every=1, checkpointer=ck, device="cpu")
        resumed, hist = afterstate.train_afterstate_td(CFG, 2, seed=2, log_every=1, checkpointer=ck, device="cpu")
        assert "resumed from checkpoint step 2" in capsys.readouterr().out
        assert_states_equal(resumed, full)
        strip = lambda h: [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in h]
        assert strip(hist) == strip(full_hist[2:])
        assert ck.all_steps() == [2, 4]

    def test_missing_checkpoint_raises(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        assert ck.latest_step() is None
        state, _, _ = afterstate.init_afterstate_td(CFG, 0, device="cpu")
        with pytest.raises(FileNotFoundError):
            ck.restore(state)
        with pytest.raises(FileNotFoundError):
            ck.restore_field("model")
        ck.save(3, state)
        with pytest.raises(FileNotFoundError):
            ck.restore(state, step=4)

    def test_config_round_trips_with_enums_by_name(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        assert ck.load_config() is None
        cfg = dataclasses.replace(CFG, reward_mode=RewardMode.PARITY_ZERO, gamma=0.9)
        ck.save_config(cfg)
        saved = Checkpointer(str(tmp_path)).load_config()
        assert saved == json.loads(json.dumps({
            **dataclasses.asdict(cfg), "reward_mode": "PARITY_ZERO",
            "model_kwargs": [["channels", 8], ["num_blocks", 1], ["dtype", "torch.float32"]],
        }))
        ck.save_config(nt.NTupleTrainConfig(tuples=ntuple.TINY_2X3))
        assert ck.load_config()["tuples"] == [list(t) for t in ntuple.TINY_2X3]

    def test_crashed_temporary_is_ignored_and_swept(self, tmp_path):
        state, _, _ = afterstate.init_afterstate_td(CFG, 0, device="cpu")
        ck = Checkpointer(str(tmp_path))
        ck.save(1, state)
        crashed = tmp_path / "7.x1y2.tmp"
        crashed.mkdir()
        (crashed / "state.pt").write_bytes(b"partial")
        (tmp_path / "8").mkdir()  # a step directory with no state file
        assert ck.latest_step() == 1
        Checkpointer(str(tmp_path))
        assert not crashed.exists() and ck.latest_step() == 1

    def test_max_to_keep_and_restore_field(self, tmp_path):
        state, _, _ = afterstate.init_afterstate_td(CFG, 0, device="cpu")
        ck = Checkpointer(str(tmp_path), save_every=2, max_to_keep=2)
        for step in range(1, 7):
            assert ck.maybe_save(step, dataclasses.replace(state, update_step=step)) == (step % 2 == 0)
        assert ck.all_steps() == [4, 6] and sorted(os.listdir(tmp_path)) == ["4", "6"]
        assert ck.restore_field("update_step") == 6 and ck.restore_field("update_step", step=4) == 4
        params = ck.restore_field("model")
        for k, v in state.model.state_dict().items():
            assert torch.equal(params[k], v), k
        ck.save(6, dataclasses.replace(state, update_step=60))  # replaces step 6
        assert ck.all_steps() == [4, 6] and ck.restore_field("update_step") == 60
        ck.close()


PPO_CFG = ppo.PPOConfig(
    batch_size=8, unroll_len=4, num_epochs=2, num_minibatches=2, model_kwargs=SMALL, after_model_kwargs=SMALL,
    afterstate_critic=True, lr_decay_updates=4, entropy_beta_final=0.002, entropy_decay_updates=3,
)
A3C_CFG = a3c.A3CConfig(batch_size=8, unroll_len=4, model="mlp", optimizer="rmsprop", lr_decay_updates=4)


def assert_trainer_states_equal(a, b, modules=("model",)):
    """Every module, the optimizer, the env, the seed and the step equal; and
    so the next update's draws (sampling noise, shuffles) are equal."""
    for name in modules:
        for (k, x), y in zip(getattr(a, name).state_dict().items(), getattr(b, name).state_dict().values()):
            assert torch.equal(x, y), f"{name}.{k}"
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"] and all(torch.equal(x, y) for m in a.optimizer.moments for x, y in zip(sa[m], sb[m]))
    for f in dataclasses.fields(a.env):
        assert torch.equal(getattr(a.env, f.name), getattr(b.env, f.name)), f.name
    assert (a.seed, a.update_step) == (b.seed, b.update_step)
    draws = [philox.learner_gumbel(s.seed, s.update_step, (4, 8, 4)) for s in (a, b)]
    assert torch.equal(*draws)


class TestActorCriticCheckpoint:
    def test_ppo_critic_round_trip_is_bit_exact(self, tmp_path):
        state, _ = ppo.train_ppo(PPO_CFG, 2, seed=1, log_every=2, device="cpu")
        ck = Checkpointer(str(tmp_path))
        ck.save(2, state)
        assert set(ck.restore_field("after_model")) == set(state.after_model.state_dict())
        restored = ck.restore(ppo.init_ppo(PPO_CFG, 99, device="cpu")[0])
        assert_trainer_states_equal(restored, state, ("model", "after_model"))
        # One optimizer over both nets' own parameters.
        params = list(restored.model.parameters()) + list(restored.after_model.parameters())
        assert all(p is q for p, q in zip(restored.optimizer.params, params))
        steps = [ppo.make_ppo_step(PPO_CFG, s.model, s.optimizer, s.after_model) for s in (state, restored)]
        assert torch.equal(steps[0].permutations(state, "cpu"), steps[1].permutations(restored, "cpu"))
        assert torch.equal(steps[0].rollout(state)[1]["after_boards"], steps[1].rollout(restored)[1]["after_boards"])

    @pytest.mark.parametrize("trainer", ["ppo", "a3c"])
    def test_resume_continues_bit_for_bit(self, trainer, tmp_path, capsys):
        train, cfg = (ppo.train_ppo, PPO_CFG) if trainer == "ppo" else (a3c.train_a3c, A3C_CFG)
        modules = ("model", "after_model") if trainer == "ppo" else ("model",)
        full, full_hist = train(cfg, 4, seed=2, log_every=1, device="cpu")
        ck = Checkpointer(str(tmp_path), save_every=2)
        train(cfg, 2, seed=2, log_every=1, checkpointer=ck, device="cpu")
        resumed, hist = train(cfg, 2, seed=2, log_every=1, checkpointer=ck, device="cpu")
        assert "resumed from checkpoint step 2" in capsys.readouterr().out
        assert_trainer_states_equal(resumed, full, modules)
        strip = lambda h: [{k: v for k, v in r.items() if k != "steps_per_sec"} for r in h]
        assert strip(hist) == strip(full_hist[2:])

    def test_a3c_state_round_trips_without_a_second_net(self, tmp_path):
        state, _ = a3c.train_a3c(A3C_CFG, 1, seed=3, device="cpu")
        ck = Checkpointer(str(tmp_path))
        ck.save(1, state)
        assert set(torch.load(tmp_path / "1" / "state.pt", weights_only=True)) == {"model", "optimizer", "env", "seed", "update_step"}
        assert_trainer_states_equal(ck.restore(a3c.init_a3c(A3C_CFG, 4, device="cpu")[0]), state)


class TestNTupleCheckpoint:
    def test_resume_continues_bit_for_bit(self, tmp_path, capsys):
        cfg = nt.NTupleTrainConfig(batch_size=8, steps_per_update=4, tuples=ntuple.TINY_2X3, table_backend="torch")
        full, _ = nt.train_ntuple(cfg, 4, seed=3, log_every=1, device="cpu")
        ck = Checkpointer(str(tmp_path), save_every=1)
        nt.train_ntuple(cfg, 2, seed=3, log_every=1, checkpointer=ck, device="cpu")
        resumed, hist = nt.train_ntuple(cfg, 2, seed=3, log_every=1, checkpointer=ck, device="cpu")
        assert "resumed from checkpoint step 2" in capsys.readouterr().out
        assert [r["update"] for r in hist] == [3, 4] and resumed.update_step == 4
        for k in full.params:
            assert torch.equal(resumed.params[k], full.params[k]), k
        for name in ("boards", "counter", "score"):
            assert torch.equal(getattr(resumed.env, name), getattr(full.env, name))
        assert torch.equal(resumed.prev_after, full.prev_after) and torch.equal(resumed.prev_valid, full.prev_valid)

    def test_cached_state_round_trips(self, tmp_path):
        cfg = nt.NTupleTrainConfig(
            batch_size=8, steps_per_update=4, tuples=((0, 1, 2, 3),), update_mode="delayed", table_backend="cached",
            cache_prefix_rows=128,
        )
        state, _ = nt.train_ntuple(cfg, 2, seed=4, log_every=2, device="cpu")
        assert {"t0_rm", "t0_hot"} <= set(state.params)
        ck = Checkpointer(str(tmp_path))
        ck.save(2, state)
        fresh, _ = nt.init_ntuple(cfg, 5, device="cpu")
        restored = ck.restore(fresh)
        for k, v in state.params.items():
            assert restored.params[k].dtype == v.dtype and torch.equal(restored.params[k], v), k
        assert torch.equal(restored.env.counter, state.env.counter) and restored.update_step == 2


class TestTrainEvalCommands:
    """In-process ``cli.main``: train with a checkpoint, then evaluate it."""

    def _run(self, argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert cli.main(argv) == 0
        return out.getvalue(), err.getvalue()

    def test_afterstate_train_then_search(self, tmp_path, monkeypatch):
        real = afterstate.AfterstateTDConfig

        def small(**kw):
            return real(model_kwargs=SMALL, gamma=0.95, num_minibatches=2, **kw)

        monkeypatch.setattr(afterstate, "AfterstateTDConfig", small)
        base = ["train", "--algo", "afterstate", "--batch-size", "8", "--unroll", "4", "--lr", "1e-3",
                "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2", "--log-every", "1", "--device", "cpu"]
        _, err = self._run(base + ["--updates", "2"])
        assert err.startswith("final: {'update': 2")
        out, _ = self._run(base + ["--updates", "2"])
        assert "resumed from checkpoint step 2" in out
        ck = Checkpointer(str(tmp_path))
        assert ck.all_steps() == [2, 4] and ck.load_config()["gamma"] == 0.95
        assert ck.load_config()["learning_rate"] == 1e-3

        argv = ["eval", "--algo", "search", "--checkpoint-dir", str(tmp_path), "--num-envs", "4", "--max-steps", "12",
                "--device", "cpu", "--protocol", "first", "--seed", "3"]
        for depth in ("0", "1"):
            out, err = self._run(argv + ["--depth", depth])
            assert "restored step 4" in err
            model = nets.make_model("resnet", **dict(SMALL))
            model.load_state_dict(ck.restore_field("model"))
            want = evaluate.evaluate_search(
                depth=int(depth), num_envs=4, num_steps=12, seed=3, model=model.eval(), gamma=0.95,
                reward_transform="log2", protocol="first", device="cpu",
            )
            assert json.loads(out.strip().splitlines()[-1]) == want
        # A flag wins over the saved config.
        out, _ = self._run(argv + ["--depth", "0", "--gamma", "0.5"])
        want = evaluate.evaluate_search(
            depth=0, num_envs=4, num_steps=12, seed=3, model=model, gamma=0.5, protocol="first", device="cpu"
        )
        assert json.loads(out.strip().splitlines()[-1]) == want

    def test_ppo_afterstate_train_then_eval(self, tmp_path, monkeypatch):
        real = ppo.PPOConfig

        def small(**kw):
            return real(model_kwargs=SMALL, after_model_kwargs=SMALL, num_minibatches=2, num_epochs=1, gamma=0.95, **kw)

        monkeypatch.setattr(ppo, "PPOConfig", small)
        base = ["train", "--algo", "ppo", "--afterstate", "--batch-size", "8", "--unroll", "4", "--checkpoint-dir", str(tmp_path),
                "--checkpoint-every", "2", "--log-every", "1", "--device", "cpu"]
        _, err = self._run(base + ["--updates", "2"])
        assert err.startswith("final: {'update': 2") and "'after_loss'" in err
        out, _ = self._run(base + ["--updates", "2"])
        assert "resumed from checkpoint step 2" in out
        ck = Checkpointer(str(tmp_path))
        saved = ck.load_config()
        assert ck.all_steps() == [2, 4] and saved["afterstate_critic"] and saved["after_model"] == "resnet"
        policy = nets.make_model("resnet", **dict(SMALL))
        policy.load_state_dict(ck.restore_field("model"))
        leaf = nets.make_model("resnet", **dict(SMALL))
        leaf.load_state_dict(ck.restore_field("after_model"))
        common = ["--checkpoint-dir", str(tmp_path), "--num-envs", "4", "--max-steps", "12", "--device", "cpu", "--seed", "3"]
        for sample in (False, True):
            out, err = self._run(["eval", "--algo", "ppo"] + common + (["--sample"] if sample else []))
            want = evaluate.evaluate_policy(policy.eval(), num_envs=4, num_steps=12, seed=3, greedy=not sample, device="cpu")
            assert "restored step 4" in err and json.loads(out.strip().splitlines()[-1]) == want
        # Search takes the afterstate critic as its leaf, in the saved units.
        out, err = self._run(["eval", "--algo", "search", "--depth", "0", "--protocol", "first"] + common)
        assert "using afterstate-critic leaf" in err and '"gamma": 0.95' in err
        want = evaluate.evaluate_search(
            depth=0, num_envs=4, num_steps=12, seed=3, model=leaf.eval(), gamma=0.95, protocol="first", device="cpu"
        )
        assert json.loads(out.strip().splitlines()[-1]) == want

    def test_a3c_train_then_eval(self, tmp_path, monkeypatch):
        # The reference-parity regime: the MLP on raw tiles; eval reads the encoding back.
        d = tmp_path / "parity"
        self._run(["train", "--algo", "a3c", "--parity", "--batch-size", "4", "--updates", "1", "--checkpoint-dir", str(d),
                   "--checkpoint-every", "1", "--device", "cpu"])
        ck = Checkpointer(str(d))
        assert ck.load_config()["obs_encoding"] == "raw" and ck.load_config()["unroll_len"] == 100
        model = nets.make_model("mlp", in_channels=1)
        model.load_state_dict(ck.restore_field("model"))
        out, _ = self._run(["eval", "--algo", "a3c", "--checkpoint-dir", str(d), "--num-envs", "4", "--max-steps", "12",
                            "--device", "cpu", "--sample"])
        want = evaluate.evaluate_policy(model.eval(), obs_encoding="raw", num_envs=4, num_steps=12, greedy=False, device="cpu")
        assert json.loads(out.strip().splitlines()[-1]) == want
        # The defaults on a small ResNet, and eval of a fresh init without a checkpoint.
        real = a3c.A3CConfig
        monkeypatch.setattr(a3c, "A3CConfig", lambda **kw: real(model_kwargs=SMALL, **kw))
        _, err = self._run(["train", "--algo", "a3c", "--batch-size", "8", "--unroll", "4", "--updates", "2", "--log-every", "1",
                            "--device", "cpu"])
        assert err.startswith("final: {'update': 2")
        out, _ = self._run(["eval", "--algo", "ppo", "--model", "cnn", "--num-envs", "4", "--max-steps", "8", "--device", "cpu"])
        fresh = nets.make_model("cnn", generator=torch.Generator().manual_seed(0))
        assert json.loads(out.strip().splitlines()[-1]) == evaluate.evaluate_policy(fresh, num_envs=4, num_steps=8, device="cpu")

    # --mesh is ported: the trainer gets a one-rank mesh outside torchrun,
    # and the group is left after the run; DDPG takes none, as in JAX.
    @pytest.mark.parametrize("argv", [["train", "--algo", "dqn", "--mesh"], ["train", "--algo", "ddpg", "--mesh"],
                                      ["train", "--algo", "ppo", "--mesh"], ["train", "--algo", "a3c", "--mesh"]])
    def test_unported_commands_say_so(self, argv, monkeypatch):
        if argv[2] == "ddpg":
            with pytest.raises(SystemExit, match="takes no --mesh"):
                cli.main(argv + ["--device", "cpu"])
            return
        module = {"dqn": dqn, "ppo": ppo, "a3c": a3c}[argv[2]]
        seen = {}

        def train(config, mesh=None, **kw):
            seen["shape"] = mesh.shape
            return None, []

        monkeypatch.setattr(module, f"train_{argv[2]}", train)
        with contextlib.redirect_stderr(io.StringIO()) as err:
            assert cli.main(argv + ["--device", "cpu"]) == 0
        assert seen["shape"] == {"dp": 1, "tp": 1} and "backend gloo" in err.getvalue()
        assert not torch.distributed.is_initialized()

    def test_ntuple_train_then_eval(self, tmp_path, monkeypatch):
        real = nt.NTupleTrainConfig

        def tiny(**kw):
            return real(tuples=ntuple.TINY_2X3, **kw)

        monkeypatch.setattr(nt, "NTupleTrainConfig", tiny)
        self._run(["train", "--algo", "ntuple", "--updates", "2", "--batch-size", "8", "--unroll", "4", "--table-backend",
                   "torch", "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2", "--log-every", "1", "--device", "cpu"])
        monkeypatch.setattr(nt, "NTupleTrainConfig", real)
        out, err = self._run(["eval", "--algo", "ntuple", "--checkpoint-dir", str(tmp_path), "--depth", "0",
                              "--num-envs", "8", "--max-steps", "20", "--device", "cpu"])
        assert "restored step 2" in err
        params = Checkpointer(str(tmp_path)).restore_field("params")
        want = nt.evaluate_ntuple(
            params, real(tuples=ntuple.TINY_2X3, table_backend="torch"), depth=0, num_envs=8, num_steps=20, device="cpu"
        )
        assert json.loads(out.strip().splitlines()[-1]) == want


class TestFlops:
    def test_resnet_forward_flops_are_the_analytic_count(self):
        # Per board, 16 cells: the stem and 8 block convolutions count all
        # 9 taps (2 FLOPs each), then the two heads' dense layers.
        convs = 16 * 2 * 9 * (16 * 64 + 8 * 64 * 64)
        heads = 2 * (1024 * 64 + 64 * 4) + 2 * (1024 * 64 + 64 * 1)
        assert convs + heads == 9_994_880
        assert flops.model_forward_flops(nets.ResNetPolicy(64, 4)) == 9_994_880

    def test_value_loss_backward_flops(self):
        # The afterstate trainer's loss reads the value head only, so the
        # policy head gets no gradient: forward + backward is 2.944x the forward.
        model = nets.ResNetPolicy(64, 4)
        counter = FlopCounterMode(display=False)
        with counter:
            model(torch.zeros((8, 4, 4, 16), dtype=torch.bfloat16))[1].sum().backward()
        assert counter.get_total_flops() / 8 == 29_426_560

    def test_actor_critic_loss_backward_flops(self):
        # PPO's and A3C's losses read both heads: forward + backward is 3x the
        # forward less the stem's input gradient (16 * 2 * 9 * 16 * 64), and
        # the bf16 casts pass gradients to every float32 parameter.
        model = nets.ResNetPolicy(64, 4)
        counter = FlopCounterMode(display=False)
        with counter:
            logits, value = model(torch.zeros((8, 4, 4, 16), dtype=torch.bfloat16))
            (logits.sum() + value.sum()).backward()
        assert counter.get_total_flops() / 8 == 3 * 9_994_880 - 294_912 == 29_689_728
        assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())

    def test_actor_critic_flops_per_frame(self):
        fwd = 9_994_880
        assert flops.ppo_flops_per_frame(4, fwd) == 13 * fwd  # 1 acting forward + 4 epochs x 3
        assert flops.ppo_flops_per_frame(4, fwd, fwd) == 25 * fwd
        assert flops.a3c_flops_per_frame(fwd) == 4 * fwd

    def test_train_flops_and_mfu(self):
        per_frame = flops.train_flops_per_frame(1e7, rollout_forwards=4, reuse_passes=2)
        assert per_frame == 1e8
        assert flops.mfu(1e6, per_frame) == pytest.approx(1e14 / 989e12)
