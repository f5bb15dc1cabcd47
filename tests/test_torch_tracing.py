# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's spans and counters (``utils/profiling.py``): off they cost a
flag check and change nothing; on they nest as the layers do, leave every
result as it was, and land in the profiler's span table; the counters
count at the layer boundaries as the module counters they replaced did."""

from __future__ import annotations

import runpy
import time

import pytest
import torch

from rein48_tpu_torch.agents import ntuple
from rein48_tpu_torch.control import search
from rein48_tpu_torch.engine import fused, philox, vector
from rein48_tpu_torch.models import nets
from rein48_tpu_torch.ops import hbm_tables, tables
from rein48_tpu_torch.ops import ntuple_value as value_ops
from rein48_tpu_torch.train import common, evaluate
from rein48_tpu_torch.train import ntuple as ntuple_train
from rein48_tpu_torch.train import ppo as ppo_train
from rein48_tpu_torch.utils import profiling

torch.set_num_threads(1)

SMALL = (("channels", 8), ("num_blocks", 1), ("dtype", torch.float32))


def ppo_step(seed: int = 3):
    cfg = ppo_train.PPOConfig(batch_size=8, unroll_len=4, num_epochs=2, num_minibatches=2, model_kwargs=SMALL)
    state, model, opt = ppo_train.init_ppo(cfg, seed, device="cpu")
    return cfg, state, ppo_train.make_ppo_step(cfg, model, opt)


def by_name(trace) -> dict:
    out: dict = {}
    for s in trace.resolve():
        out.setdefault(s.name, []).append(s)
    return out


def test_a_disabled_span_reads_no_clock_and_is_one_shared_object(monkeypatch):
    def no_clock():
        raise AssertionError("a disabled span read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first, second = profiling.span("ppo.learn"), profiling.span("engine.step")
    assert first is second
    with first:
        with second:
            pass


def test_an_enabled_span_tree_has_parents_and_roots():
    with profiling.tracing() as trace:
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("b"):
                pass
        with profiling.span("d"):
            pass
    spans = trace.resolve()
    assert [(s.name, s.id, s.parent, s.root) for s in spans] == [
        ("a", 0, None, 0), ("b", 1, 0, 0), ("c", 2, 1, 0), ("b", 3, 0, 0), ("d", 4, None, 4),
    ]
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    assert profiling.span("a") is profiling.span("b")  # off again after the block


def test_on_the_cpu_the_device_time_is_the_host_time():
    with profiling.tracing() as trace:
        with profiling.span("a"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (s,) = trace.resolve()
    assert not trace.cuda and s.events is None
    assert s.device_ms == s.host_ms > 0


def test_tracing_blocks_do_not_nest():
    with profiling.tracing():
        with pytest.raises(RuntimeError, match="nest"):
            with profiling.tracing():
                pass


def test_a_span_closes_when_its_block_raises():
    with profiling.tracing() as trace:
        with pytest.raises(ValueError):
            with profiling.span("a"):
                raise ValueError("inside")
        with profiling.span("b"):
            pass
    assert [(s.name, s.parent) for s in trace.resolve()] == [("a", None), ("b", None)]


def test_ppo_update_spans_nest_as_its_layers():
    cfg, state, step = ppo_step()
    with profiling.tracing() as trace:
        env, batch, _ = step.rollout(state)
        step.learn(state, batch)
    spans = trace.resolve()
    named = by_name(trace)
    (rollout,), (learn,) = named["ppo.rollout"], named["ppo.learn"]
    steps = cfg.num_epochs * cfg.num_minibatches
    assert len(named["a3c.act"]) == cfg.unroll_len + 1 and len(named["engine.step"]) == cfg.unroll_len
    for s in named["a3c.act"] + named["engine.step"]:
        assert s.parent == rollout.id and s.root == rollout.id
    for name in ("ppo.forward", "ppo.backward", "optim.step"):
        assert len(named[name]) == steps
        for s in named[name]:
            assert s.parent == learn.id and s.root == learn.id
    # forward, backward and the optimizer step take turns, minibatch by minibatch
    order = [s.name for s in spans if s.parent == learn.id]
    assert order == ["ppo.forward", "ppo.backward", "optim.step"] * steps
    assert {s.name for s in spans} == {"ppo.rollout", "a3c.act", "engine.step", "ppo.learn", "ppo.forward",
                                       "ppo.backward", "optim.step"}


def test_tracing_leaves_a_ppo_update_bit_for_bit():
    def update(traced: bool):
        cfg, state, step = ppo_step(seed=11)
        if traced:
            with profiling.tracing():
                new, metrics = step(state)
        else:
            new, metrics = step(state)
        return new, metrics, step

    (a, ma, sa), (b, mb, sb) = update(False), update(True)
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(torch.as_tensor(ma[k]), torch.as_tensor(mb[k])), k
    for f in ("boards", "score", "steps", "counter"):
        assert torch.equal(torch.as_tensor(getattr(a.env, f)), torch.as_tensor(getattr(b.env, f))), f
    for (name, p), q in zip(sa.model.named_parameters(), sb.model.parameters()):
        assert torch.equal(p, q), name
    for m in sa.optimizer.moments:
        for x, y in zip(sa.optimizer.moments[m], sb.optimizer.moments[m]):
            assert torch.equal(x, y), m


def depth1_policy():
    model = nets.ResNetPolicy(8, 1, generator=torch.Generator().manual_seed(4)).eval()
    return evaluate._build_search_policy(1, model, "onehot", 0.997, "log2", 4)


@pytest.mark.parametrize("games", [1, 3])
def test_the_leaf_counter_counts_every_board_fed_to_the_tower(games):
    policy = depth1_policy()
    env = vector.reset_batch(5, games, "cpu")
    before = profiling.counters.get("search.leaf_boards", 0)
    with torch.inference_mode():
        policy(env.boards)
    assert profiling.counters["search.leaf_boards"] - before == games * 4 * search.CHANCE_BRANCH * 4


def test_a_depth1_move_spans_the_tree_and_its_leaves():
    policy = depth1_policy()
    env = vector.reset_batch(5, 2, "cpu")
    with profiling.tracing() as trace, torch.inference_mode():
        vector.step_autoreset(env, policy(env.boards))
    named = by_name(trace)
    (move,) = named["search.policy"]
    assert len(named["search.leaf"]) == search.CHANCE_BRANCH // 4
    assert all(s.parent == move.id and s.root == move.id for s in named["search.leaf"])
    (step,) = named["engine.step"]
    assert step.parent is None and step.start_ns >= move.end_ns
    # Off the card the move's one engine step is the plain step.
    assert trace.counters == {"search.leaf_boards": 2 * 4 * search.CHANCE_BRANCH * 4, "engine.step_plain": 1}


def test_tracing_yields_the_counters_change():
    profiling.count("tests.before", 5)
    with profiling.tracing() as trace:
        profiling.count("tests.before", 2)
        profiling.count("tests.new")
        assert trace.counters == {}  # filled when the block ends
    assert trace.counters == {"tests.before": 2, "tests.new": 1}


def test_snapshot_and_reset():
    profiling.count("tests.snap", 3)
    snap = profiling.snapshot()
    profiling.count("tests.snap")
    assert snap["tests.snap"] + 1 == profiling.counters["tests.snap"]
    profiling.reset()
    assert set(profiling.snapshot()) >= {"tests.snap"} and not any(profiling.snapshot().values())


def test_ntuple_update_spans_its_acting_steps_and_windows():
    cfg = ntuple_train.NTupleTrainConfig(tuples=ntuple.TINY_2X3, batch_size=4, steps_per_update=8, update_mode="delayed",
                                         delay_window=4, table_backend="torch")
    state = ntuple_train.init_ntuple(cfg, 2, "cpu")[0]
    step = ntuple_train.make_ntuple_step(cfg, "cpu")
    with profiling.tracing() as trace:
        step(state)
    named = by_name(trace)
    assert len(named["ntuple.act"]) == 8 and len(named["ntuple.apply"]) == 2
    acts = {s.id for s in named["ntuple.act"]}
    assert all(s.parent in acts for s in named["engine.step"]) and len(named["engine.step"]) == 8


def test_device_breakdown_tables_every_span_of_the_call():
    cfg, state, step = ppo_step()
    box = [state]

    def update():
        box[0] = step(box[0])[0]

    r = profiling.device_breakdown(update, warmup=0, reps=2)
    rows = {row["span"]: row for row in r["spans"]}
    assert list(rows) == ["ppo.rollout", "a3c.act", "engine.step", "ppo.learn", "ppo.forward", "ppo.backward",
                          "optim.step"]
    steps = cfg.num_epochs * cfg.num_minibatches
    assert rows["a3c.act"]["calls"] == cfg.unroll_len + 1 and rows["optim.step"]["calls"] == steps
    for row in rows.values():
        assert row["host_ms"] > 0 and row["device_ms"] == pytest.approx(row["host_ms"], abs=1e-5)
        assert row["launches"] == 0  # no card: no kernel launch
        assert 0 <= row["self_ms"] <= row["device_ms"] + 1e-6
    learn_children = sum(rows[k]["device_ms"] for k in ("ppo.forward", "ppo.backward", "optim.step"))
    assert rows["ppo.learn"]["self_ms"] == pytest.approx(rows["ppo.learn"]["device_ms"] - learn_children, abs=1e-4)


def test_the_script_runs_the_package_modules_main(monkeypatch):
    """``python -m rein48_tpu_torch.utils.profiling`` must trace in the module
    the port's spans check, not in a second copy named ``__main__``."""
    calls = []
    monkeypatch.setattr(profiling, "main", lambda: calls.append(profiling._trace))
    runpy.run_module("rein48_tpu_torch.utils.profiling", run_name="__main__")
    assert calls == [None]


@pytest.mark.parametrize("cold_capacity_rows, branch", [(16, "fast"), (1, "fallback")])
def test_cached_windows_count_by_branch(cold_capacity_rows, branch):
    net = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.SJ_2X4, backend="cached", prefix_rows=128,
                                                   cold_capacity_rows=cold_capacity_rows))
    g = torch.Generator().manual_seed(7)
    params = {k: torch.rand(v.shape, generator=g) if v.is_floating_point() else v for k, v in net.init_tc("cpu").items()}
    params = net.refresh_cache(params)
    boards = torch.randint(0, 8, (96, 4, 4), generator=g, dtype=torch.uint8)
    boards[48:] = boards[:48]
    err = torch.randn(96, generator=g)
    before = profiling.snapshot()
    net.td_apply_delayed(params, boards, err, 0.4, tc=True)
    changed = {k: v - before.get(k, 0) for k, v in profiling.counters.items() if v != before.get(k, 0)}
    assert changed == {f"ntuple.cached_{branch}": 2}  # one window per table


def _tables_gather():
    tables.mxu_gather(torch.arange(256.0), torch.tensor([3, 255], dtype=torch.int32))


def _tables_scatter():
    tables.mxu_scatter_stats(256, torch.tensor([3, 3], dtype=torch.int32), torch.ones(2))


def _cached_gather():
    rm = torch.arange(256, dtype=torch.int32)
    hbm_tables.cached_gather(torch.arange(256.0), rm[:2], rm[:1], torch.tensor([[3, 5, 7, 200]], dtype=torch.int32),
                             prefix_rows=1)


def _cached_scatter():
    hot = torch.arange(2, dtype=torch.int32)
    hbm_tables.cached_scatter_stats(hot, torch.tensor([1, 300], dtype=torch.int32), torch.ones(2), prefix_rows=2)


def _ntuple_value():
    net = ntuple.NTupleNetwork(ntuple.NTupleConfig(tuples=ntuple.TINY_2X3, backend="mxu"))
    net.value(net.init("cpu"), torch.zeros((2, 4, 4), dtype=torch.uint8))


def _rollout():
    fused.rollout_random_fused(vector.reset_batch(1, 4, "cpu"), 1, 2)


PLAIN_PATHS = {
    "tables.table_gather": _tables_gather, "tables.table_scatter": _tables_scatter,
    "hbm_tables.cached_gather": _cached_gather, "hbm_tables.cached_scatter": _cached_scatter,
    "ntuple_value.launches": _ntuple_value, "fused.rollout_launches": _rollout,
}


@pytest.mark.parametrize("name", list(PLAIN_PATHS))
def test_a_launch_counter_leaves_the_plain_path_uncounted(name):
    """The counters count kernel launches only: the CPU's plain versions
    move none, and the modules keep no count of their own."""
    before = profiling.snapshot()
    PLAIN_PATHS[name]()
    assert profiling.snapshot() == before
    module = {"tables": tables, "hbm_tables": hbm_tables, "ntuple_value": value_ops, "fused": fused}[name.split(".")[0]]
    assert not hasattr(module, "launches")
    assert f'profiling.count("{name}")' in open(module.__file__).read()


def test_optimizer_step_is_one_span():
    p = torch.nn.Parameter(torch.ones(3))
    opt = common.Optimizer("adam", 0.1, [p], max_grad_norm=0.5)
    with profiling.tracing() as trace:
        opt.step([torch.ones(3)])
    assert [s.name for s in trace.resolve()] == ["optim.step"]
    assert opt.count == 1 and not torch.equal(p.detach(), torch.ones(3))


def test_the_injected_words_step_is_one_engine_span():
    env = vector.reset_batch(3, 4, "cpu")
    bits = philox.step_words(env.seed, env.env_id, env.counter)[:, philox.SPAWN_RANK:]
    with profiling.tracing() as trace:
        a, _ = vector.step_autoreset_from_bits(env, torch.zeros(4, dtype=torch.long), bits)
        b, _ = vector.step_autoreset(env, torch.zeros(4, dtype=torch.long))
    assert [(s.name, s.parent) for s in trace.resolve()] == [("engine.step", None)] * 2
    assert torch.equal(a.boards, b.boards)
