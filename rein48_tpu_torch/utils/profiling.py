# Copyright 2026 The rein48-tpu Authors.
# SPDX-License-Identifier: Apache-2.0
"""Where the device time goes (counterpart of ``utils/profiling.py``).

:func:`device_breakdown` runs a function under ``torch.profiler`` and
reports, per call: host wall time, device kernel time, the number of
kernel launches (the host's calls that launch a kernel,
``cudaLaunchKernel*`` and ``cuLaunchKernel*``), and the kernels that take
the most device time. Run as a script on a card, it profiles
one call of each main path of the port at the sizes ``chip_smoke.py``
drives (``rollout``; ResNet serving, ``serve``; one update of the SJ_2X4
n-tuple trainer per update mode and table backend and one step of n-tuple
depth-1 evaluation, ``ntuple``; one delayed update of the YEH_4X6 trainer
on ``"cached"`` and on ``"torch"``, ``cached``; one flagship afterstate-TD
update and each of its two phases, ``afterstate``; one flagship PPO update,
with and without the afterstate critic, and its phases, ``ppo``; one
flagship A3C update and its phases, ``a3c``; one learning update of the
DQN flagship and of DDPG at its defaults and their acting and learn phases,
``dqn``):

    python -m rein48_tpu_torch.utils.profiling [group ...]

and prints one JSON line per path, for the groups named (all by default),
with the table of the port's spans inside the profiled calls.

**Spans and counters.** The port marks its layer boundaries with
:func:`span` (a context manager: ``with profiling.span("ppo.learn"):``) and
counts work there with :func:`count` (``profiling.count("search.leaf_boards",
n)``). Spans cost one check of a module flag until :func:`tracing` turns them
on; each then records its name, its host start and end on the profiler's
time base (``time.time_ns``), its parent and its root span, a pair of CUDA
events on the current stream when there is a card, and enters
``torch.profiler.record_function`` so that a profiler session shows it as an
annotation. Counters are always on, one dict add each, in one registry
(:data:`counters`, :func:`snapshot`, :func:`reset`).

Beside them, the JAX package's hooks: :func:`trace` (a Chrome/Perfetto trace
of a block of code), :func:`force` (fetch one scalar, which waits for the
work that produces it) and :func:`enable_nan_debugging`.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# Counts at the port's layer boundaries by dotted name, "<module>.<what>":
# kernel launches (``tables.table_gather``, ``tables.table_scatter``,
# ``hbm_tables.cached_gather``, ``hbm_tables.cached_scatter``,
# ``ntuple_value.launches``, ``fused.rollout_launches``; never the plain
# versions), the "cached" backend's delayed windows by branch
# (``ntuple.cached_fast``, ``ntuple.cached_fallback``), the boards fed to
# the search's leaf evaluator (``search.leaf_boards``) and, per call of a
# learned player on the card, whether it ran eagerly, captured its CUDA
# graph or replayed it (``replay.eager``, ``replay.captures``,
# ``replay.replays``; ``control/search.Replayed``). A name appears at its
# first count.
counters: dict = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    counters[name] = counters.get(name, 0) + n


def snapshot() -> dict:
    """A copy of the counters as they stand."""
    return dict(counters)


def reset() -> None:
    """Set every counter to 0."""
    for name in counters:
        counters[name] = 0


@dataclasses.dataclass
class SpanRecord:
    """One span: ``start_ns``/``end_ns`` on the host (``time.time_ns``, the
    profiler's time base), ``parent`` and ``root`` as span ids (the root's
    is its own), and ``device_ms``, the time between its CUDA events on the
    device's clock (the host's duration where there is no card) once
    :meth:`Trace.resolve` has read it."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int = 0
    end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


# Timing events no resolved span holds any more.
_EVENT_POOL: list = []


def _event():
    return _EVENT_POOL.pop() if _EVENT_POOL else torch.cuda.Event(enable_timing=True)


class Trace:
    """What a :func:`tracing` block recorded: ``spans`` in order of entry,
    and ``counters``, the counters' change over the block (the names that
    changed)."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.cuda = torch.cuda.is_available()
        self._open: list = []

    def resolve(self) -> list:
        """The spans with their device-clock durations. Read after the
        device has been synced: no span waits for the device, so the end of
        one the device has not reached yet is waited for here."""
        for s in self.spans:
            if s.events is not None and s.end_ns:
                start, end = s.events
                end.synchronize()
                s.device_ms = start.elapsed_time(end)
                s.events = None
                _EVENT_POOL.extend((start, end))
        return self.spans


class _Span:
    __slots__ = ("trace", "name", "record", "annotation")

    def __init__(self, trace: Trace, name: str):
        self.trace, self.name = trace, name

    def __enter__(self) -> SpanRecord:
        t = self.trace
        parent = t._open[-1] if t._open else None
        i = len(t.spans)
        rec = SpanRecord(self.name, i, None if parent is None else parent.id, i if parent is None else parent.root)
        t.spans.append(rec)
        t._open.append(rec)
        rec.start_ns = time.time_ns()
        self.record, self.annotation = rec, record_function(self.name)
        self.annotation.__enter__()
        if t.cuda:
            rec.events = (_event(), _event())
            rec.events[0].record()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        if rec.events is not None:
            rec.events[1].record()
        self.annotation.__exit__(*exc)
        rec.end_ns = time.time_ns()
        if rec.events is None:
            rec.device_ms = rec.host_ms
        self.trace._open.pop()
        return False


# The record of the open tracing() block; None while spans are off.
_trace: Optional[Trace] = None
_OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether spans are on: a :func:`tracing` block is open."""
    return _trace is not None


def span(name: str):
    """A span named after the port's module and step (``"engine.step"``).
    Off (the default) it is one shared context that does nothing."""
    if _trace is None:
        return _OFF
    return _Span(_trace, name)


@contextlib.contextmanager
def tracing() -> Iterator[Trace]:
    """Turn spans on for the block; yields its :class:`Trace`, whose
    ``counters`` hold the counters' change once the block ends."""
    global _trace
    if _trace is not None:
        raise RuntimeError("tracing() blocks do not nest")
    trace, before = Trace(), snapshot()
    _trace = trace
    try:
        yield trace
    finally:
        _trace = None
        trace.counters = {k: v - before.get(k, 0) for k, v in counters.items() if v != before.get(k, 0)}


def span_table(trace: Trace, prof, calls: int) -> list:
    """Per span name, in order of first entry, per one of ``calls`` calls:
    the spans, the host ms, the device ms, the device self ms (less its
    direct children's device ms) and the host's kernel launches inside the
    spans, from ``prof``, a finished ``profile`` session over the block."""
    spans = trace.resolve()
    child_ms = [0.0] * len(spans)
    for s in spans:
        if s.parent is not None:
            child_ms[s.parent] += s.device_ms
    launch_ns = sorted(_launch_starts(prof))
    rows: dict = {}
    for s in spans:
        row = rows.setdefault(
            s.name, {"span": s.name, "calls": 0, "host_ms": 0.0, "device_ms": 0.0, "self_ms": 0.0, "launches": 0}
        )
        row["calls"] += 1
        row["host_ms"] += s.host_ms
        row["device_ms"] += s.device_ms
        row["self_ms"] += s.device_ms - child_ms[s.id]
        row["launches"] += bisect.bisect_right(launch_ns, s.end_ns) - bisect.bisect_left(launch_ns, s.start_ns)
    for row in rows.values():
        for k in row:
            if k != "span":
                row[k] = round(row[k] / calls, 6)
    return list(rows.values())


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (host activity, and the
    card's when there is one) into ``<log_dir>/trace.json``, a Chrome trace
    that Perfetto and ``chrome://tracing`` open."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debugging() -> None:
    """Turn on autograd's anomaly mode, the closest switch to JAX's
    ``jax_debug_nans``.

    It differs: JAX checks the output of every primitive, forward and
    backward, for NaNs and re-runs the offending one un-jitted; anomaly mode
    checks only the gradients of backward functions, raises on the first
    NaN there with the traceback of the forward op that made it, and slows
    every backward pass. A NaN made in a forward pass or outside autograd
    goes unnoticed until a gradient carries it.
    """
    torch.autograd.set_detect_anomaly(True)


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor leaf of a pytree of dicts, sequences and dataclasses."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        children = x.values()
    elif isinstance(x, (list, tuple)):
        children = x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        children = (getattr(x, f.name) for f in dataclasses.fields(x))
    else:
        return None
    for child in children:
        leaf = _first_tensor(child)
        if leaf is not None:
            return leaf
    return None


def force(x) -> float:
    """Fetch one scalar from the first tensor leaf of a pytree, which waits
    for the work that produces it."""
    leaf = _first_tensor(x)
    if leaf is None:
        raise ValueError("no tensor in the pytree")
    return float(leaf.reshape(-1)[0])


# Host calls that launch one kernel each, by the runtime or the driver API.
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def kernel_times(prof) -> tuple[dict, int]:
    """``({kernel: [device µs, calls]}, launch calls)`` of a finished
    ``profile`` session: each device event with a duration (kernels, and
    the runtime's copies and fills) summed by name, and the host's calls
    that launch a kernel. These are the sums ``prof.key_averages()`` gives,
    read from the session's raw events: ``key_averages`` first builds a
    Python object per event, which takes tens of seconds for an update of
    50-80 k launches. Spans' annotations, which the session also draws on
    the device's timeline, are no work and are left out."""
    kernels: dict = {}
    launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        device = e.device_type().name
        if device == "CPU":
            launches += e.name().startswith(_LAUNCH_CALLS)
        elif device == "CUDA" and e.duration_ns() > 0:
            entry = kernels.setdefault(e.name(), [0.0, 0])
            entry[0] += e.duration_ns() / 1e3
            entry[1] += 1
    return kernels, launches


def _launch_starts(prof) -> list:
    """Host start times (ns) of a finished session's kernel-launch calls."""
    return [
        e.start_ns() for e in prof.profiler.kineto_results.events()
        if e.device_type().name == "CPU" and e.name().startswith(_LAUNCH_CALLS)
    ]


def device_breakdown(fn, *, warmup: int = 1, reps: int = 3, top: int = 6) -> dict:
    """Profile ``reps`` calls of ``fn()`` after ``warmup`` calls, with spans
    on: ``spans`` is their :func:`span_table` per call. Without a card the
    session holds the host's events alone."""
    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    for _ in range(warmup):
        fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with tracing() as trace, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels, launch_calls = kernel_times(prof)
    device_ms = sum(us for us, _ in kernels.values()) / 1e3 / reps
    ranked = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)
    return {
        "wall_ms": round(wall_ms, 4),
        "device_ms": round(device_ms, 6),
        "launches": launch_calls // reps,
        "top": [
            {"kernel": name[:80], "ms": round(us / 1e3 / reps, 6), "calls": calls // reps}
            for name, (us, calls) in ranked[:top]
        ],
        "spans": span_table(trace, prof, reps),
    }


def main() -> None:
    profilers = {
        "rollout": _profile_rollout, "serve": _profile_serve, "ntuple": _profile_ntuple,
        "cached": _profile_cached, "afterstate": _profile_afterstate, "ppo": _profile_ppo, "a3c": _profile_a3c,
        "dqn": _profile_dqn,
    }
    groups = sys.argv[1:] or list(profilers)
    unknown = set(groups) - set(profilers)
    if unknown:
        raise SystemExit(f"unknown groups {sorted(unknown)}; choose from {list(profilers)}")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    out = {}
    for group, profile_group in profilers.items():
        if group in groups:
            profile_group(dev, out)
    for name, r in out.items():
        print(json.dumps({"path": name, "card": card, **r}))


def _profile_rollout(dev, out) -> None:
    from rein48_tpu_torch.engine import fused, vector

    state = vector.reset_batch(0, 65536, dev)
    out["rollout B=65536 T=2048"] = device_breakdown(lambda: fused.rollout_random_fused(state, 1, 2048))


def _profile_serve(dev, out) -> None:
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.models import nets
    from rein48_tpu_torch.train import evaluate

    model = nets.ResNetPolicy(64, 4, generator=torch.Generator().manual_seed(20260)).to(dev).eval()
    for depth, envs, chunk in ((0, 1024, None), (1, 256, 4)):
        policy = evaluate._build_search_policy(depth, model, "onehot", 0.99, "log2", chunk)
        st = vector.reset_batch(123, envs, dev)

        @torch.inference_mode()
        def step(policy=policy, st=st):
            vector.step_autoreset(st, policy(st.boards))

        out[f"serve depth={depth} envs={envs} chance_chunk={chunk} (one step)"] = device_breakdown(step)


def _profile_ntuple(dev, out) -> None:
    from rein48_tpu_torch.agents import ntuple
    from rein48_tpu_torch.engine import vector
    from rein48_tpu_torch.train import ntuple as nt

    trained = None
    for backend in ("mxu", "torch"):
        for mode in ("step", "delayed"):
            cfg = nt.NTupleTrainConfig(
                tuples=ntuple.SJ_2X4, batch_size=1024, steps_per_update=128, update_mode=mode, table_backend=backend
            )
            box = list(nt.init_ntuple(cfg, 0, dev))
            step = nt.make_ntuple_step(cfg, dev)

            def update(box=box, step=step):
                box[0] = step(box[0])[0]

            name = f"ntuple train {mode} backend={backend} B=1024 T=128 (one update)"
            out[name] = device_breakdown(update, warmup=2, reps=2, top=8)
            if (backend, mode) == ("mxu", "step"):
                trained = box[0]
    policy = nt._get_ntuple_policy(nt.NTupleTrainConfig(tuples=ntuple.SJ_2X4).network_config(dev), 1, 4)
    st = vector.reset_batch(123, 256, dev)

    @torch.no_grad()
    def ntuple_step(st=st):
        vector.step_autoreset(st, policy(trained.params, st.boards))

    out["ntuple eval depth=1 envs=256 chance_chunk=4 backend=mxu (one step)"] = device_breakdown(ntuple_step)


def _profile_cached(dev, out) -> None:
    from rein48_tpu_torch.train import ntuple as nt

    # The flagship's tables (4 x 16.7M entries) with the cached defaults
    # (2048 prefix rows), two updates in and refreshed from their heat.
    for backend in ("cached", "torch"):
        cfg = nt.NTupleTrainConfig(batch_size=1024, steps_per_update=128, update_mode="delayed", table_backend=backend)
        net = nt.get_network(cfg.network_config(dev))
        state = nt.train_ntuple(cfg, 2, seed=0, device=dev)[0]
        box = [dataclasses.replace(state, params=net.refresh_cache(state.params))]
        del state
        step = nt.make_ntuple_step(cfg, dev)

        def update(box=box, step=step):
            box[0] = step(box[0])[0]

        before = snapshot()
        r = device_breakdown(update, warmup=1, reps=2, top=8)
        r["cached_windows"] = {k: counters.get(f"ntuple.cached_{k}", 0) - before.get(f"ntuple.cached_{k}", 0)
                               for k in ("fast", "fallback")}
        out[f"ntuple train delayed backend={backend} YEH_4X6 B=1024 T=128 (one update)"] = r
        del box


def _profile_afterstate(dev, out) -> None:
    from rein48_tpu_torch.train import afterstate

    # The flagship configuration (examples/train_afterstate_td_tpu.py:49-60):
    # B=8192, T=32, ResNet 64x4 in bf16, adam, 2 epochs x 4 minibatches.
    cfg = afterstate.AfterstateTDConfig(lr_decay_updates=100)
    state, model, opt = afterstate.init_afterstate_td(cfg, 0, dev)
    _profile_phases("afterstate train B=8192 T=32 resnet 64x4 bf16", state, afterstate.make_afterstate_td_step(cfg, model, opt), out)


def _profile_phases(name, state, step, out) -> None:
    """One update of ``step`` and each of its two phases."""
    box = [state]

    def update():
        box[0] = step(box[0])[0]

    out[f"{name} (one update)"] = device_breakdown(update, warmup=1, reps=2, top=8)
    batch = step.rollout(box[0])[1]
    out[f"{name} (rollout phase)"] = device_breakdown(lambda: step.rollout(box[0]), warmup=0, reps=2, top=8)
    out[f"{name} (learn phase)"] = device_breakdown(lambda: step.learn(box[0], batch), warmup=0, reps=2, top=8)


def _profile_ppo(dev, out) -> None:
    from rein48_tpu_torch.train import ppo

    # The flagship configurations (examples/train_ppo_flagship_tpu.py:42-52,
    # examples/train_ppo_afterstate_tpu.py:51-67): B=8192, T=32, ResNet 64x4
    # in bf16, 4 epochs x 4 minibatches; the second adds the afterstate critic.
    flagship = ppo.PPOConfig(
        batch_size=8192, gamma=0.997, lr_decay_updates=8000, entropy_beta_final=0.002, entropy_decay_updates=6400
    )
    critic = ppo.PPOConfig(
        batch_size=8192, gamma=0.997, learning_rate=1.2e-4, lr_decay_updates=6000, entropy_beta=0.003,
        entropy_beta_final=0.001, entropy_decay_updates=4800, afterstate_critic=True,
    )
    for name, cfg in (("ppo train", flagship), ("ppo+critic train", critic)):
        state, model, opt = ppo.init_ppo(cfg, 0, dev)
        _profile_phases(f"{name} B=8192 T=32 resnet 64x4 bf16", state, ppo.make_ppo_step(cfg, model, opt, state.after_model), out)
        del state, model, opt


def _profile_a3c(dev, out) -> None:
    from rein48_tpu_torch.train import a3c

    # The flagship configuration (examples/train_a3c_flagship_tpu.py:43-54).
    cfg = a3c.A3CConfig(batch_size=8192, gamma=0.997, lr_decay_updates=12000, entropy_beta_final=0.002, entropy_decay_updates=9600)
    state, model, opt = a3c.init_a3c(cfg, 0, dev)
    _profile_phases("a3c train B=8192 T=32 resnet 64x4 bf16", state, a3c.make_a3c_step(cfg, model, opt), out)


def _profile_replay(name, state, step, out) -> None:
    """One learning update of a replay trainer, after enough updates to open
    its learn gate, and each of its two phases."""
    cfg = step.config
    per_update = cfg.num_envs * getattr(cfg, "acting_steps_per_update", 1)
    for _ in range(-(-min(cfg.min_replay_before_learn, cfg.replay_capacity) // per_update)):
        state = step(state)[0]
    box = [state]

    def update():
        box[0] = step(box[0])[0]

    out[f"{name} (one learning update)"] = device_breakdown(update, warmup=1, reps=2, top=8)
    acted = step.act(box[0])
    out[f"{name} (acting phase)"] = device_breakdown(lambda: step.act(box[0]), warmup=0, reps=2, top=8)
    out[f"{name} (learn phase)"] = device_breakdown(lambda: step.learn(box[0], acted[1]), warmup=0, reps=2, top=8)


def _profile_dqn(dev, out) -> None:
    from rein48_tpu_torch.train import ddpg, dqn

    # The DQN flagship (examples/train_dqn_tpu.py:45-51): 4,096 envs, ResNet
    # 64x4 bf16, two acting steps per update, 2**20 slots, batch 8,192; then
    # DDPGConfig()'s defaults.
    cfg = dqn.DQNConfig(num_envs=4096, model="resnet", acting_steps_per_update=2, epsilon_decay_steps=10_000_000, epsilon_end=0.03)
    state, model, opt = dqn.init_dqn(cfg, 0, dev)
    _profile_replay("dqn train 4096 envs x 2 steps resnet 64x4 bf16, batch 8192", state,
                    dqn.make_dqn_step(cfg, model, state.target_model, opt), out)
    del state, model, opt
    dcfg = ddpg.DDPGConfig()
    state = ddpg.init_ddpg(dcfg, 0, dev)[0]
    _profile_replay("ddpg train 2048 envs, batch 4096", state, ddpg.make_ddpg_step(dcfg, state), out)


if __name__ == "__main__":
    # Run as a script this file is a second module, "__main__"; the port's
    # spans and counters live in the package's copy, so run that one's main.
    from rein48_tpu_torch.utils import profiling

    profiling.main()
