"""Device-clock ms per PPO update of the engine's steps inside the rollout:
the ``engine.step`` spans under ``ppo.rollout``, in the program's traced
segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "engine.step", under="ppo.rollout")
