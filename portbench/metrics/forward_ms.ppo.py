"""Device-clock ms per PPO update of the minibatch forwards and losses: the
``ppo.forward`` spans (``PPOStep.minibatch_loss``), in the program's traced
segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "ppo.forward")
