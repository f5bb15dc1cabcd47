"""Device-clock ms per PPO update of the minibatch gradients: the
``ppo.backward`` spans (``torch.autograd.grad`` in ``PPOStep.learn``), in the
program's traced segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "ppo.backward")
