"""Device-clock ms per PPO update of the optimizer steps: the ``optim.step``
spans (``train/common.Optimizer.step``: clip by the global norm, Adam), in
the program's traced segment."""

from portbench import program_trace


def read(ctx):
    rec = program_trace.record(ctx)
    return None if rec is None else program_trace.per_unit_ms(rec, "optim.step")
