"""PPO env-steps per second: batch x unroll x the updates completed in the
window, over the window (each update ended by a device sync)."""


def read(ctx):
    ppo = ctx.cell.traffic["ppo"]
    return ctx.window["units"] * ppo["batch_size"] * ppo["unroll_len"] / ctx.window["seconds"]
