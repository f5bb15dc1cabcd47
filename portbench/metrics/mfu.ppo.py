"""Model operations of the PPO updates per second over the card's dense
bf16 peak, in %: env-steps/s of the window x (1 + 3 x epochs)
forward-equivalents x the forward's operations counted from shapes."""

from portbench import flops


def read(ctx):
    ppo, c = ctx.cell.traffic["ppo"], ctx.cell.config
    frames = ctx.window["units"] * ppo["batch_size"] * ppo["unroll_len"] / ctx.window["seconds"]
    per_frame = flops.ppo_per_frame(ppo["num_epochs"]) * flops.resnet_forward(c["channels"], c["num_blocks"])
    return 100.0 * frames * per_frame / flops.PEAK_BF16
