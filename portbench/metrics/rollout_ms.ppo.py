"""Mean host-clock span around ``PPOStep.rollout``, closed by a device sync, in ms."""


def read(ctx):
    spans = ctx.spans.get("rollout")
    return 1e3 * sum(spans) / len(spans) if spans else None
