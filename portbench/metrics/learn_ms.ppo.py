"""Mean host-clock span around ``PPOStep.learn``, closed by a device sync, in ms."""


def read(ctx):
    spans = ctx.spans.get("learn")
    return 1e3 * sum(spans) / len(spans) if spans else None
