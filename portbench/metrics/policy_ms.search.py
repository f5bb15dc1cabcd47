"""Mean host-clock span around the expectimax policy call, closed by a
device sync, in ms."""


def read(ctx):
    spans = ctx.spans.get("policy")
    return 1e3 * sum(spans) / len(spans) if spans else None
