"""``summary_share.<e2e>``: the share of a call's time, by the host clock,
spent in ``to_chains()`` + ``summary()`` (the benchmark's span ``summary``),
over the traced calls."""
from portbench.readers import span_share


def read(ctx):
    return span_share(ctx, "summary")
