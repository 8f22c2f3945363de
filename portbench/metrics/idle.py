"""``idle.<e2e>``: the share of the traced window in which no device
operation runs."""


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.trace.window()
    return 100.0 * (1.0 - ctx.trace.busy_us(lo, hi) / (hi - lo))
