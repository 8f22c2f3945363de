"""``call_p95_s``: the 95th percentile of the wall time of all calls in the
window, each fenced by a synchronize."""
from portbench.window import percentile


def read(ctx):
    return None if ctx.window is None else percentile(ctx.window.durations(), 95.0)
