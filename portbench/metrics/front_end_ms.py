"""``front_end_ms.<e2e>``: the host milliseconds per traced call inside the
program's ``sample`` spans (the front end, the fused dispatch and the kernel's
enqueue), without the kernel's device time or the benchmark's synchronize."""
from portbench.program_spans import duration_ns, spans_by_call


def read(ctx):
    calls = spans_by_call(ctx)
    samples = [s for _, inside in calls for s in inside if s.name == "sample"]
    return None if not samples else sum(map(duration_ns, samples)) * 1e-6 / len(calls)
