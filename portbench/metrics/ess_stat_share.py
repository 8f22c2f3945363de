"""``ess_stat_share.<e2e>``: the share of the program's ``summary`` spans
spent in their ``summary.ess`` and ``summary.mcse`` spans (the two FFT ESS
passes a parameter), by the host clock, in %."""
from portbench.program_spans import duration_ns, spans_by_call

ESS_PASSES = ("summary.ess", "summary.mcse")


def read(ctx):
    spans = [s for _, inside in spans_by_call(ctx) for s in inside]
    total = sum(duration_ns(s) for s in spans if s.name == "summary")
    part = sum(duration_ns(s) for s in spans if s.name in ESS_PASSES)
    return None if total <= 0 else 100.0 * part / total
