"""``host_syncs.<e2e>``: the program's host syncs (its ``sync.<site>``
spans: a host read of device data, or a blocking copy to the device) per
traced call."""
from portbench.program_spans import spans_by_call


def read(ctx):
    calls = spans_by_call(ctx)
    if not calls:
        return None
    return sum(s.name.startswith("sync.") for _, inside in calls for s in inside) / len(calls)
