"""``host_share.<e2e>``: the share of the ``sample()`` span (synchronized at
its end, the summary left out) in which no kernel of the port runs: the
front end and the fused engine's host work between launches."""
from portbench.readers import host_share, is_port_kernel


def read(ctx):
    return host_share(ctx, "sample", is_port_kernel)
