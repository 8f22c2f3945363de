"""``ess_per_s``: the ESS of every call completed in the window (each
call's smallest ESS over the parameters, from its own ``summary()``), over
the window's measured seconds."""


def read(ctx):
    return None if ctx.window is None else ctx.window.rate("ess")
