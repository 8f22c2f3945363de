"""``setup_s``: from the start of the process to the start of the window:
imports, the kernels' build or load, the data and model, the warm-up calls."""


def read(ctx):
    return ctx.setup_s
