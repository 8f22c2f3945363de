"""``mfu.<e2e>``: the float32 operations the traced calls' kernels need (the
rooflines' counts) over the calls' wall time and 67 TFLOP/s."""
from portbench.readers import mfu


def read(ctx):
    return mfu(ctx)
