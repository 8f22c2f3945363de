"""``rwmh_sample_roofline.<e2e>``: the bound of ``amh::rwmh_sample_kernel`` at the traced
calls' shapes (``portbench/bounds``) over its traced device time."""
from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "amh::rwmh_sample_kernel")
