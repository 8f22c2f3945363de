from .rwmh import (
    CUDA_DENSITIES,
    fused_rwmh,
    fused_rwmh_sample,
    philox4x32_reference,
    rwmh_reference,
    rwmh_sample_reference,
    scale_block,
    step_noise,
    uniform_from_bits,
)

__all__ = [
    "CUDA_DENSITIES", "fused_rwmh", "fused_rwmh_sample", "philox4x32_reference",
    "rwmh_reference", "rwmh_sample_reference", "scale_block", "step_noise",
    "uniform_from_bits",
]
