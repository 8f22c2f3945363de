from .adapt import adapt_rwmh_reference, fused_adapt_rwmh_sample
from .cholesky import chol_rank1_update, chol_rank1_update_batched
from .emcee import emcee_sample_reference, fused_emcee_sample
from .hmc import fused_hmc_sample, hmc_sample_reference, minv_column
from .hmc_adapt import DualAveraging, adaptive_hmc_reference, fused_adaptive_hmc_sample
from .mala import fused_mala_sample, mala_sample_reference
from .ram import RamParams, fused_ram_sample, ram_sample_reference
from .rwmh import (
    fused_rwmh,
    fused_rwmh_sample,
    philox4x32_reference,
    rwmh_reference,
    rwmh_sample_reference,
    scale_block,
    step_noise,
    uniform_from_bits,
)

# Every kernel wrapper, by its name in chip_smoke.py's report.
KERNEL_WRAPPERS = {
    "rwmh_sample": fused_rwmh_sample,
    "rwmh": fused_rwmh,
    "mala": fused_mala_sample,
    "ram": fused_ram_sample,
    "emcee": fused_emcee_sample,
    "adapt_rwmh": fused_adapt_rwmh_sample,
    "hmc": fused_hmc_sample,
    "adaptive_hmc": fused_adaptive_hmc_sample,
}

__all__ = [
    "DualAveraging", "adapt_rwmh_reference", "adaptive_hmc_reference",
    "fused_adapt_rwmh_sample", "fused_adaptive_hmc_sample", "fused_hmc_sample",
    "hmc_sample_reference", "minv_column",
    "KERNEL_WRAPPERS", "RamParams", "chol_rank1_update",
    "chol_rank1_update_batched", "emcee_sample_reference", "fused_emcee_sample",
    "fused_mala_sample", "fused_ram_sample", "fused_rwmh", "fused_rwmh_sample",
    "mala_sample_reference", "philox4x32_reference", "ram_sample_reference",
    "rwmh_reference", "rwmh_sample_reference", "scale_block", "step_noise",
    "uniform_from_bits",
]
