from .adapt import adapt_rwmh_reference, fused_adapt_rwmh_sample
from .am import AmParams, am_sample_reference, am_step, fused_am_sample, welford_advance
from .barker import barker_sample_reference, barker_step, fused_barker_sample
from .common import (box_muller, philox4x32_reference, philox_uniforms, scale_block, step_noise,
                     uniform_from_bits)
from .chees import (CheesParams, chees_frozen_reference, chees_warmup_reference,
                    fused_chees_frozen_sample, fused_chees_warmup_block, halton_trips, vdc)
from .cholesky import chol_rank1_update, chol_rank1_update_batched
from .dr import dr_sample_reference, dr_step, fused_dr_sample, log1m_exp
from .dram import DramParams, dram_sample_reference, dram_step, fused_dram_sample
from .emcee import emcee_sample_reference, fused_emcee_sample
from .evidence import (fused_power_rwmh_sample, gaussian_prior_lp, power_rwmh_reference,
                       power_step)
from .ess import ess_sample_reference, ess_trips, fused_ess_sample
from .hmc import fused_hmc_sample, hmc_sample_reference, minv_column
from .hmc_adapt import DualAveraging, adaptive_hmc_reference, fused_adaptive_hmc_sample
from .mala import fused_mala_sample, mala_sample_reference
from .demc import (DemcParams, demc_half_move, demc_indices, demc_move, demc_sample_reference,
                   fused_demc_sample)
from .meads import MeadsParams, fused_meads_sample, max_eig_cols, meads_reference
from .mtm import (fused_mtm, fused_mtm_sample, mtm_reference, mtm_sample_reference, mtm_step,
                  streaming_logsumexp)
from .pcn import fused_pcn_sample, pcn_constants, pcn_sample_reference, pcn_step
from .ram import RamParams, fused_ram_sample, ram_sample_reference
from .rwmh import fused_rwmh, fused_rwmh_sample, rwmh_reference, rwmh_sample_reference
from .slice import fused_slice_sample, slice_sample_reference, slice_trips, unit_direction
from .tempering import (fused_tempering_sample, ladder_constants, tempering_sample_reference,
                        tempering_step)

# Every kernel wrapper, by its name in chip_smoke.py's report.
# Each call of one is the span ``kernel.<name>`` (utils/trace.py).
KERNEL_WRAPPERS = {
    "rwmh_sample": fused_rwmh_sample,
    "rwmh": fused_rwmh,
    "mala": fused_mala_sample,
    "ram": fused_ram_sample,
    "emcee": fused_emcee_sample,
    "adapt_rwmh": fused_adapt_rwmh_sample,
    "hmc": fused_hmc_sample,
    "adaptive_hmc": fused_adaptive_hmc_sample,
    "chees_warmup": fused_chees_warmup_block,
    "chees_frozen": fused_chees_frozen_sample,
    "meads": fused_meads_sample,
    "slice": fused_slice_sample,
    "ess": fused_ess_sample,
    "barker": fused_barker_sample,
    "pcn": fused_pcn_sample,
    "am": fused_am_sample,
    "dr": fused_dr_sample,
    "dram": fused_dram_sample,
    "mtm_sample": fused_mtm_sample,
    "mtm": fused_mtm,
    "tempering": fused_tempering_sample,
    "demc": fused_demc_sample,
    "evidence": fused_power_rwmh_sample,
}

__all__ = [
    "fused_power_rwmh_sample", "gaussian_prior_lp", "power_rwmh_reference", "power_step",
    "DemcParams", "demc_half_move", "demc_indices", "demc_move", "demc_sample_reference", "fused_demc_sample", "fused_mtm",
    "fused_mtm_sample", "fused_tempering_sample", "ladder_constants", "mtm_reference",
    "mtm_sample_reference", "mtm_step", "streaming_logsumexp", "tempering_sample_reference",
    "tempering_step",
    "AmParams", "DramParams", "am_sample_reference", "am_step", "dr_sample_reference",
    "dr_step", "dram_sample_reference", "dram_step", "fused_am_sample", "fused_dr_sample",
    "fused_dram_sample", "log1m_exp", "welford_advance",
    "barker_sample_reference", "barker_step", "box_muller", "ess_sample_reference",
    "ess_trips", "fused_barker_sample", "fused_ess_sample", "fused_pcn_sample",
    "fused_slice_sample", "pcn_constants", "pcn_sample_reference", "pcn_step",
    "philox_uniforms", "slice_sample_reference", "slice_trips", "unit_direction",
    "CheesParams", "MeadsParams", "chees_frozen_reference", "chees_warmup_reference",
    "fused_chees_frozen_sample", "fused_chees_warmup_block", "fused_meads_sample",
    "halton_trips", "max_eig_cols", "meads_reference", "vdc",
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
