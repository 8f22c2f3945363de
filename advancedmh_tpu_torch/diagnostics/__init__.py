from .ess import ess, ess_bulk, ess_tail, mcse, rhat, rhat_rank

__all__ = ["ess", "ess_bulk", "ess_tail", "mcse", "rhat", "rhat_rank"]
