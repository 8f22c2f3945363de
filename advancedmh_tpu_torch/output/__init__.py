from .bundle import (
    StructArray,
    bundle_chains,
    bundle_namedtuples,
    bundle_structarray,
    chainscat,
)
from .chains import Chains

__all__ = [
    "Chains", "StructArray", "bundle_chains", "bundle_namedtuples",
    "bundle_structarray", "chainscat",
]
