from .background import Cosmology, CosmologyDevice, cosmology_device
from .massdef import MassDef, mass_translator
from .concentration import (ConcentrationConstant, ConcentrationDiemer15,
                            ConcentrationDuffy08)
from .power import eh98_transfer, halofit_pk, sigma_tophat

__all__ = ["Cosmology", "CosmologyDevice", "cosmology_device", "MassDef", "mass_translator",
           "ConcentrationConstant", "ConcentrationDiemer15",
           "ConcentrationDuffy08", "eh98_transfer", "halofit_pk",
           "sigma_tophat"]
