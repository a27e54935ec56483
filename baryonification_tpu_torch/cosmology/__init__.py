from .background import Cosmology
from .massdef import MassDef, mass_translator
from .concentration import (ConcentrationConstant, ConcentrationDiemer15,
                            ConcentrationDuffy08)
from .power import eh98_transfer, halofit_pk, sigma_tophat

__all__ = ["Cosmology", "MassDef", "mass_translator",
           "ConcentrationConstant", "ConcentrationDiemer15",
           "ConcentrationDuffy08", "eh98_transfer", "halofit_pk",
           "sigma_tophat"]
