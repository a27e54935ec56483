from .background import Cosmology
from .massdef import MassDef
from .concentration import ConcentrationConstant, ConcentrationDiemer15
from .power import eh98_transfer, sigma_tophat

__all__ = ["Cosmology", "MassDef", "ConcentrationConstant",
           "ConcentrationDiemer15", "eh98_transfer", "sigma_tophat"]
