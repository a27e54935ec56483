"""Halo-profile families, in the JAX package's layout: Schneider19 and
the thermodynamic profiles at top level; Arico20, Mead20 and Battaglia
as namespaced modules."""

from .base import HaloProfile, CombinedProfile
from .schneider19 import (model_params, SchneiderProfiles, DarkMatter,
                          TwoHalo, Stars, Gas, ShockedGas,
                          CollisionlessMatter, DarkMatterOnly,
                          DarkMatterBaryon)
from .thermodynamic import (Pressure, NonThermalFrac, NonThermalFracGreen20,
                            Temperature, ThermalSZ, ElectronPressure,
                            GasNumberDensity, XrayLuminosity)
from . import schneider19 as Schneider19
from . import thermodynamic as Thermodynamic
from . import arico20 as Arico20
from . import mead20 as Mead20
from . import battaglia as Battaglia

__all__ = ["HaloProfile", "CombinedProfile", "model_params",
           "SchneiderProfiles", "DarkMatter", "TwoHalo", "Stars", "Gas",
           "ShockedGas", "CollisionlessMatter", "DarkMatterOnly",
           "DarkMatterBaryon", "Pressure", "NonThermalFrac",
           "NonThermalFracGreen20", "Temperature", "ThermalSZ",
           "ElectronPressure", "GasNumberDensity", "XrayLuminosity",
           "Schneider19", "Thermodynamic", "Arico20", "Mead20", "Battaglia"]
