"""Halo-profile families (the Schneider19 family so far)."""

from .base import HaloProfile, CombinedProfile
from .schneider19 import (model_params, SchneiderProfiles, DarkMatter,
                          TwoHalo, Stars, Gas, CollisionlessMatter,
                          DarkMatterOnly, DarkMatterBaryon)
from . import schneider19 as Schneider19

__all__ = ["HaloProfile", "CombinedProfile", "model_params",
           "SchneiderProfiles", "DarkMatter", "TwoHalo", "Stars", "Gas",
           "CollisionlessMatter", "DarkMatterOnly", "DarkMatterBaryon",
           "Schneider19"]
