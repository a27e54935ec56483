from .shell import (DefaultRunner, BaryonifyShell, PaintProfilesShell,
                    PaintProfilesAnisShell)
from .grid import DefaultRunnerGrid, BaryonifyGrid, PaintProfilesGrid

__all__ = ["DefaultRunner", "BaryonifyShell", "PaintProfilesShell",
           "PaintProfilesAnisShell", "DefaultRunnerGrid", "BaryonifyGrid",
           "PaintProfilesGrid"]
