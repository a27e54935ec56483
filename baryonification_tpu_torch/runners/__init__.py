from .shell import DefaultRunner, BaryonifyShell, PaintProfilesShell
from .grid import DefaultRunnerGrid, BaryonifyGrid, PaintProfilesGrid

__all__ = ["DefaultRunner", "BaryonifyShell", "PaintProfilesShell",
           "DefaultRunnerGrid", "BaryonifyGrid", "PaintProfilesGrid"]
