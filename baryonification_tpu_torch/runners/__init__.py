from .shell import (DefaultRunner, BaryonifyShell, PaintProfilesShell,
                    PaintProfilesAnisShell)
from .grid import (DefaultRunnerGrid, BaryonifyGrid, PaintProfilesGrid,
                   PaintProfilesAnisGrid)
from .snapshot import DefaultRunnerSnapshot, BaryonifySnapshot

__all__ = ["DefaultRunner", "BaryonifyShell", "PaintProfilesShell",
           "PaintProfilesAnisShell", "DefaultRunnerGrid", "BaryonifyGrid",
           "PaintProfilesGrid", "PaintProfilesAnisGrid",
           "DefaultRunnerSnapshot",
           "BaryonifySnapshot"]
