from .shell import DefaultRunner, BaryonifyShell, PaintProfilesShell

__all__ = ["DefaultRunner", "BaryonifyShell", "PaintProfilesShell"]
