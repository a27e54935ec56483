from .shell import DefaultRunner, BaryonifyShell

__all__ = ["DefaultRunner", "BaryonifyShell"]
