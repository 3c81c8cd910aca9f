from .schema import BatchIterStats, IterStats

__all__ = ["BatchIterStats", "IterStats"]
