from .schema import IterStats

__all__ = ["IterStats"]
