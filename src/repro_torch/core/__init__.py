from . import monoid
from .cost import CostModel
from .engine import Engine
from .program import VertexProgram

__all__ = ["monoid", "CostModel", "Engine", "VertexProgram"]
