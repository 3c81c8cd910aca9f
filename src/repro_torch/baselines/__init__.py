"""The paper's comparison baselines (:mod:`repro_torch.baselines.vc`)."""
from . import vc

__all__ = ["vc"]
