"""Façade mirroring the reference's ``nldsc/routines.py`` import surface."""

from .h2.pipeline import estimate_h2
from .ld.pipeline import estimate_lds

__all__ = ["estimate_lds", "estimate_h2"]
