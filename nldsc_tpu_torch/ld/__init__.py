from .pipeline import estimate_lds

__all__ = ["estimate_lds"]
