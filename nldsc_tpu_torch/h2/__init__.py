from .pipeline import estimate_h2

__all__ = ["estimate_h2"]
