"""nldsc_tpu_torch: the PyTorch/CUDA port of nldsc-tpu.

* ``estimate_lds`` — additive (L2) and dominance (L2D) LD scores from a
  PLINK ``.bed/.bim/.fam``, in core on one device, through the fused
  symmetric int8 kernel (``csrc/ld_sym.cu``) on an NVIDIA GPU or its
  plain PyTorch twin on the CPU.

The package imports torch and numpy, never JAX or ``nldsc_tpu``.
"""

from .ld.pipeline import estimate_lds
from .version import __version__

__all__ = ["estimate_lds", "__version__"]
