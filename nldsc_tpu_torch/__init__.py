"""nldsc_tpu_torch: the PyTorch/CUDA port of nldsc-tpu.

* ``estimate_lds`` — additive (L2) and dominance (L2D) LD scores from a
  PLINK ``.bed/.bim/.fam``, in core on one device, through the fused
  symmetric int8 kernel (``csrc/ld_sym.cu``) on an NVIDIA GPU or its
  plain PyTorch twin on the CPU.
* ``estimate_h2`` — additive and dominance heritability from GWAS
  summary statistics and those LD scores: the float64 LD-score
  regression and block jackknife on a CUDA device or the CPU.

The package imports torch and numpy (and scipy for ``h2``), never JAX,
``nldsc_tpu`` or pandas.
"""

from .h2.pipeline import estimate_h2
from .ld.pipeline import estimate_lds
from .version import __version__

__all__ = ["estimate_lds", "estimate_h2", "__version__"]
