"""nldsc_tpu_torch: the PyTorch/CUDA port of nldsc-tpu.

* ``estimate_lds`` — additive (L2) and dominance (L2D) LD scores from a
  PLINK ``.bed/.bim/.fam``, in core or streaming on one device, plain or
  partitioned by an annotation file, through the fused symmetric int8
  kernels (``csrc/ld_sym.cu``, ``csrc/split_corr.cu``) on an NVIDIA GPU
  or their plain PyTorch twins on the CPU.
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
