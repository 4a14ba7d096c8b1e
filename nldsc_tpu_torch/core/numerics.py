"""Elementwise float operations whose CPU result must not depend on ATen's
CPU math library.

ATen computes ``torch.sqrt`` (and ``torch.pow(x, 0.5)``) of a float32 or
float64 CPU tensor with MKL VML (``vmsSqrt``/``vmdSqrt`` in its HA
mode).  That has two faults:

* HA is accurate to within 1 ulp, not correctly rounded: on an AVX-512
  CPU it differs from the IEEE square root on about 0.5% of inputs.
* VML caches the CPU type in a static with two unsynchronised stores:
  the raw CPU code first, then its index into the kernel table.  When
  the process's first VML call comes from several OpenMP threads at
  once, a thread that reads the raw code indexes the table's EP row
  (about 11 correct bits) for its whole share of the tensor: a relative
  error up to 3e-4 on one contiguous chunk, in a fraction of the runs.
  A float64 ``sqrt`` takes the same path.

The port's per-SNP scalars (``1/sd``, ``1/rstd``) feed every correlation
and the threshold counters, so on the CPU the square root is taken by
NumPy, whose ``sqrt`` is the IEEE instruction on one thread.  CUDA's
``sqrt`` is correctly rounded already and stays as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 or float64 tensor,
    on any device and at any thread count (see the module docstring)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    np.sqrt(x.detach().numpy(), out=out.numpy())
    return out
