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

The JAX package's float32 arithmetic is what XLA compiles, not what its
source says, and the port follows the compiled form (read from jaxlib
0.9.0 on x86-64; ``scripts/probe_xla_f32.py`` prints it again):

* a division by a compile-time constant n becomes a multiplication by
  ``f32(1/n)`` (:func:`recip_f32`); a division by a runtime value stays a
  division;
* inside one fused loop, a multiply whose only use is an add or subtract
  is contracted into it with one rounding (:func:`fma_rn`); when both
  operands of the add are such products, the left one is contracted.
"""

from __future__ import annotations

import math

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


def recip_f32(n: float) -> float:
    """``f32(1) / f32(n)``: the constant XLA multiplies by where the JAX
    package divides by the constant n (0.00666666683 at n = 150)."""
    return float(np.float32(1.0) / np.float32(n))


#: the low 29 bits of a float64 that a float32 drops, and their pattern at
#: a float32 tie; below 2^-126 float32 drops more bits
_LOW29 = (1 << 29) - 1
_TIE29 = 1 << 28
_F32_TINY = 2.0 ** -126


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def _round_to_odd(s, p, c64):
    """The float64 sum ``s = p + c64`` rounded to odd instead of to
    nearest: when it is inexact (TwoSum) and its last bit even, one ulp
    toward the exact value."""
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    return torch.where(fix, torch.nextafter(s, toward), s)


def fma_rn(a, b, c) -> torch.Tensor:
    """The float32 ``a·b + c`` rounded once, on any device.

    ``a``, ``b``, ``c``: float32 tensors or float32-valued Python floats
    (at least one a tensor), broadcast together.  The product of two
    float32 values is exact in float64, so the float64 sum ``s`` is the
    exact value rounded once; rounding ``s`` to float32 is then a correct
    rounding of the exact value unless ``s`` landed on a float32 tie (its
    low 29 bits ``1000…0``) or below the float32 normal range, where the
    second rounding may break the tie the wrong way.  Rounded to odd
    first (:func:`_round_to_odd`), it rounds to float32 exactly: with 53
    >= 24 + 2 bits, round-to-odd followed by round-to-nearest is a single
    rounding (Boldo and Melquiond).  On the CPU only the ties take that
    step; on a GPU every entry does, which needs no host sync.  Only IEEE
    float64 add, multiply and ``nextafter``: no VML kernel.
    """
    p = _f64(a) * _f64(b)
    c64 = _f64(c)
    s = p + c64
    if s.device.type != "cpu":
        return _round_to_odd(s, p, c64).to(torch.float32)
    out = s.to(torch.float32)
    tie = (((s.view(torch.int64) & _LOW29) == _TIE29)
           | (out.abs() <= _F32_TINY))
    idx = tie.view(-1).nonzero().squeeze(1)
    if idx.numel():
        at = torch.unravel_index(idx, s.shape)
        p, c64 = (torch.as_tensor(x, dtype=torch.float64, device=s.device)
                  .expand(s.shape)[at] for x in (p, c64))
        out.view(-1)[idx] = _round_to_odd(s.view(-1)[idx], p,
                                          c64).to(torch.float32)
    return out
