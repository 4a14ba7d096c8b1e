"""Iteratively re-weighted least squares (reference: ``nldsc/h2/irwls.py``),
in torch float64.

Exactly two weight-update iterations (``irwls.py:113``), then a block
jackknife on the re-weighted system.  Weight normalization divides by the
weight sum (``reweigh``, ``irwls.py:12-41``).  The ``w <= 0`` checks read
a device value on the host: they are part of the semantics.
"""

from __future__ import annotations

import torch

from ..core.numerics import sqrt_rn
from . import jackknife as jk


def reweigh(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Multiply rows of x by w normalized to sum 1 (rejects w <= 0)."""
    if bool((w <= 0).any()):
        raise ValueError("Weights must be > 0")
    n, _ = x.shape
    if w.shape != (n, 1):
        raise ValueError(f"w has shape {tuple(w.shape)}. w must have shape "
                         "(n, 1).")
    return x * (w / w.sum())


def wls(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted least squares by Householder QR; the coefficient column
    (p, 1)."""
    if bool((w <= 0).any()):
        raise ValueError("Weights must be > 0")
    scale = w / w.sum()
    return jk.lstsq_qr(x * scale, y * scale)


def irwls(x: torch.Tensor, y: torch.Tensor, update_func, n_blocks: int,
          w: torch.Tensor | None, slow: bool = False, separators=None,
          n_iter: int = 2) -> jk.JackknifeResult:
    """The IRWLS loop (irwls.py:75-130).

    ``update_func`` maps the current WLS coefficient column (p, 1) to new
    (unsquare-rooted) weights; it runs exactly ``n_iter`` times (reference
    hardcodes 2).  The returned jackknife uses the final sqrt-weights.
    """
    n, _ = x.shape
    if y.shape != (n, 1):
        raise ValueError(f"y has shape {tuple(y.shape)}. y must have shape "
                         f"({n}, 1).")
    w = torch.ones_like(y) if w is None else w
    if w.shape != (n, 1):
        raise ValueError(f"w has shape {tuple(w.shape)}. w must have shape "
                         f"({n}, 1).")

    w = sqrt_rn(w)
    for _ in range(n_iter):
        coef = wls(x, y, w)
        new_w = sqrt_rn(update_func(coef))
        if new_w.shape != w.shape:
            raise ValueError("New weights must have same shape.")
        w = new_w

    xw = reweigh(x, w)
    yw = reweigh(y, w)
    if slow:
        return jk.lstsq_jackknife_slow(xw, yw, n_blocks, separators=separators)
    return jk.lstsq_jackknife_fast(xw, yw, n_blocks, separators=separators)
