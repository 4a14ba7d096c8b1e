"""On-device 2-bit PLINK .bed unpack (torch).

Shipping the packed bytes costs 4x less host-to-device traffic than int8
codes; the unpack is a shift and mask per bitpair.
"""

from __future__ import annotations

import torch

#: rows unpacked per step: bounds the uint8 temporaries to ~1 GB at
#: chromosome widths
_ROWS_PER_STEP = 8192


def unpack_bed(raw: torch.Tensor, n_samples: int, n_pad: int,
               pad_val: int) -> torch.Tensor:
    """(M, bytes_per_snp) uint8 -> (M, n_pad) int8 genotype codes.

    2-bit code -> additive code via ``{0:0, 1:-1 (missing), 2:1, 3:2}``:
    with ``hi = code >> 1`` and ``lo = code & 1`` that is
    ``hi - lo + 2·hi·lo``.  Columns at or past ``n_samples`` (the last
    byte's pad bitpairs and the lane padding to ``n_pad``) are forced to
    ``pad_val`` (0 on the no-missing path, -1 otherwise).
    """
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise ValueError("raw must be a 2-D uint8 tensor")
    m, bps = raw.shape
    if n_samples > 4 * bps or n_pad < n_samples:
        raise ValueError(f"n_samples={n_samples} does not fit {bps} bytes "
                         f"per row and n_pad={n_pad}")
    out = torch.full((m, n_pad), pad_val, dtype=torch.int8, device=raw.device)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=raw.device)
    for r0 in range(0, m, _ROWS_PER_STEP):
        part = raw[r0:r0 + _ROWS_PER_STEP]
        codes = (part.unsqueeze(-1) >> shifts) & 3            # (rows, bps, 4)
        codes = codes.reshape(part.shape[0], 4 * bps)[:, :n_samples]
        hi = (codes >> 1).to(torch.int8)
        lo = (codes & 1).to(torch.int8)
        out[r0:r0 + part.shape[0], :n_samples] = hi - lo + 2 * hi * lo
    return out
