"""On-device genotype preprocessing (torch): the 2-bit PLINK .bed unpack,
and the float32 rows of the f32 engine.

Shipping the packed bytes costs 4x less host-to-device traffic than int8
codes; the unpack is a shift and mask per bitpair.  :func:`preprocess_block`
is the f32 engine's per-SNP pipeline (``nldsc_tpu/ld/preprocess.py:57-149``):
means and MAF from the non-missing codes, mean imputation, the dominance
residual from the class-count closed forms and population-variance
standardization.
"""

from __future__ import annotations

import torch

from ..core.numerics import recip_f32, sqrt_rn
from .ld_int8 import dom_class_stats, f32, step_rows

#: genotypes unpacked per step (8,192 rows at N = 16,384): bounds the
#: uint8 temporaries to ~1 GB at any width.  A step of a fixed number of
#: rows would grow with N: 8,192 rows at N = 315,599 held ~2.6 GB a
#: temporary, and the in-core peak then passed the bytes per genotype
#: that the auto-streaming rule assumes (ROADMAP F5)
STEP_GENOTYPES = 8192 * 16384
#: genotypes of :func:`preprocess_block` per step (2,048 rows at N =
#: 16,384): bounds its float32 temporaries to a few hundred MB
F32_STEP_GENOTYPES = 2048 * 16384


def unpack_bed(raw: torch.Tensor, n_samples: int, n_pad: int,
               pad_val: int, col0: int = 0) -> torch.Tensor:
    """(M, bytes_per_snp) uint8 -> (M, n_pad) int8 genotype codes.

    2-bit code -> additive code via ``{0:0, 1:-1 (missing), 2:1, 3:2}``:
    with ``hi = code >> 1`` and ``lo = code & 1`` that is
    ``hi - lo + 2·hi·lo``.  Columns whose global sample index is at or
    past ``n_samples`` (the last byte's pad bitpairs and the lane padding
    to ``n_pad``) are forced to ``pad_val`` (0 on the no-missing path, -1
    otherwise).  ``col0``: the global sample index of local column 0,
    when ``raw`` is one shard of the samples' bytes (the sample-sharded
    engines, ``nldsc_tpu/ld/preprocess.py:24-25``).
    """
    if raw.dtype != torch.uint8 or raw.dim() != 2:
        raise ValueError("raw must be a 2-D uint8 tensor")
    m, bps = raw.shape
    # the output's columns that hold samples: all of them in a shard
    n_local = min(max(n_samples - col0, 0), n_pad)
    if n_local > 4 * bps or (col0 == 0 and n_pad < n_samples
                             and 4 * bps >= n_samples):
        raise ValueError(f"n_samples={n_samples} from column {col0} does "
                         f"not fit {bps} bytes per row and n_pad={n_pad}")
    out = torch.full((m, n_pad), pad_val, dtype=torch.int8, device=raw.device)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=raw.device)
    step = step_rows(max(n_pad, 4 * bps), STEP_GENOTYPES)
    for r0 in range(0, m, step):
        part = raw[r0:r0 + step]
        codes = (part.unsqueeze(-1) >> shifts) & 3            # (rows, bps, 4)
        codes = codes.reshape(part.shape[0], 4 * bps)[:, :n_local]
        hi = (codes >> 1).to(torch.int8)
        lo = (codes & 1).to(torch.int8)
        out[r0:r0 + part.shape[0], :n_local] = hi - lo + 2 * hi * lo
    return out


def preprocess_block(genotypes: torch.Tensor, pos_ok: torch.Tensor,
                     maf_thr: float, n_samples: int) -> dict[str, torch.Tensor]:
    """The f32 engine's standardized rows of int8 (M, N_pad) codes.

    Any negative code is missing, and the sample padding must be negative
    (missing): imputed entries centre to exactly 0, so padded columns add
    nothing to a product.  Returns float32 ``add`` (M, N_pad), the
    standardized additive rows (0 where unusable), ``res`` (M, N_pad), the
    standardized dominance residuals (0 where unusable or the additive sd is
    zero), ``maf`` (NaN where position-skipped), ``rstd`` (NaN where unusable
    or the additive sd is zero), and bool ``usable`` and ``add_sd_zero``: the
    float32 operations of ``nldsc_tpu.ld.preprocess.preprocess_block``, in
    steps of rows.
    """
    m, n_pad = genotypes.shape
    dev = genotypes.device
    inv_n = recip_f32(n_samples)
    maf_thr = f32(maf_thr)
    add = torch.empty((m, n_pad), dtype=torch.float32, device=dev)
    res = torch.empty_like(add)
    stats = {k: torch.empty(m, dtype=torch.float32, device=dev)
             for k in ("maf", "rstd")}
    flags = {k: torch.empty(m, dtype=torch.bool, device=dev)
             for k in ("usable", "add_sd_zero")}
    step = step_rows(n_pad, F32_STEP_GENOTYPES)
    for r0 in range(0, m, step):
        rows = slice(r0, r0 + step)
        g = genotypes[rows]
        valid = g >= 0
        gf = torch.where(valid, g, 0).to(torch.float32)
        n_valid_raw = valid.sum(dim=1)
        # an all-missing SNP has a NaN mean in the reference: the MAF drop
        # test is false, so it stays usable, as an additive-sum poison
        all_missing = n_valid_raw == 0
        n_valid = torch.clamp(n_valid_raw, min=1).to(torch.float32)
        add_mean = gf.sum(dim=1) / n_valid       # integer sums: exact
        f2 = add_mean * 0.5
        maf = torch.minimum(f2, 1.0 - f2)
        usable = pos_ok[rows] & ((maf > maf_thr) | all_missing)
        a_c = torch.where(valid, gf, add_mean[:, None]) - add_mean[:, None]

        c1 = (gf == 1.0).sum(dim=1, dtype=torch.float32)
        c2 = (gf == 2.0).sum(dim=1, dtype=torch.float32)
        c0 = n_valid - c1 - c2
        va, _slope, rvar_sum, v0, v1, v2 = dom_class_stats(c0, c1, c2)
        add_sd = sqrt_rn(va / n_valid * inv_n)
        add_sd_zero = usable & ((va <= 0.0) | all_missing)
        zero = torch.zeros_like(gf)
        r_c = torch.where(
            valid,
            v0[:, None] + torch.where(gf == 1.0, (v1 - v0)[:, None], zero)
            + torch.where(gf == 2.0, (v2 - v0)[:, None], zero),
            zero)
        rstd = sqrt_rn(rvar_sum * inv_n)

        one = torch.ones_like(add_sd)
        inv_add_sd = torch.where(add_sd > 0,
                                 1.0 / torch.where(add_sd > 0, add_sd, one),
                                 torch.zeros_like(add_sd))
        inv_rstd = torch.where(rstd > 0, 1.0 / torch.where(rstd > 0, rstd, one),
                               torch.zeros_like(rstd))
        add[rows] = torch.where(usable[:, None], a_c * inv_add_sd[:, None],
                                zero)
        res[rows] = torch.where((usable & ~add_sd_zero)[:, None],
                                r_c * inv_rstd[:, None], zero)
        nan = torch.full_like(maf, float("nan"))
        stats["maf"][rows] = torch.where(pos_ok[rows] & ~all_missing, maf, nan)
        stats["rstd"][rows] = torch.where(usable & ~add_sd_zero, rstd, nan)
        flags["usable"][rows] = usable
        flags["add_sd_zero"][rows] = add_sd_zero
    return {"add": add, "res": res, **stats, **flags}
