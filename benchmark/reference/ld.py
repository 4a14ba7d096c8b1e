"""Plain LD scores of chosen rows, in float64, from the ``.bed`` bytes.

The semantics are the original nldsc's, as its float64 oracle states
them: additive codes 0/1/2 and dominance codes 0/2/2; MAF from the
non-missing genotypes, a SNP dropped when MAF <= ``maf_thr``; missing
genotypes mean-imputed in both codes; the dominance residual of a 1-D
least-squares fit on the additive code; population standardization; a
pair's adjusted r² = 1 - (1 - r²)(n - 1)/(n - 2) with r the mean product
of the standardized rows; the window |pos_j - pos_i| <= w, inclusive;
l2 = 1 + the additive pairs' sum, l2d = the sum over the neighbours whose
residual sd passes ``std_thr``; ``l2d_wse`` counts those whose dominance
adjusted r² passes ``rsq_thr``; a SNP whose additive sd is 0 poisons the
additive sums it enters; with annotations each neighbour's adjusted r² is
weighted by its annotation row, and the self term adds ``annot[i]``.

It computes in blocks of consecutive rows: the rows of a block's windows
are unpacked, standardized and multiplied in float64 on ``device``, so
memory stays one span's.  ``epilogue`` = ``torch.bfloat16`` gives the
benchmark's lower-precision control: the same products (the stated int8
products are exact, and so are these), with the per-pair r, the adjusted
r², the sums, the annotation contraction and the per-SNP scalars in
bfloat16, the precision below the program's float32 epilogue.

Imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

#: the float32 epilogue's rounding of an adjusted r² near ``rsq_thr``
#: against its float64 value (2 float32 ulp of 1): a frozen copy of the
#: repository's counter contract (``tests/contract.py``)
EPILOGUE_TOL = 2 * 2.0 ** -23
#: rows standardized per step: bounds the float64 temporaries
STEP_GENOTYPES = 1 << 26

FIELDS = ("l2", "l2d", "maf", "residuals_std", "l2_ws", "l2d_ws", "l2d_wse")
ANNOT_FIELDS = ("l2_annot", "l2d_annot")


def unpack(raw: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 (rows, ceil(n / 4)) ``.bed`` bytes -> int8 (rows, n) codes:
    bitpairs 00 -> 0, 01 -> missing (-1), 10 -> 1, 11 -> 2, the first
    sample in the low bits."""
    lut = torch.tensor([0, -1, 1, 2], dtype=torch.int8, device=raw.device)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=raw.device)
    pairs = (raw[:, :, None] >> shifts) & 3
    return lut[pairs.reshape(raw.shape[0], -1)[:, :n].long()]


def row_flags(raw: np.ndarray, n: int, maf_thr: float, device) -> tuple:
    """bool (M,) per row: usable (MAF above ``maf_thr``, or undefined) and
    contaminated (a missing genotype), from the packed rows."""
    m = raw.shape[0]
    step = max(1, STEP_GENOTYPES // n)
    usable, miss = [], []
    for r0 in range(0, m, step):
        codes = unpack(torch.from_numpy(raw[r0:r0 + step]).to(device), n)
        valid = codes >= 0
        f2 = torch.where(valid, codes, 0).double().sum(1) / valid.sum(1) / 2
        maf = torch.minimum(f2, 1 - f2)
        usable.append(~(maf <= maf_thr))
        miss.append(~valid.all(1))
    return torch.cat(usable).cpu().numpy(), torch.cat(miss).cpu().numpy()


def window_bounds(pos: np.ndarray, w: float) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive row bounds (lo, hi) of each SNP's window |pos_j - pos_i|
    <= w on sorted non-negative positions."""
    if np.any(pos < 0) or np.any(np.diff(pos) < 0):
        raise ValueError("the reference takes sorted non-negative positions")
    lo = np.searchsorted(pos, pos - w, side="left")
    hi = np.searchsorted(pos, pos + w, side="right") - 1
    # the exact test |pos_j - pos_i| <= w at the two edges
    lo = np.where((lo > 0) & (np.abs(pos[np.maximum(lo - 1, 0)] - pos) <= w),
                  lo - 1, lo)
    hi = np.where((hi < len(pos) - 1)
                  & (np.abs(pos[np.minimum(hi + 1, len(pos) - 1)] - pos) <= w),
                  hi + 1, hi)
    return lo, hi


def standardize(codes: torch.Tensor, maf_thr: float) -> dict:
    """float64 standardized additive rows ``a`` and dominance-residual rows
    ``r`` (zero rows where undefined) and per row ``maf``, ``rsd`` (the
    residual sd, NaN where unusable), ``usable`` and ``sd0`` (usable, with
    additive sd 0 or undefined)."""
    n = codes.shape[1]
    out = {k: [] for k in ("a", "r", "maf", "rsd", "usable", "sd0")}
    step = max(1, STEP_GENOTYPES // n)
    for r0 in range(0, codes.shape[0], step):
        c = codes[r0:r0 + step]
        valid = c >= 0
        g = c.double()
        nv = valid.sum(1).double()
        dom = torch.clamp(g, max=1.0) * 2.0
        mean_a = torch.where(valid, g, 0.0).sum(1) / nv
        mean_d = torch.where(valid, dom, 0.0).sum(1) / nv
        f2 = mean_a / 2
        maf = torch.where(f2 < 0.5, f2, 1.0 - f2)
        usable = ~(maf <= maf_thr)
        a = torch.where(valid, g, mean_a[:, None])
        d = torch.where(valid, dom, mean_d[:, None])
        am, dm = a.mean(1), d.mean(1)
        denom = (a * a).sum(1) / n - am * am
        slope = torch.where(denom != 0, ((a * d).sum(1) / n - am * dm)
                            / torch.where(denom != 0, denom, 1.0), np.nan)
        res = d - slope[:, None] * a
        del d
        a = a - am[:, None]
        a_sd = torch.sqrt((a * a).sum(1) / n)
        res = res - res.mean(1, keepdim=True)
        r_sd = torch.sqrt((res * res).sum(1) / n)
        sd0 = usable & ((a_sd == 0) | ~torch.isfinite(a_sd))
        a_ok = usable & ~sd0
        r_ok = usable & (r_sd > 0) & torch.isfinite(r_sd)
        out["a"].append(torch.where(a_ok[:, None],
                                    a / torch.where(a_ok, a_sd, 1.0)[:, None],
                                    0.0))
        out["r"].append(torch.where(r_ok[:, None],
                                    res / torch.where(r_ok, r_sd, 1.0)[:, None],
                                    0.0))
        out["maf"].append(maf)
        out["rsd"].append(torch.where(usable, r_sd, np.nan))
        out["usable"].append(usable)
        out["sd0"].append(sd0)
    return {k: torch.cat(v) for k, v in out.items()}


def ld_rows(raw: np.ndarray, n: int, positions: np.ndarray, ld_wind: float,
            maf_thr: float, std_thr: float, rsq_thr: float, blocks: list,
            annot: np.ndarray | None = None, device="cpu",
            epilogue: torch.dtype = torch.float64) -> dict:
    """The LD scores of the rows of ``blocks`` (``(first, end)`` ranges of
    consecutive rows, in order), as float64 / int64 numpy arrays over
    those rows: :data:`FIELDS`, :data:`ANNOT_FIELDS` with ``annot`` (M, p),
    and ``near``, the pairs that ``l2d_wse`` counts or may count whose
    float64 dominance adjusted r² lies within :data:`EPILOGUE_TOL` of
    ``rsq_thr``.  ``raw``: uint8 (M, ceil(n / 4)) ``.bed`` rows."""
    dev = torch.device(device)
    lo, hi = window_bounds(positions, ld_wind)
    adj_c = (n - 1.0) / (n - 2.0)
    lp = epilogue
    parts = []
    for b0, b1 in blocks:
        s0, s1 = int(lo[b0:b1].min()), int(hi[b0:b1].max()) + 1
        codes = unpack(torch.from_numpy(raw[s0:s1]).to(dev), n)
        st = standardize(codes, maf_thr)
        del codes
        piv = torch.arange(b0 - s0, b1 - s0, device=dev)
        x = st["a"][piv]
        r_add = (x @ st["a"].T) / n
        r_dom = (x @ st["r"].T) / n
        del x
        pos = torch.from_numpy(positions[s0:s1]).to(dev)
        j = torch.arange(s0, s1, device=dev)[None, :]
        nbr = ((pos[None, :] - pos[piv, None]).abs() <= ld_wind) & (
            j != piv[:, None] + s0) & st["usable"][None, :]
        dom = nbr & (st["rsd"] > std_thr)[None, :]
        use_p, sd0_p = st["usable"][piv], st["sd0"][piv]
        poison = sd0_p | (nbr & st["sd0"][None, :]).any(1)

        one, c = torch.ones((), dtype=lp, device=dev), torch.tensor(
            adj_c, dtype=lp, device=dev)
        adj_a = one - (one - r_add.to(lp) ** 2) * c
        adj_d = one - (one - r_dom.to(lp) ** 2) * c
        zero = torch.zeros((), dtype=lp, device=dev)
        wa, wd = torch.where(nbr, adj_a, zero), torch.where(dom, adj_d, zero)
        l2 = (one + wa.sum(1)).double()
        l2d = wd.sum(1).double()
        wse = (dom & (adj_d > rsq_thr)).sum(1)
        adj64 = 1.0 - (1.0 - r_dom ** 2) * adj_c
        near = (dom & ((adj64 - rsq_thr).abs() <= EPILOGUE_TOL)).sum(1)
        any_dom = dom.any(1)
        nan = torch.tensor(np.nan, dtype=torch.float64, device=dev)
        l2 = torch.where(poison, nan, l2)
        l2d = torch.where(sd0_p, torch.where(any_dom, nan, 0.0), l2d)
        wse = torch.where(sd0_p, 0, wse)
        out = {"l2": l2, "l2d": l2d,
               "maf": st["maf"][piv].to(lp).double(),
               "residuals_std": st["rsd"][piv].to(lp).double(),
               "l2_ws": nbr.sum(1), "l2d_ws": dom.sum(1), "l2d_wse": wse,
               "near": near}
        if annot is not None:
            a_span = torch.from_numpy(annot[s0:s1]).to(dev).to(lp)
            la = (a_span[piv] + wa @ a_span).double()
            lda = (wd @ a_span).double()
            out["l2_annot"] = torch.where(poison[:, None], nan, la)
            out["l2d_annot"] = torch.where(
                sd0_p[:, None], torch.where(any_dom, nan, 0.0)[:, None], lda)
        for k in ("l2", "l2d", "l2_annot", "l2d_annot"):
            if k in out:
                out[k] = torch.where(use_p.view(-1, *[1] * (out[k].dim() - 1)),
                                     out[k], nan)
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            out[k] = torch.where(use_p, out[k], -1)
        parts.append({k: v.cpu() for k, v in out.items()})
        del st, r_add, r_dom, adj_a, adj_d, wa, wd
    res = {k: torch.cat([p[k] for p in parts]).numpy() for k in parts[0]}
    for k in ("l2_ws", "l2d_ws", "l2d_wse", "near"):
        res[k] = res[k].astype(np.int64)
    return res
