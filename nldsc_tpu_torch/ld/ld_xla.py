"""The f32 engine (``--engine f32``) and the sentinel finalization (torch).

Port of ``nldsc_tpu/ld/ld_xla.py``.  The f32 engine works on the
standardized float32 rows of :func:`..preprocess.preprocess_block`: for
each pivot block of ``block_size`` SNPs, its in-window neighbours are one
contiguous band of rows, so each tile is one float32 product of the pivot
rows with the band, followed by the epilogue of :func:`_tile_epilogue`
(adjusted r², window and usability masks, row sums).  The reference left
those products to XLA, outside any Pallas kernel; here they are
``torch.matmul`` in full float32 (:func:`fdot`: TF32 off whatever the
process-wide setting), on the CUDA cores on a GPU, and the epilogue is
torch ops.  All engines share :func:`finalize_outputs`.
"""

from __future__ import annotations

import torch

from ..core.numerics import recip_f32
from .ld_int8 import adj_constant, adj_r2, annot_dot, f32, finalize_annot

def fdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x · yᵀ over the sample axis in full float32 (TF32 off for the call,
    whatever the process-wide setting)."""
    return annot_dot(x, y.t())


def _tile_epilogue(r_add, r_dom, gi, gj, lo_i, hi_i, usable_i, usable_j,
                   dom_ok_j, poison_j, n_samples: int, rsq_thr: float,
                   aj=None):
    """Mask algebra of one (B_i × B_j) tile of correlations.  Returns
    per-row partial sums ``(l2, l2d, ws, wsd, wse, poison)``; with ``aj``
    (B_j, p) also the masked adjusted r² contracted with it,
    ``(l2_annot, l2d_annot)``."""
    adj_c = adj_constant(n_samples)
    adj_add = adj_r2(r_add, adj_c)
    adj_dom = adj_r2(r_dom, adj_c)

    in_win = (gj[None, :] >= lo_i[:, None]) & (gj[None, :] <= hi_i[:, None])
    pair = in_win & usable_j[None, :] & usable_i[:, None]
    base = pair & (gj[None, :] != gi[:, None])
    dmask = base & dom_ok_j[None, :]
    add_m = adj_add * base.to(torch.float32)
    dom_m = adj_dom * dmask.to(torch.float32)

    i32 = torch.int32
    out = (add_m.sum(dim=1), dom_m.sum(dim=1), base.sum(dim=1, dtype=i32),
           dmask.sum(dim=1, dtype=i32),
           ((adj_dom > f32(rsq_thr)) & dmask).sum(dim=1, dtype=i32),
           # zero-additive-sd SNPs in the window, the pivot itself included
           (pair & poison_j[None, :]).sum(dim=1, dtype=i32))
    if aj is None:
        return out
    return (*out, annot_dot(add_m, aj), annot_dot(dom_m, aj))


def finalize_outputs(l2_acc, l2d_acc, ws, wsd, wse, poison, usable,
                     add_sd_zero):
    """Apply NaN/-1 sentinel semantics (ldscalc.h:16-21, SURVEY Q4).

    Unusable rows get NaN scores and -1 counters; a row with a
    zero-additive-sd SNP in its window (itself included) gets NaN L2; a
    zero-additive-sd pivot gets NaN L2D unless no neighbour passed the
    dominance filter, and WSE 0.
    """
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=l2_acc.device)
    l2 = torch.where(usable & (poison == 0), 1.0 + l2_acc, nan)
    l2d_pivot_bad = torch.where(wsd > 0, nan, torch.zeros_like(nan))
    l2d = torch.where(usable, torch.where(add_sd_zero, l2d_pivot_bad, l2d_acc),
                      nan)
    neg1 = torch.full_like(ws, -1)
    ws_o = torch.where(usable, ws, neg1)
    wsd_o = torch.where(usable, wsd, neg1)
    wse_o = torch.where(usable, torch.where(add_sd_zero, torch.zeros_like(wse),
                                            wse), neg1)
    return l2, l2d, ws_o, wsd_o, wse_o


def band_pass(tile, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
              rsq_thr: float, annot, *, block_size: int, band_k: int,
              n_samples: int, n_pivots: int | None = None, g0: int = 0,
              piv_off: int = 0, m_pad: int | None = None):
    """Per-row partials of the full-band pass: each pivot block against
    its whole band, both sides, one :func:`_tile_epilogue` a block (the
    reference's ``pivot_block`` of ``ld_scores_xla`` in core and of the
    streaming chunks ``_banded_chunk``/``_banded_chunk_int8``).

    The rows (``usable``, ``dom_ok``, ``add_sd_zero``, ``annot``) are a
    band whose first row is global row ``g0``; the pivots are its
    ``n_pivots`` rows from ``piv_off`` on (default: all of them), with
    global window bounds ``lo``/``hi`` (``n_pivots``,) and, per pivot
    block, ``blk_lo`` (host), the first block its windows reach.  Rows at
    or past ``m_pad`` are no neighbours.  ``tile(rows, cols)`` returns
    the additive and dominance correlations of the pivot rows ``rows``
    against the band rows ``cols`` (:func:`f32_tile`,
    ``ld_int8.int8_tile``).  The reference's integer chunk scales its
    correlations back to sums by n for an epilogue that divides again
    (``nldsc_tpu/ld/streaming.py:101-102``); XLA folds that round trip
    away (its optimized HLO squares the correlation itself), so the tiles
    hand over the correlations."""
    rows_total = usable.shape[0]
    B = block_size
    n_piv = rows_total if n_pivots is None else n_pivots
    slab = min(band_k * B, rows_total)
    dev = usable.device
    parts = []
    for b in range(n_piv // B):
        r0 = piv_off + b * B
        rows = slice(r0, r0 + B)
        # the reference's clipped dynamic_slice of the band
        j0 = min(max(int(blk_lo[b]) * B - g0, 0), rows_total - slab)
        cols = slice(j0, j0 + slab)
        gj = g0 + j0 + torch.arange(slab, device=dev)
        ok = True if m_pad is None else gj < m_pad
        r_add, r_dom = tile(rows, cols)
        parts.append(_tile_epilogue(
            r_add, r_dom, g0 + r0 + torch.arange(B, device=dev), gj,
            lo[b * B:(b + 1) * B], hi[b * B:(b + 1) * B], usable[rows],
            usable[cols] & ok, dom_ok[cols] & ok, add_sd_zero[cols] & ok,
            n_samples, rsq_thr, None if annot is None else annot[cols]))
    return [torch.cat(x) for x in zip(*parts)]


def f32_tile(add, res, n_samples: int):
    """The f32 engine's ``tile`` for :func:`band_pass`: full-float32
    products of the standardized rows, divided by n (a product by
    ``f32(1/n)``, as XLA compiles the reference's division)."""
    inv_n = recip_f32(n_samples)

    def tile(rows, cols):
        ya = add[rows]
        return fdot(ya, add[cols]) * inv_n, fdot(ya, res[cols]) * inv_n
    return tile


def _full_band(add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
               rsq_thr, annot, block_size: int, band_k: int, n_samples: int):
    """:func:`band_pass` in core, on the f32 engine's rows."""
    return band_pass(f32_tile(add, res, n_samples), lo, hi, usable, dom_ok,
                     add_sd_zero, blk_lo, rsq_thr, annot,
                     block_size=block_size, band_k=band_k,
                     n_samples=n_samples)


def ld_scores_xla(add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
                  blk_hi, rsq_thr: float, *, block_size: int, band_k: int,
                  n_samples: int):
    """The f32 engine, full band (``nldsc_tpu/ld/ld_xla.py:86``).

    ``add``/``res``: float32 (M_pad, N_pad) rows of
    :func:`..preprocess.preprocess_block` (padding rows unusable);
    ``lo``/``hi`` int32, ``usable``/``dom_ok``/``add_sd_zero`` bool
    (M_pad,) tensors on their device; ``blk_lo``/``blk_hi``: per pivot
    block, the first and last block its windows reach
    (``windows.band_blocks``, host arrays).  Returns finalized
    ``(l2, l2d, ws, wsd, wse)``, each of length M_pad.
    """
    del blk_hi                 # the band is blk_lo's band_k blocks
    l2, l2d, ws, wsd, wse, poison = _full_band(
        add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo, rsq_thr, None,
        block_size, band_k, n_samples)
    return finalize_outputs(l2, l2d, ws, wsd, wse, poison, usable,
                            add_sd_zero)


def ld_scores_xla_annot(add, res, lo, hi, usable, dom_ok, add_sd_zero,
                        blk_lo, blk_hi, rsq_thr: float, annot, *,
                        block_size: int, band_k: int, n_samples: int):
    """The f32 engine's partitioned pass, full band only
    (``nldsc_tpu/ld/ld_xla.py:144``): :func:`ld_scores_xla` with each
    tile's masked adjusted r² contracted with the band's annotation rows
    (float32 ``annot`` (M_pad, p), padding rows 0).  The self pair adds
    its own annotation row to ``l2_annot``.  Returns ``(l2_annot,
    l2d_annot, l2, l2d, ws, wsd, wse)``."""
    del blk_hi
    l2, l2d, ws, wsd, wse, poison, l2_a, l2d_a = _full_band(
        add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo, rsq_thr, annot,
        block_size, band_k, n_samples)
    fin = finalize_outputs(l2, l2d, ws, wsd, wse, poison, usable, add_sd_zero)
    return (*finalize_annot(l2_a, l2d_a, annot, usable, add_sd_zero, poison,
                            wsd), *fin)


def ld_scores_xla_sym(add, res, lo, hi, usable, dom_ok, add_sd_zero, blk_lo,
                      blk_hi, rsq_thr: float, *, block_size: int, band_k: int,
                      right_k: int, n_samples: int):
    """The f32 engine, symmetric (``nldsc_tpu/ld/ld_xla.py:236``): the
    additive product of each pivot block with its right half-band only,
    whose tile credits both its row sums (pairs with j at or after the
    pivot block) and its column sums (the mirrored pairs past the pivot
    block), carried across the blocks as the reference's ``lax.scan``
    carries them; the dominance product (not symmetric) over the full band
    as :func:`ld_scores_xla` computes it.  Same arguments and return."""
    m_pad = add.shape[0]
    B = block_size
    band_rows = min(band_k * B, m_pad)
    right_rows = min(right_k * B, m_pad)
    dev = add.device
    inv_n = recip_f32(n_samples)
    adj_c = adj_constant(n_samples)
    i32 = torch.int32
    l2_acc = torch.zeros(m_pad, dtype=torch.float32, device=dev)
    ws, poison = (torch.zeros(m_pad, dtype=i32, device=dev) for _ in range(2))
    dom_parts = []
    for b in range(m_pad // B):
        r0 = b * B
        rows = slice(r0, r0 + B)
        ya = add[rows]
        gi = r0 + torch.arange(B, device=dev)
        lo_i, hi_i = lo[rows][:, None], hi[rows][:, None]
        usable_i, poison_i = usable[rows][:, None], add_sd_zero[rows][:, None]

        # additive: the right half-band, credited both ways
        j0r = min(r0, m_pad - right_rows)
        cr = slice(j0r, j0r + right_rows)
        gj = (j0r + torch.arange(right_rows, device=dev))[None, :]
        adj_add = adj_r2(fdot(ya, add[cr]) * inv_n, adj_c)
        upair = ((gj >= lo_i) & (gj <= hi_i) & usable[cr][None, :]
                 & usable_i)
        fwd = gj >= r0                     # against re-visits of a clipped j0r
        row_base = upair & fwd & (gj != gi[:, None])
        col_base = upair & (gj >= r0 + B)  # the pivot block: rows cover it
        l2_acc[rows] += (adj_add * row_base.to(torch.float32)).sum(dim=1)
        l2_acc[cr] += (adj_add * col_base.to(torch.float32)).sum(dim=0)
        ws[rows] += row_base.sum(dim=1, dtype=i32)
        ws[cr] += col_base.sum(dim=0, dtype=i32)
        poison[rows] += (upair & fwd & add_sd_zero[cr][None, :]).sum(
            dim=1, dtype=i32)
        poison[cr] += (upair & poison_i & (gj >= r0 + B)).sum(dim=0,
                                                              dtype=i32)

        # dominance: the full band, row sums only
        j0 = min(max(int(blk_lo[b]) * B, 0), m_pad - band_rows)
        cols = slice(j0, j0 + band_rows)
        gjd = (j0 + torch.arange(band_rows, device=dev))[None, :]
        adj_dom = adj_r2(fdot(ya, res[cols]) * inv_n, adj_c)
        valid_k = gjd <= int(blk_hi[b]) * B + (B - 1)
        dmask = ((gjd >= lo_i) & (gjd <= hi_i) & valid_k
                 & usable[cols][None, :] & usable_i & (gjd != gi[:, None])
                 & dom_ok[cols][None, :])
        dom_parts.append((
            (adj_dom * dmask.to(torch.float32)).sum(dim=1),
            dmask.sum(dim=1, dtype=i32),
            ((adj_dom > f32(rsq_thr)) & dmask).sum(dim=1, dtype=i32)))
    l2d, wsd, wse = (torch.cat(x) for x in zip(*dom_parts))
    return finalize_outputs(l2_acc, l2d, ws, wsd, wse, poison, usable,
                            add_sd_zero)
