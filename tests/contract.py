"""The counter contract between two LD engines (the port against the JAX
package, or one port engine against another), with no JAX import, so
that ``chip_smoke.py`` holds the card's results to it as the tests hold
the CPU's; ``tests/test_torch_contract.py`` tests it.

The integer engines (int8 or bf16 operands) compute every pair's
adjusted r² with the float32 operations XLA compiles the reference into
(``nldsc_tpu_torch/core/numerics.py``), so their counters ``l2_ws``,
``l2d_ws`` and ``l2d_wse`` are equal: :func:`assert_counters_equal`.

The f32 engine sums float32 products of standardized rows in another
order than XLA, so its ``l2d_wse`` may differ on a pair whose adjusted
dominance r² lies within the products' rounding of ``rsq_thr``.  Its
contract (:func:`assert_counters_match`):

* ``l2_ws`` and ``l2d_ws`` count pairs from integer masks and are equal;
* ``l2d_wse`` is equal, except on rows that have a counted pair whose
  adjusted dominance r², computed in float64 from the same codes, lies
  within ``tol`` of ``rsq_thr``;
* on such a row the difference is at most the number of those pairs.

It returns the number of exempted rows, which each caller holds small.

Tolerance.  A float32 dot of N_pad terms of standardized rows is off by
up to N_pad·2⁻²⁴ of r (:func:`f32_tol`), and ``adj = 1 - (1 - r²)·c``
moves by 2·c·|r| times that; ``adj`` itself is rounded where its
operands lie near 1, a few float32 ulp of 1 (:data:`EPILOGUE_TOL`).  That
bound is tight at the tests' few hundred samples; at a chromosome's
N_pad = 16,384 it passes ``rsq_thr`` itself, so there the tolerance
comes from the f32 engine's measured error (:func:`f32_adj_error`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nldsc_tpu_torch.core.numerics import recip_f32
from nldsc_tpu_torch.ld import ld_int8, ld_xla, preprocess, windows

#: the counters every engine must agree on
COUNTERS = ("l2_ws", "l2d_ws", "l2d_wse")
#: the float32 epilogue's rounding of an adjusted r² near ``rsq_thr``
#: against its float64 value (2 float32 ulp of 1)
EPILOGUE_TOL = 2 * 2.0 ** -23


def f32_tol(n_pad: int, n_samples: int, rsq_thr: float) -> float:
    """The f32 engine's worst-case tolerance at ``n_pad`` padded samples:
    a float32 dot of N_pad terms of standardized rows is off by up to
    N_pad·2⁻²⁴ of r, and ``adj = 1 - (1 - r²)·c`` moves by 2·c·|r| times
    that, at the |r| where ``adj`` meets ``rsq_thr``; plus
    :data:`EPILOGUE_TOL`."""
    c = (n_samples - 1.0) / (n_samples - 2.0)
    r = math.sqrt(max(1.0 - (1.0 - rsq_thr) / c, 0.0))
    return 2.0 * c * r * n_pad * 2.0 ** -24 + EPILOGUE_TOL


def _standardized(codes: torch.Tensor, n: int):
    """float64 standardized additive and dominance-residual rows of int8
    codes (missing negative, imputed as 0), and per row ``maf``,
    ``add_sd_zero`` (before the usable mask), ``rstd`` and
    ``all_missing``: the reference's preprocessing, in float64."""
    valid = codes >= 0
    gf = torch.where(valid, codes, 0).double()
    n_valid_raw = valid.sum(dim=1)
    all_missing = n_valid_raw == 0
    n_valid = n_valid_raw.clamp(min=1).double()
    mean = gf.sum(dim=1) / n_valid
    c1 = (gf == 1).sum(dim=1).double()
    c2 = (gf == 2).sum(dim=1).double()
    c0 = n_valid - c1 - c2
    va = c0 * c1 + 4 * c0 * c2 + c1 * c2
    inv = 1.0 / torch.where(va > 0, va, torch.ones_like(va))
    v = torch.stack([-2 * c1 * c2, 4 * c0 * c2, -2 * c0 * c1], dim=1)
    v = v * inv[:, None]
    add_sd = torch.sqrt(va / n_valid / n)
    rstd = torch.sqrt(4 * c0 * c1 * c2 * inv / n)
    a = torch.where(valid, gf - mean[:, None], 0.0)
    a = torch.where(add_sd[:, None] > 0,
                    a / torch.where(add_sd > 0, add_sd, 1.0)[:, None], 0.0)
    r = torch.where(valid, v.gather(1, gf.long().clamp(0, 2)), 0.0)
    r = torch.where(rstd[:, None] > 0,
                    r / torch.where(rstd > 0, rstd, 1.0)[:, None], 0.0)
    f2 = mean / 2
    maf = torch.minimum(f2, 1 - f2)
    return a, r, maf, (va <= 0) | all_missing, rstd, all_missing


def _counted_pairs(codes: torch.Tensor, positions: np.ndarray, cfg, rows,
                   group: int):
    """Per span of ``rows`` within ``group`` of each other: ``(sel, s0,
    s1, counted, adj)``: the positions in ``rows`` of the span's pivots,
    the rows ``[s0, s1)`` their windows reach, the mask of the pairs
    ``l2d_ws`` counts (j in i's window, j != i, both usable, j passing
    the dominance filter) and the float64 adjusted dominance r² of
    additive i against residual j, each (pivots, s1 - s0)."""
    device = codes.device
    n = codes.shape[1]
    lo, hi, pos_ok = windows.window_bounds(positions, cfg.ld_wind)
    adj_c = (n - 1.0) / (n - 2.0)
    rows = np.asarray(rows, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    k = 0
    while k < len(order):
        first = rows[order[k]]
        end = k
        while end < len(order) and rows[order[end]] < first + group:
            end += 1
        sel = order[k:end]
        k = end
        r_i = rows[sel]
        s0 = int(min(r_i.min(), lo[r_i].min()))
        s1 = int(max(r_i.max() + 1, hi[r_i].max() + 1))
        a, r, maf, sd0, rstd, allm = _standardized(codes[s0:s1], n)
        ok = torch.from_numpy(pos_ok[s0:s1]).to(device)
        usable = ok & ((maf > cfg.maf_thr) | allm)
        dom_ok = usable & ~sd0 & (rstd > cfg.std_thr)
        rd = (a[torch.from_numpy(r_i - s0).to(device)] @ r.T) / n
        adj = 1.0 - (1.0 - rd * rd) * adj_c
        j = torch.arange(s0, s1, device=device)[None, :]
        ri = torch.from_numpy(r_i).to(device)[:, None]
        counted = ((j >= torch.from_numpy(lo[r_i]).to(device)[:, None])
                   & (j <= torch.from_numpy(hi[r_i]).to(device)[:, None])
                   & (j != ri) & usable[None, :] & dom_ok[None, :]
                   & usable[ri - s0])
        yield sel, s0, s1, counted, adj


def near_threshold_pairs(genotypes, positions: np.ndarray, cfg, rows,
                         tol: float, device="cpu",
                         group: int = 512) -> np.ndarray:
    """For each row i of ``rows``: how many of the pairs ``l2d_ws``
    counts for it have an adjusted dominance r² of additive i against
    residual j, in float64 from the codes, within ``tol`` of
    ``cfg.rsq_thr``.

    ``genotypes``: int8 (M, N) codes, a numpy array or a tensor (on
    ``device``, where the float64 arithmetic runs).  Rows within
    ``group`` of each other share one standardized span of rows.
    """
    codes = torch.as_tensor(genotypes).to(device)
    out = np.zeros(len(rows), dtype=np.int64)
    for sel, _, _, counted, adj in _counted_pairs(codes, positions, cfg,
                                                  rows, group):
        near = counted & ((adj - cfg.rsq_thr).abs() <= tol)
        out[sel] = near.sum(dim=1).cpu().numpy()
    return out


def f32_adj_error(genotypes, positions: np.ndarray, cfg, window: float,
                  device="cpu", group: int = 512) -> tuple[float, int]:
    """The largest ``|adj_f32 - adj_f64|`` over the pairs ``l2d_ws``
    counts whose ``adj_f64`` lies within ``window`` of ``cfg.rsq_thr``
    (the pairs a tolerance of that width would exempt), and how many
    such pairs there are.  ``adj_f32`` is computed as the f32 engine
    computes it (the rows of ``preprocess.preprocess_block``, a
    full-float32 ``ld_xla.fdot`` of a span's pivots with its residual
    rows, the float32 epilogue), ``adj_f64`` from the same codes in
    float64.  The products are cuBLAS calls of another shape than the
    engine's tiles, so the reading is the engine's error in kind, not
    pair for pair: callers give it a margin.  ``genotypes``: int8 (M, N)
    codes, on ``device``."""
    codes = torch.as_tensor(genotypes).to(device)
    m, n = codes.shape
    n_pad = -(-n // 128) * 128
    _, _, pos_ok = windows.window_bounds(positions, cfg.ld_wind)
    inv_n = recip_f32(n)
    adj_c = ld_int8.adj_constant(n)
    worst, n_pairs = 0.0, 0
    for sel, s0, s1, counted, adj in _counted_pairs(
            codes, positions, cfg, np.arange(m), group):
        near = counted & ((adj - cfg.rsq_thr).abs() <= window)
        n_near = int(near.sum())
        if not n_near:
            continue
        span = torch.full((s1 - s0, n_pad), -1, dtype=torch.int8,
                          device=device)
        span[:, :n] = codes[s0:s1]
        pre = preprocess.preprocess_block(
            span, torch.from_numpy(pos_ok[s0:s1]).to(device), cfg.maf_thr, n)
        piv = torch.from_numpy(sel - s0).to(device)
        rd = ld_xla.fdot(pre["add"][piv], pre["res"]) * inv_n
        adj32 = ld_int8.adj_r2(rd, adj_c)
        err = torch.where(near, (adj32.double() - adj).abs(), 0.0)
        worst = max(worst, float(err.max()))
        n_pairs += n_near
    return worst, n_pairs


def assert_counters_equal(port: dict, ref: dict) -> None:
    """Hold two integer-engine results (dicts with ``l2_ws``, ``l2d_ws``,
    ``l2d_wse``) to equal counters."""
    for k in COUNTERS:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        diff = np.flatnonzero(a != b)
        assert not diff.size, (
            f"{k} differs on {diff.size} rows (row, port, reference): "
            f"{[(int(i), int(a[i]), int(b[i])) for i in diff[:10]]}")


def assert_counters_match(port: dict, ref: dict, genotypes,
                          positions: np.ndarray, cfg, tol: float,
                          device="cpu") -> int:
    """Hold an f32-engine result against another result (dicts with
    ``l2_ws``, ``l2d_ws``, ``l2d_wse``) to the contract of the module
    docstring; returns the number of exempted rows (0 when ``l2d_wse`` is
    equal)."""
    for k in ("l2_ws", "l2d_ws"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    a, b = np.asarray(port["l2d_wse"]), np.asarray(ref["l2d_wse"])
    diff = np.flatnonzero(a != b)
    if not diff.size:
        return 0
    near = near_threshold_pairs(genotypes, positions, cfg, diff, tol, device)
    bad = [(int(i), int(a[i]), int(b[i]), int(c))
           for i, c in zip(diff, near) if abs(int(a[i]) - int(b[i])) > c]
    assert not bad, ("l2d_wse differs beyond the contract (row, port, "
                     f"reference, pairs within {tol:.3g} of rsq_thr): {bad}")
    return len(diff)
