"""End-to-end heritability estimation (the ``h2`` command).

Mirrors ``nldsc/h2/routine.py``: read sumstats and LD scores, inner-join
on SNP (the sumstats' row order), χ² = Z², drop SNPs with χ² ≥ chisq_max
(dropped, not capped — quirk Q11), then the two-stage additive+dominance
regression (or the joint ``one-stg`` fit).  The regression runs in
float64 on ``device``: ``cuda`` (the default; an error without a GPU) or
``cpu``.  Reading and joining the tables is numpy on the host.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..config import H2Config
from ..core.errors import NLDSCParameterError
from ..core.logging import log
from ..core.timing import elapsed_time
from ..io.ldscores import read_ld_scores, read_ld_scores_partitioned
from ..io.sumstats import read_sumstats
from ..io.tables import Table, inner_join
from ..ld.pipeline import resolve_device
from .regression import (h2_obs_to_liability, hsq_estimate,
                         hsq_estimate_onestage, hsq_partitioned)


def merge_ld_sumstats(sumstats: Table, ld: Table) -> Table:
    """Inner join on SNP (reference h2/utils.py:29-40)."""
    out = inner_join(sumstats, ld)
    log.info("After merging with [reference panel LD/regression SNP LD], "
             "%d SNPs remain", len(out))
    if len(out) == 0:
        raise RuntimeError("No SNPs remain after merging sumstats with LD scores")
    return out


def prettify_summary(summary: dict) -> str:
    text = "\n========================= h2 summary =========================\n"
    text += (f"Additive h2: {summary['additive']['hsq']:.4f} "
             f"± std: {summary['additive']['hsq.std']:.4f}\n")
    text += (f"lambda GC: {summary['additive']['lambda_gc']:.4f}, "
             f"chi2 mean: {summary['additive']['chisq.mean']:.4f}\n")
    text += (f"Dominant h2: {summary['dominant']['hsq']:.4e} "
             f"± std: {summary['dominant']['hsq.std']:.4e}\n")
    if "residuals.mean" in summary["dominant"]:
        text += f"residuals mean: {summary['dominant']['residuals.mean']:.4e}\n"
    return text


def attempt_save(filename: str, summary: dict) -> None:
    """JSON save that refuses to overwrite (reference h2/utils.py:52-58)."""
    if Path(filename).is_file():
        raise FileExistsError("File already exists")
    with open(filename, "w") as f:
        json.dump(summary, f)


def _cols(x, n: int, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64).reshape(n, 1),
                           device=device)


def drop_large_chisq(overall: Table, chisq_max: float | None):
    """The rows with χ² < chisq_max (default max(1e-3·N_max, 80) over
    ``overall``) and their χ²."""
    chisq = np.asarray(overall["Z"], dtype=np.float64) ** 2
    if chisq_max is None:
        chisq_max = max(0.001 * overall["N"].max(), 80)
    keep = chisq < chisq_max
    log.info("Removed %d SNPs with chi^2 > %s (%d SNPs remain)",
             len(keep) - int(keep.sum()), chisq_max, int(keep.sum()))
    return overall.take(keep), chisq[keep]


def estimate_h2_frames(sumstats: Table, ld: Table, M: int, MD: int,
                       config: H2Config, w_ld: Table | None = None) -> dict:
    """Core h2 estimation on already-loaded tables (reference _estimate_h2).

    ``w_ld``: optional separate regression-weight LD scores (columns SNP,
    L2, L2D): the additive stage weights on its L2, the dominance stage on
    its L2D.  Runs on ``config.device``.
    """
    dev = resolve_device(config.device)
    overall = merge_ld_sumstats(sumstats, ld)
    if w_ld is not None:
        overall = inner_join(overall, Table(SNP=w_ld["SNP"],
                                            _W_L2=w_ld["L2"],
                                            _W_L2D=w_ld["L2D"]))
        log.info("After merging with weight LD scores, %d SNPs remain",
                 len(overall))
        if len(overall) == 0:
            raise RuntimeError(
                "No SNPs remain after merging with weight LD scores")
    overall, chisq = drop_large_chisq(overall, config.chisq_max)
    n = len(overall)
    cols = {k: _cols(overall[k], n, dev) for k in ("L2", "L2D", "N")}
    w_add = _cols(overall["_W_L2"], n, dev) if w_ld is not None else cols["L2"]
    w_dom = (_cols(overall["_W_L2D"], n, dev) if w_ld is not None
             else cols["L2D"])
    M_add = torch.tensor([[M]], dtype=torch.float64, device=dev)
    M_dom = torch.tensor([[MD]], dtype=torch.float64, device=dev)
    chisq = _cols(chisq, n, dev)
    if config.strategy == "one-stg":
        return hsq_estimate_onestage(
            chisq=chisq, x_add=cols["L2"], x_dom=cols["L2D"], w_ld=w_add,
            N=cols["N"], M_add=M_add, M_dom=M_dom, n_blocks=config.n_blocks,
            intercept=config.intercept_h2, slow=config.slow_jackknife)
    return hsq_estimate(
        chisq=chisq, x_add=cols["L2"], w_add=w_add, x_dom=cols["L2D"],
        w_dom=w_dom, N=cols["N"], M_add=M_add, M_dom=M_dom,
        n_blocks=config.n_blocks, intercept_add=config.intercept_h2,
        slow=config.slow_jackknife, two_step=config.two_step)


def prettify_partitioned_summary(summary: dict) -> str:
    text = "\n==================== partitioned h2 summary ====================\n"
    text += (f"Total observed-scale h2: {summary['total']['hsq']:.4f} "
             f"± std: {summary['total']['hsq.std']:.4f}\n")
    text += (f"lambda GC: {summary['lambda_gc']:.4f}, "
             f"chi2 mean: {summary['chisq.mean']:.4f}, "
             f"intercept: {summary['intercept']:.4f}"
             f" ± {summary['intercept.std']:.4f}\n")
    text += f"{'annotation':<24}{'h2':>12}{'std':>12}{'prop':>10}{'enrich':>10}\n"
    for name, part in summary["annotations"].items():
        text += (f"{name:<24}{part['hsq']:>12.4f}{part['hsq.std']:>12.4f}"
                 f"{part['prop']:>10.4f}{part['enrichment']:>10.4f}\n")
    return text


@elapsed_time
def estimate_h2_partitioned(
    sumstats: str,
    ref_ld: str,
    w_ld: str,
    n_blocks: int = 200,
    intercept_h2: float | None = None,
    chisq_max: float | None = None,
    use_m: bool = False,
    save_to_json: str | None = None,
    device="cuda",
) -> dict:
    """Partitioned (multi-annotation) heritability estimation.

    ``ref_ld`` is a .L2 file or directory whose non-key columns are
    per-annotation LD scores, with .M/.M_5_50 sidecars carrying
    per-annotation SNP counts; ``w_ld`` supplies the (single-column)
    regression-weight LD scores and may differ from ``ref_ld``.
    """
    dev = resolve_device(device)
    log.info("Reading GWAS summary statistics...")
    ss = read_sumstats(sumstats, alleles=False, dropna=True)

    log.info("Reading partitioned LD Scores...")
    ref, M_annot, annots = read_ld_scores_partitioned(ref_ld, use_m=use_m)

    if w_ld == ref_ld and annots == ["L2"]:
        w_frame = Table(SNP=ref["SNP"], _WLD=ref["L2"])
    elif w_ld == ref_ld:
        # standard LDSC convention: weights = sum over annotations
        w_frame = Table(SNP=ref["SNP"],
                        _WLD=np.stack([ref[a] for a in annots], 1).sum(1))
    else:
        w_scores, _, w_annots = read_ld_scores_partitioned(w_ld, use_m=use_m)
        if len(w_annots) != 1:
            raise NLDSCParameterError(
                "--w-ld must be a single-annotation LD score file")
        w_frame = Table(SNP=w_scores["SNP"], _WLD=w_scores[w_annots[0]])

    overall = merge_ld_sumstats(
        ss, Table((k, ref[k]) for k in ("SNP", *annots)))
    overall = inner_join(overall, w_frame)
    if len(overall) == 0:
        raise RuntimeError("No SNPs remain after merging with weight LD scores")
    overall, chisq = drop_large_chisq(overall, chisq_max)
    n = len(overall)

    x = torch.as_tensor(np.stack([np.asarray(overall[a], dtype=np.float64)
                                  for a in annots], 1), device=dev)
    res = hsq_partitioned(_cols(chisq, n, dev), x,
                          _cols(overall["_WLD"], n, dev),
                          _cols(overall["N"], n, dev),
                          torch.as_tensor(M_annot, dtype=torch.float64,
                                          device=dev),
                          n_blocks=n_blocks, intercept=intercept_h2)

    cat = res.category.value.cpu().numpy()
    cat_std = res.category.std.cpu().numpy()
    prop = res.proportion.value.cpu().numpy().ravel()
    prop_std = res.proportion.std.cpu().numpy().ravel()
    enrich = res.enrichment.cpu().numpy()
    m_prop = res.M_prop.cpu().numpy().ravel()
    summary = {
        "total": {"hsq": res.total.value, "hsq.std": res.total.std},
        "annotations": {
            name: {
                "hsq": float(cat[i]),
                "hsq.std": float(cat_std[i]),
                "prop": float(prop[i]),
                "prop.std": float(prop_std[i]),
                "enrichment": float(enrich[i]),
                "M": float(np.ravel(M_annot)[i]),
                "M.prop": float(m_prop[i]),
            } for i, name in enumerate(annots)
        },
        "lambda_gc": res.lambda_gc,
        "chisq.mean": res.mean_chisq,
        "intercept": res.intercept.value,
        "intercept.std": res.intercept.std,
        "intercept.constrained": res.constrain_intercept,
    }
    print(prettify_partitioned_summary(summary))
    if save_to_json:
        attempt_save(save_to_json, summary)
    return summary


@elapsed_time
def estimate_h2(
    sumstats: str,
    ldscore: str,
    n_blocks: int = 200,
    intercept_h2: float | None = None,
    chisq_max: float | None = None,
    use_m: bool = False,
    two_step: float | None = None,
    strategy: str = "two-stg",
    save_to_json: str | None = None,
    samp_prev: float | None = None,
    pop_prev: float | None = None,
    w_ldscore: str | None = None,
    device="cuda",
) -> dict:
    """Estimate additive + dominance heritability (reference estimate_h2).

    Returns the summary dict (and optionally saves it as JSON).
    ``samp_prev``/``pop_prev``: case/control prevalences; with both, the
    summary gains liability-scale h².  ``w_ldscore``: optional separate
    regression-weight LD scores.
    """
    resolve_device(device)
    log.info("Reading GWAS summary statistics...")
    ss = read_sumstats(sumstats, alleles=False, dropna=True)

    log.info("Reading LD Scores...")
    ld, M, MD = read_ld_scores(ldscore, use_m=use_m)

    w_frame = None
    if w_ldscore is not None and w_ldscore != ldscore:
        log.info("Reading weight LD Scores...")
        w_frame, _, _ = read_ld_scores(w_ldscore, use_m=use_m)

    # chisq_max and two_step are filled here, from the unmerged sumstats
    if chisq_max is None:
        chisq_max = max(ss["N"].max() * 1e-3, 80)
    if two_step is None and intercept_h2 is None:
        two_step = 30
    config = H2Config(n_blocks=n_blocks, intercept_h2=intercept_h2,
                      chisq_max=chisq_max, two_step=two_step,
                      strategy=strategy, use_m=use_m, device=device)

    log.info("Estimating heritability on %s...", config.device)
    result = estimate_h2_frames(ss, ld, M, MD, config, w_ld=w_frame)
    summary = result["summary"]

    if samp_prev is not None and pop_prev is not None:
        factor = h2_obs_to_liability(1.0, samp_prev, pop_prev)
        for part in ("additive", "dominant"):
            summary[part]["hsq.liability"] = summary[part]["hsq"] * factor
            summary[part]["hsq.liability.std"] = (
                summary[part]["hsq.std"] * factor)

    print(prettify_summary(summary))

    if save_to_json:
        attempt_save(save_to_json, summary)
    return summary
