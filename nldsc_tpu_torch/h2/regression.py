"""LD-score regression estimators (reference: ``nldsc/h2/regressions.py``),
in torch float64 on the device of the inputs.

One routine (:func:`ldscore_regression`) parameterized by a null intercept
and a weights function, plus thin additive/dominant/partitioned
front-ends.  Behavioral parity notes (the reference's runtime behavior,
SURVEY §2.3-Q11/Q12):

* regressors are pre-scaled by ``N / N̄`` (regressions.py:166-167)
* ``hsq`` inside weight updates is ``M·coef / (N̄ − 1)`` (regressions.py:437)
* the two-step estimator fits a free-intercept model on SNPs with
  ``χ² < two_step``, then a constrained model on all SNPs, and combines the
  jackknives with the correction factor ``c`` (regressions.py:179-209,325-348)
* step-1 weight updates read the *N-scaled* LD column, step-2 and
  plain-path updates the raw column (an asymmetry the reference has)
* the dominance stage regresses additive-model residuals
  ``reweigh(χ² − L2·N̄·coef − intercept, w_final_additive)`` with intercept
  constrained to 0 and the ``+1e-10``-guarded weight function; it runs
  the 2 IRWLS weight iterations
* weights clip ``hsq∈[0,1]``, ``ld,w_ld ≥ 1`` (regressions.py:496-498)
* the dominance summary reports the *additive* intercept's std (Q12)

Host syncs, which are part of the semantics: the ``w <= 0`` checks of
``irwls.wls``/``reweigh``, the two-step mask, and the scalar fields of
:class:`HsqResult` (``total``, ``intercept``, ``mean_chisq``,
``lambda_gc``) read as Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.logging import log
from . import irwls
from . import jackknife as jk

F64 = torch.float64


@dataclass
class Coefficient:
    value: object
    cov: object = None
    std: object = None


@dataclass
class HsqResult:
    jknife: jk.JackknifeResult
    coef: Coefficient          # per-annotation coefficient (value: (p,))
    category: Coefficient      # per-category h2
    total: Coefficient         # total h2 (floats)
    proportion: Coefficient
    enrichment: torch.Tensor
    M_prop: torch.Tensor
    intercept: Coefficient
    constrain_intercept: bool
    mean_chisq: float
    lambda_gc: float
    ratio: Coefficient | None
    tot_delete_values: torch.Tensor
    weights_checkpoint: torch.Tensor  # final IRWLS weights (pre-sqrt)


def h2_obs_to_liability(h2_obs: float, P: float, K: float) -> float:
    """Observed-scale h² in an ascertained sample -> liability-scale h²
    (reference regressions.py:30-58).

    P: sample prevalence; K: population prevalence (both in (0,1);
    NaN/NaN passes h2_obs through unchanged).
    """
    from scipy import stats as ss  # noqa: PLC0415

    if np.isnan(P) and np.isnan(K):
        return h2_obs
    if not 0 < K < 1:
        raise ValueError("K must be in the range (0, 1)")
    if not 0 < P < 1:
        raise ValueError("P must be in the range (0, 1)")
    thresh = ss.norm.isf(K)
    conversion = K**2 * (1 - K)**2 / (P * (1 - P) * ss.norm.pdf(thresh)**2)
    return h2_obs * conversion


def _weights(ld, w_ld, N, M_tot, hsq, intercept, guard: float):
    hsq = torch.clamp(hsq, 0.0, 1.0)
    ld = torch.clamp(ld, min=1.0)
    w_ld = torch.clamp(w_ld, min=1.0)
    c = hsq * (N - 1) / M_tot
    het_w = 1.0 / (2.0 * torch.square(intercept + c * ld) + guard)
    # floor at the dtype's smallest normal, as the JAX package does for
    # its float32 path; in float64 it cannot bind on data the reference
    # accepts
    return torch.clamp(het_w / w_ld, min=torch.finfo(het_w.dtype).tiny)


def weights_additive(ld, w_ld, N, M_tot, hsq, intercept=None):
    """Heteroskedasticity × overcounting weights (regressions.py:465-503)."""
    return _weights(ld, w_ld, N, M_tot, hsq,
                    1.0 if intercept is None else intercept, 0.0)


def weights_dominant(ld, w_ld, N, M_tot, hsq, intercept=None):
    """Dominance weights: +1e-10 guard for the zero intercept
    (regressions.py:557-595)."""
    return _weights(ld, w_ld, N, M_tot, hsq,
                    1.0 if intercept is None else intercept, 1e-10)


def _aggregate(y, x_tot, N, M_tot, intercept):
    """Initial h² guess (regressions.py:255-261)."""
    return M_tot * (torch.mean(y) - intercept) / torch.mean(x_tot * N)


def _remap_separators(separators: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Map step-1 (masked-subset) separators to full-data indices
    (update_stdparators, regressions.py:61-68)."""
    maplist = np.flatnonzero(mask)
    inner = maplist[separators[1:-1]]
    return np.hstack([0, inner, len(mask)])


def _prep_design(x, M, N, con: bool):
    """Regression preamble: M_tot, the raw total LD column, N̄, the
    N-scaled design and the design the weight updates read."""
    M_tot = torch.sum(M)
    x_tot_raw = torch.sum(x, dim=1).reshape(x.shape[0], 1)
    N_mean = torch.mean(N)
    x_scaled = (N * x) / N_mean
    if not con:
        ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return (M_tot, x_tot_raw, N_mean, x_scaled,
                torch.cat([x_scaled, ones], dim=1),
                torch.cat([x_tot_raw, ones], dim=1))
    return M_tot, x_tot_raw, N_mean, x_scaled, x_scaled, x_tot_raw


def _extract_core(est, jk_cov, delete_values, M, N_mean):
    """Coefficient/category/proportion-input extraction
    (regressions.py:226-323)."""
    p = M.shape[1]
    coef_val = est[0, :p] / N_mean
    coef_cov = jk_cov[:p, :p] / N_mean**2
    coef_std = torch.sqrt(torch.diag(coef_cov))
    cat_val = (M * coef_val).reshape(p)
    cat_cov = (M.T @ M) * coef_cov
    cat_std = torch.sqrt(torch.diag(cat_cov))
    tot_val = torch.sum(cat_val)
    tot_cov = torch.sum(cat_cov)
    nb = delete_values.shape[0]
    numer_delete = (M * delete_values[:, :p]) / N_mean
    denom_delete = (torch.sum(numer_delete, dim=1).reshape(nb, 1)
                    @ torch.ones((1, p), dtype=M.dtype, device=M.device))
    tot_delete_values = (delete_values[:, :p] @ M.T) / N_mean
    return (coef_val, coef_cov, coef_std, cat_val, cat_cov, cat_std,
            tot_val, tot_cov, numer_delete, denom_delete,
            tot_delete_values)


def _check_shapes(y, x, w, N, M):
    n, p = x.shape
    for name, a in (("y", y), ("w", w), ("N", N)):
        if a.shape != (n, 1):
            raise ValueError(
                f"{name} must have shape ({n}, 1), got {tuple(a.shape)}")
    if M.shape != (1, p):
        raise ValueError(f"M must have shape (1, {p}), got {tuple(M.shape)}")
    return n, p


def median(y: torch.Tensor) -> torch.Tensor:
    """``np.median`` for any length: the mean of the two middle values
    when the count is even (``torch.median`` returns the lower one)."""
    s = torch.sort(y.reshape(-1)).values
    k = s.numel() // 2
    return s[k] if s.numel() % 2 else (s[k - 1] + s[k]) / 2


def ldscore_regression(
    y, x, w, N, M,
    n_blocks: int,
    null_intercept: float,
    weights_fn,
    intercept: float | None = None,
    slow: bool = False,
    two_step: float | None = None,
) -> HsqResult:
    """Run one LD-score regression (additive or dominance partition) in
    float64 on the device of ``y`` (numpy inputs: the CPU)."""
    y = torch.as_tensor(y, dtype=F64)
    x, w, N, M = (torch.as_tensor(a, dtype=F64, device=y.device)
                  for a in (x, w, N, M))
    n_snp, n_annot = _check_shapes(y, x, w, N, M)
    constrain = intercept is not None

    (M_tot, x_tot_raw, N_mean, x_scaled, x_design,
     x_tot_func) = _prep_design(x, M, N, con=constrain)
    yp = y if not constrain else y - intercept

    agg_intercept = intercept if constrain else null_intercept
    tot_agg = _aggregate(y, x_tot_raw, N, M_tot, agg_intercept)

    checkpoint = {}
    initial_w = weights_fn(x_tot_raw, w, N, M_tot, tot_agg,
                           intercept if constrain else null_intercept)
    checkpoint["w"] = initial_w

    if two_step is not None and constrain:
        raise ValueError("two-step is not compatible with constrain_intercept.")
    if two_step is not None and n_annot > 1:
        raise ValueError("two-step not compatible with partitioned LD Score yet.")

    if two_step is not None:
        mask = (y < two_step).cpu().numpy().ravel()
        n1 = int(mask.sum())
        midx = torch.as_tensor(np.flatnonzero(mask), device=y.device)
        x1 = x_design[midx]
        yp1, w1, N1, iw1 = (a[midx].reshape(n1, 1)
                            for a in (yp, w, N, initial_w))

        def update1(coef):
            hsq = M_tot * coef[0, 0] / (N_mean - 1.0)
            icept = coef[1, 0]
            ld = x1[:, 0].reshape(n1, 1)      # N-scaled column (see module doc)
            new_w = weights_fn(ld, w1, N1, M_tot, hsq, icept)
            checkpoint["w"] = new_w
            return new_w

        step1 = irwls.irwls(x1, yp1, update1, n_blocks, w=iw1, slow=slow)
        step1_int = step1.est[0, n_annot]

        yp = yp - step1_int
        x_design = x_design[:, :n_annot]

        def update2(coef):
            hsq = M_tot * coef[0, 0] / (N_mean - 1.0)
            ld = x_tot_raw[:, 0].reshape(n_snp, 1)
            new_w = weights_fn(ld, w, N, M_tot, hsq, step1_int)
            checkpoint["w"] = new_w
            return new_w

        separators = _remap_separators(step1.separators, mask)
        step2 = irwls.irwls(x_design, yp, update2, n_blocks, w=initial_w,
                            slow=slow, separators=separators)

        c = (torch.sum(initial_w * x_design)
             / torch.sum(initial_w * torch.square(x_design)))
        jknife = _combine_twostep(step1, step2, c, n_annot)
    else:
        def update(coef):
            hsq = M_tot * coef[0, 0] / (N_mean - 1.0)
            icept = coef[1, 0] if not constrain else intercept
            ld = x_tot_func[:, 0].reshape(n_snp, 1)
            new_w = weights_fn(ld, w, N, M_tot, hsq, icept)
            checkpoint["w"] = new_w
            return new_w

        jknife = irwls.irwls(x_design, yp, update, n_blocks, w=initial_w,
                             slow=slow)

    p = n_annot
    (coef_val, coef_cov, coef_std, cat_val, cat_cov, cat_std, tot_val_t,
     tot_cov_t, numer_delete, denom_delete,
     tot_delete_values) = _extract_core(
        jknife.est, jknife.jk_cov, jknife.delete_values, M, N_mean)
    coef = Coefficient(coef_val, coef_cov, coef_std)
    category = Coefficient(cat_val, cat_cov, cat_std)
    tot_val = float(tot_val_t)
    tot_cov = float(tot_cov_t)
    total = Coefficient(tot_val, tot_cov, float(np.sqrt(tot_cov)))

    prop = jk.ratio_jackknife((cat_val / tot_val).reshape(1, p),
                              numer_delete, denom_delete)
    proportion = Coefficient(prop.est, prop.jk_cov, prop.jk_std)

    M_prop = M / M_tot
    enrichment = (cat_val / M.reshape(p)) / (tot_val / M_tot)

    if not constrain:
        icept_out = Coefficient(float(jknife.est[0, p]),
                                std=float(jknife.jk_std[0, p]))
    else:
        icept_out = Coefficient(float(intercept), std=float("nan"))

    mean_chisq = float(torch.mean(y))
    lambda_gc = float(median(y) / 0.4549)
    ratio = None
    if not constrain:
        if mean_chisq > 1.0:
            ratio = Coefficient(
                (icept_out.value - 1.0) / (mean_chisq - 1.0),
                std=icept_out.std / (mean_chisq - 1.0))
        else:
            ratio = Coefficient(float("nan"), std=float("nan"))

    return HsqResult(
        jknife=jknife, coef=coef, category=category, total=total,
        proportion=proportion, enrichment=enrichment, M_prop=M_prop,
        intercept=icept_out, constrain_intercept=constrain,
        mean_chisq=mean_chisq, lambda_gc=lambda_gc, ratio=ratio,
        tot_delete_values=tot_delete_values,
        weights_checkpoint=checkpoint["w"],
    )


def _combine_twostep(step1: jk.JackknifeResult, step2: jk.JackknifeResult,
                     c, n_annot: int) -> jk.JackknifeResult:
    """Combine free- and constrained-intercept jackknives
    (regressions.py:325-348)."""
    nb = step1.delete_values.shape[0]
    step1_int = step1.est[0, n_annot]
    est = torch.cat([step2.est, step1_int.reshape(1, 1)], dim=1)
    dv_int = step1.delete_values[:, n_annot].reshape(nb, 1)
    dv_coef = step2.delete_values - c * (dv_int - step1_int)
    delete = torch.cat([dv_coef, dv_int], dim=1)
    pseudo = jk.delete_values_to_pseudovalues(delete, est)
    jk_est, jk_var, jk_std, jk_cov = jk.jackknife_moments(pseudo)
    return jk.JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                              jk_std=jk_std, jk_cov=jk_cov,
                              delete_values=delete,
                              separators=step2.separators)


def hsq_additive(chisq, x, w_ld, N, M, n_blocks=200, intercept=None,
                 slow=False, two_step=None) -> HsqResult:
    """Additive partition (reference HSQAdditive, null intercept 1.0)."""
    return ldscore_regression(
        chisq, x, w_ld, N, M, n_blocks,
        null_intercept=1.0, weights_fn=weights_additive,
        intercept=intercept, slow=slow, two_step=two_step)


def hsq_dominant(chisq, x_dom, w_dom, w_add_ld, N, M_dom, n_blocks,
                 slow, add_result: HsqResult) -> HsqResult:
    """Dominance partition regressing additive-model residuals
    (reference HSQDominant, regressions.py:524-554)."""
    chisq = torch.as_tensor(chisq, dtype=F64)
    w_add_ld, N = (torch.as_tensor(a, dtype=F64, device=chisq.device)
                   for a in (w_add_ld, N))
    beta = torch.mean(N) * add_result.coef.value[0]
    icept = add_result.intercept.value
    weights = add_result.weights_checkpoint
    residuals = irwls.reweigh(chisq - w_add_ld * beta - icept, weights)
    return ldscore_regression(
        residuals, x_dom, w_dom, N, M_dom, n_blocks,
        null_intercept=0.0, weights_fn=weights_dominant,
        intercept=0.0, slow=slow, two_step=None)


def hsq_partitioned(chisq, x_annot, w_ld, N, M_annot, n_blocks=200,
                    intercept=None, slow=False) -> HsqResult:
    """Partitioned (multi-annotation) additive h² regression: ``x_annot``
    (n, p) per-annotation LD scores, ``M_annot`` (1, p) SNP counts; the
    intercept is free or constrained (no two-step for p > 1)."""
    return ldscore_regression(
        chisq, x_annot, w_ld, N, M_annot, n_blocks,
        null_intercept=1.0, weights_fn=weights_additive,
        intercept=intercept, slow=slow, two_step=None)


def hsq_estimate_onestage(chisq, x_add, x_dom, w_ld, N, M_add, M_dom,
                          n_blocks=200, intercept=None, slow=False) -> dict:
    """Joint single-stage estimator (the reference's declared-but-absent
    ``one-stg`` strategy): χ² on [L2, L2D] as a 2-annotation partitioned
    model with one shared intercept and one joint block jackknife."""
    chisq = torch.as_tensor(chisq, dtype=F64)
    x_add, x_dom, M_add, M_dom = (
        torch.as_tensor(a, dtype=F64, device=chisq.device)
        for a in (x_add, x_dom, M_add, M_dom))
    n = chisq.shape[0]
    x = torch.cat([x_add.reshape(n, 1), x_dom.reshape(n, 1)], dim=1)
    M_annot = torch.cat([M_add.reshape(1, 1), M_dom.reshape(1, 1)], dim=1)
    log.info("Estimating additive + non-additive heritability jointly...")
    joint = hsq_partitioned(chisq, x, w_ld, N, M_annot, n_blocks=n_blocks,
                            intercept=intercept, slow=slow)
    cat = joint.category.value.cpu().numpy()
    cat_std = joint.category.std.cpu().numpy()
    summary = {
        "additive": {
            "hsq": float(cat[0]),
            "hsq.std": float(cat_std[0]),
            "lambda_gc": joint.lambda_gc,
            "chisq.mean": joint.mean_chisq,
            "intercept": joint.intercept.value,
            "intercept.std": joint.intercept.std,
            "intercept.constrained": joint.constrain_intercept,
        },
        "dominant": {
            "hsq": float(cat[1]),
            "hsq.std": float(cat_std[1]),
            "intercept": joint.intercept.value,
            "intercept.std": joint.intercept.std,
        },
        "strategy": "one-stg",
    }
    return {"summary": summary, "joint": joint}


def hsq_estimate(chisq, x_add, w_add, x_dom, w_dom, N, M_add, M_dom,
                 n_blocks=200, intercept_add=None, slow=False,
                 two_step=None) -> dict:
    """Additive then dominance estimation + summary dict
    (reference HSQEstimator, regressions.py:598-641)."""
    log.info("Estimating additive heritability...")
    additive = hsq_additive(chisq, x_add, w_add, N, M_add, n_blocks,
                            intercept_add, slow, two_step)
    log.info("Estimating non-additive heritability...")
    dominant = hsq_dominant(chisq, x_dom, w_dom, w_add, N, M_dom,
                            n_blocks, slow, additive)
    summary = {
        "additive": {
            "hsq": additive.total.value,
            "hsq.std": additive.total.std,
            "lambda_gc": additive.lambda_gc,
            "chisq.mean": additive.mean_chisq,
            "intercept": additive.intercept.value,
            "intercept.std": additive.intercept.std,
            "intercept.constrained": additive.constrain_intercept,
        },
        "dominant": {
            "hsq": dominant.total.value,
            "hsq.std": dominant.total.std,
            "residuals.mean": dominant.mean_chisq,
            "intercept": dominant.intercept.value,
            # parity quirk Q12: the reference reports the ADDITIVE
            # intercept's std here (regressions.py:637)
            "intercept.std": additive.intercept.std,
        },
    }
    return {"summary": summary, "additive": additive, "dominant": dominant}
