"""Block jackknives in torch float64 (reference semantics:
``nldsc/h2/jackknife.py``).

The fast jackknife forms per-block ``XᵀX`` / ``Xᵀy`` partial sums, solves
the whole-data system once, and gets every leave-one-block-out estimate
from totals minus block: O(M·p²) plus n_blocks p×p solves
(``jackknife.py:303-443``).  The slow variant re-solves the regression
per deleted block (``jackknife.py:214-300``).

Everything runs in float64 on the device of the inputs.  The blocks are
contiguous row ranges, so their sums are fixed-order reductions over a
zero-padded (n_blocks, longest block, ·) tensor, never atomic scatters:
two runs on a card are bitwise equal.  Least squares is Householder QR
(:func:`lstsq_qr`) on every device, so the CPU tests check the algorithm
the card runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.numerics import sqrt_rn


@dataclass
class JackknifeResult:
    est: torch.Tensor            # (1, p) whole-data estimate
    jk_est: torch.Tensor         # (1, p) jackknifed estimate
    jk_var: torch.Tensor         # (1, p)
    jk_std: torch.Tensor         # (1, p)
    jk_cov: torch.Tensor         # (p, p)
    delete_values: torch.Tensor  # (n_blocks, p)
    separators: np.ndarray       # (n_blocks + 1,) host ints


def get_separators(n: int, n_blocks: int) -> np.ndarray:
    """Evenly-spaced block boundaries (jackknife.py:85-91)."""
    return np.floor(np.linspace(0, n, n_blocks + 1)).astype(int)


def block_ids(separators: np.ndarray, n: int) -> np.ndarray:
    """Map each row to its jackknife block (host helper)."""
    return (np.searchsorted(separators[1:-1], np.arange(n), side="right")
            .astype(np.int64))


def lstsq_qr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Least-squares solution of ``x @ b = y`` by Householder QR
    (``x``: (..., n, p) with full column rank, ``y``: (..., n, k))."""
    q, r = torch.linalg.qr(x)
    return torch.linalg.solve_triangular(r, q.mT @ y, upper=True)


def block_sums(v: torch.Tensor, separators: np.ndarray) -> torch.Tensor:
    """Per-block sums of the rows of ``v`` (n, f) -> (n_blocks, f), in a
    fixed order: rows scattered once each into a zero-padded
    (n_blocks, longest block, f) tensor, summed along its middle axis."""
    n = v.shape[0]
    ids = block_ids(separators, n)
    pos = np.arange(n) - separators[ids]
    longest = int(np.diff(separators).max())
    padded = v.new_zeros((len(separators) - 1, longest, v.shape[1]))
    padded[torch.as_tensor(ids, device=v.device),
           torch.as_tensor(pos, device=v.device)] = v
    return padded.sum(dim=1)


def jackknife_moments(pseudovalues: torch.Tensor):
    """Pseudovalues -> (jk_est, jk_var, jk_std, jk_cov) (jackknife.py:57-83).

    ``jk_cov = cov(pseudovalues, ddof=1) / n_blocks``.
    """
    n_blocks = pseudovalues.shape[0]
    mean = pseudovalues.mean(dim=0, keepdim=True)              # (1, p)
    centered = pseudovalues - mean
    cov = centered.T @ centered / (n_blocks - 1) / n_blocks     # (p, p)
    var = torch.diag(cov)[None, :]
    return mean, var, sqrt_rn(var), cov


def delete_values_to_pseudovalues(delete_values: torch.Tensor,
                                  est: torch.Tensor) -> torch.Tensor:
    """``n·est − (n−1)·delete`` (jackknife.py:176-211)."""
    n_blocks = delete_values.shape[0]
    return n_blocks * est - (n_blocks - 1) * delete_values


def _result(est, delete_values, separators) -> JackknifeResult:
    pseudo = delete_values_to_pseudovalues(delete_values, est)
    jk_est, jk_var, jk_std, jk_cov = jackknife_moments(pseudo)
    return JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                           jk_std=jk_std, jk_cov=jk_cov,
                           delete_values=delete_values, separators=separators)


def lstsq_jackknife_fast(x: torch.Tensor, y: torch.Tensor,
                         n_blocks: int | None = None,
                         separators: np.ndarray | None = None
                         ) -> JackknifeResult:
    """Fast block jackknife for the regression y ~ x."""
    n, p = x.shape
    separators = _check_separators(n, n_blocks, separators)
    nb = len(separators) - 1
    rows = torch.cat([(x[:, :, None] * x[:, None, :]).reshape(n, p * p),
                      x * y], dim=1)
    sums = block_sums(rows, separators)
    xtx_b = sums[:, :p * p].reshape(nb, p, p)
    xty_b = sums[:, p * p:]
    xtx = xtx_b.sum(dim=0)
    xty = xty_b.sum(dim=0)
    # solve_ex: no singularity check, so no host sync (a singular system
    # gives non-finite values, as in the JAX package)
    est = torch.linalg.solve_ex(xtx, xty[:, None]).result.reshape(1, p)
    delete = torch.linalg.solve_ex(
        xtx[None] - xtx_b, (xty[None] - xty_b)[..., None]).result
    return _result(est, delete.reshape(nb, p), separators)


def lstsq_jackknife_slow(x: torch.Tensor, y: torch.Tensor,
                         n_blocks: int | None = None,
                         separators: np.ndarray | None = None,
                         nn: bool = False) -> JackknifeResult:
    """Slow jackknife: re-fit per deleted block.  ``nn``: non-negative
    least squares (``scipy.optimize.nnls``, on the host in float64), the
    estimate and the delete values returned on ``x``'s device."""
    n, p = x.shape
    separators = _check_separators(n, n_blocks, separators)
    nb = len(separators) - 1

    if nn:
        from scipy.optimize import nnls  # noqa: PLC0415

        xh = x.detach().cpu().double().numpy()
        yh = y.detach().cpu().double().numpy().ravel()
        rows = [nnls(xh, yh)[0]]
        for j in range(nb):
            keep = np.r_[0:separators[j], separators[j + 1]:n]
            rows.append(nnls(xh[keep], yh[keep])[0])
        fits = torch.from_numpy(np.stack(rows)).to(device=x.device,
                                                   dtype=x.dtype)
        return _result(fits[:1], fits[1:], separators)

    est = lstsq_qr(x, y).reshape(1, p)
    rows = []
    for j in range(nb):
        # zeroed rows leave the (full-rank) least-squares minimizer unchanged
        mask = torch.ones((n, 1), dtype=x.dtype, device=x.device)
        mask[separators[j]:separators[j + 1]] = 0.0
        rows.append(lstsq_qr(x * mask, y * mask).reshape(p))
    return _result(est, torch.stack(rows), separators)


def ratio_jackknife(est: torch.Tensor, numer_delete: torch.Tensor,
                    denom_delete: torch.Tensor) -> JackknifeResult:
    """Jackknife for a ratio estimate (jackknife.py:446-527)."""
    nb = numer_delete.shape[0]
    delete = numer_delete / denom_delete
    pseudo = nb * est - (nb - 1) * delete
    jk_est, jk_var, jk_std, jk_cov = jackknife_moments(pseudo)
    return JackknifeResult(est=est, jk_est=jk_est, jk_var=jk_var,
                           jk_std=jk_std, jk_cov=jk_cov,
                           delete_values=delete, separators=np.array([]))


def _check_separators(n: int, n_blocks: int | None,
                      separators: np.ndarray | None) -> np.ndarray:
    if separators is not None:
        separators = np.sort(np.asarray(separators))
        if separators[0] != 0 or separators[-1] != n:
            raise ValueError("separators must span [0, n]")
        return separators
    if n_blocks is None:
        raise ValueError("Must specify either n_blocks or separators.")
    if n_blocks > n:
        raise ValueError("More blocks than data points.")
    return get_separators(n, n_blocks)
