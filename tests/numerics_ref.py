"""NumPy references of the port's per-SNP scalars and the F4 input, with
no JAX import: ``tests/test_torch_numerics.py`` and ``chip_smoke.py``
(phase 30) hold the CPU and CUDA scalars to them."""

import numpy as np

#: the F4 shape: the first sighting's chromosome, cut to 64 samples
F4_M, F4_N = 24_576, 64
F4_CFG = dict(ld_wind=100_000, maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3)
FIELDS = ("l2", "l2d", "l2_ws", "l2d_ws", "l2d_wse")


def f4_data(seed: int = 1, m: int = F4_M, n: int = F4_N):
    """Genotypes with local LD (each SNP copies its predecessor at a rate
    drawn from U(0.3, 0.97) per 512 SNPs, as ``chip_smoke.py``'s
    ``synthetic_genotypes``), MAF in [0.05, 0.5], SNPs 100 bp apart."""
    rng = np.random.default_rng(seed)
    rate = np.repeat(rng.uniform(0.3, 0.97, -(-m // 512)), 512)[:m]
    maf = rng.uniform(0.05, 0.5, m)
    fresh = rng.binomial(2, maf[:, None], (m, n)).astype(np.int8)
    keep = rng.random((m, n)) < rate[:, None]
    g = fresh.copy()
    for i in range(1, m):
        g[i] = np.where(keep[i], g[i - 1], fresh[i])
    return g, np.arange(m, dtype=np.float64) * 100.0


def sqrt64(x: np.ndarray) -> np.ndarray:
    """float64 square root rounded to float32: the correctly rounded
    float32 square root."""
    return np.sqrt(x.astype(np.float64)).astype(np.float32)


def reference_scalars(g: np.ndarray, maf_thr: float, n: int) -> dict:
    """The per-SNP scalars of ``ld_int8.finish_preprocess_int8`` from the
    class counts: NumPy float32 operations in the port's order, square
    roots in float64 rounded to float32."""
    f = np.float32
    n_valid = np.maximum((g >= 0).sum(1), 1).astype(f)
    c1 = (g == 1).sum(1).astype(f)
    c2 = (g == 2).sum(1).astype(f)
    c0 = n_valid - c1 - c2
    am = (c1 + f(2) * c2) / n_valid
    maf = np.minimum(am * f(0.5), f(1) - am * f(0.5))
    usable = maf > f(maf_thr)
    va = c0 * c1 + f(4) * c0 * c2 + c1 * c2
    inv = f(1) / np.where(va > 0, va, f(1))
    add_sd = sqrt64(va / n_valid / f(n))
    rstd = sqrt64(f(4) * c0 * c1 * c2 * inv / f(n))
    ok_d = usable & (va > 0)
    one = f(1)
    return {
        "inv_sd": np.where((add_sd > 0) & usable,
                           one / np.where(add_sd > 0, add_sd, one), f(0)),
        "inv_rstd": np.where((rstd > 0) & ok_d,
                             one / np.where(rstd > 0, rstd, one), f(0)),
        "rstd": np.where(ok_d, rstd, f(np.nan)),
        "v": [x * inv for x in (f(-2) * c1 * c2, f(4) * c0 * c2,
                                f(-2) * c0 * c1)],
        "am": am, "usable": usable, "ok_d": ok_d,
    }
