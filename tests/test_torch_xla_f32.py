"""F2: the port's float32 arithmetic is the one XLA compiles the JAX
package into (``nldsc_tpu_torch/core/numerics.py``).

(a) ``fma_rn`` is a correctly rounded float32 fused multiply-add, held to
exact rational arithmetic, on seeded values and on cases that a float64
sum cast to float32 rounds twice; (b) the pair epilogue
(``ld_int8.corr_from_dots`` and ``adj_r2``) is bitwise the jitted JAX
expressions on products of seeded genotypes, on its four branches; (c)
the per-SNP scalars of ``preprocess_int8`` are bitwise the JAX
package's, at N up to a chromosome's 16,384 samples, where ``va`` is a
sum of products past 2^24 and its contraction shows.
"""

from fractions import Fraction
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nldsc_tpu.ld import ld_int8 as jax_int8
from nldsc_tpu_torch.core.numerics import _round_to_odd, fma_rn, recip_f32
from nldsc_tpu_torch.ld import ld_int8

from utils import random_genotypes

N_SAMPLES = (150, 333, 1500)


def _exact_f32(a, b, c) -> np.ndarray:
    """``a·b + c`` of float32 arrays, exact, rounded once to float32 (ties
    to even)."""
    out = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        v = Fraction(x) * Fraction(y) + Fraction(z)
        f = np.float32(float(v))
        near = [f, np.nextafter(f, np.float32(np.inf)),
                np.nextafter(f, np.float32(-np.inf))]
        out.append(min(near, key=lambda t: (abs(Fraction(float(t)) - v),
                                            int(np.float32(t).view(np.int32))
                                            & 1)))
    return np.array(out, dtype=np.float32)


def _double_rounding_cases(rng, count: int):
    """A seeded search for float32 triples whose float64 ``a·b + c``, cast
    to float32, is not the correctly rounded value: ``c`` in [1, 2) and
    ``a·b`` within a float64 rounding of half a float32 ulp of ``c``."""
    a = (rng.uniform(1.0, 2.0, count) * 2.0 ** -12).astype(np.float32)
    b = (2.0 ** -24 / a.astype(np.float64)).astype(np.float32)
    sign = np.where(rng.random(count) < 0.5, 1.0, -1.0).astype(np.float32)
    c = rng.uniform(1.0, 2.0, count).astype(np.float32)
    return a, b * sign, c


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("case", ["seeded", "double_rounding", "tiny"])
def test_fma_rn_is_correctly_rounded(case):
    rng = np.random.default_rng(13)
    if case == "seeded":
        a, b, c = (rng.standard_normal(3000).astype(np.float32)
                   for _ in range(3))
    elif case == "double_rounding":
        a, b, c = _double_rounding_cases(rng, 3000)
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
        # the search found cases that a float64 sum gets wrong
        assert (_bits(naive) != _bits(_exact_f32(a, b, c))).sum() >= 10
    else:
        # results in and around float32's subnormal range
        a, b = (rng.standard_normal(3000).astype(np.float32) * 1e-20
                for _ in range(2))
        c = (rng.standard_normal(3000) * 1e-39).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = fma_rn(ta, tb, tc)
    assert got.dtype == torch.float32
    want = _bits(_exact_f32(a, b, c))
    np.testing.assert_array_equal(_bits(got), want)
    # the GPU's path: every entry rounded to odd before the cast
    p = ta.double() * tb.double()
    full = _round_to_odd(p + tc.double(), p, tc.double())
    np.testing.assert_array_equal(_bits(full.to(torch.float32)), want)


def test_fma_rn_broadcasts_and_takes_python_floats():
    # a constructed double rounding: 2^-12(1 + 2896·2^-23) · 2^-12(1 -
    # 2895·2^-23) = 2^-24 (1 + 4688·2^-46), so 1 + that lies just above
    # the float32 tie 1 + 2^-24; float64 rounds it onto the tie
    a = np.float32(2.0 ** -12 * (1 + 2896 * 2.0 ** -23))
    b = np.float32(2.0 ** -12 * (1 - 2895 * 2.0 ** -23))
    assert np.float32(np.float64(a) * np.float64(b) + 1.0) == np.float32(1.0)
    col = torch.full((3, 1), float(a))
    row = torch.full((1, 4), float(b))
    got = fma_rn(col, row, 1.0)
    assert got.shape == (3, 4)
    assert (got == np.float32(1.0 + 2.0 ** -23)).all()
    assert fma_rn(float(a), row, 1.0).shape == (1, 4)
    assert recip_f32(150) == float(np.float32(0.00666666683))


@partial(jax.jit, static_argnames=("n", "n_pad", "has_missing",
                                   "symmetric"))
def _jax_epilogue(dots, sc_i, sc_j, *, n, n_pad, has_missing, symmetric):
    """The JAX package's epilogue, jitted as its engines jit it (n static):
    the correlations and their adjusted r²."""
    n32 = jnp.float32(n)
    adj_c = (n32 - 1.0) / (n32 - 2.0)
    rs = jax_int8.corr_from_dots(
        dots, jax_int8.scal_views(sc_i, "col"),
        jax_int8.scal_views(sc_j, "row"), n32, jnp.float32(n_pad),
        has_missing, symmetric)
    return rs + tuple(1.0 - (1.0 - r * r) * adj_c for r in rs)


def _codes(rng, m, n, has_missing):
    g = random_genotypes(rng, m, n, missing_rate=0.03 if has_missing else 0)
    n_pad = -(-n // 128) * 128
    codes = np.full((m, n_pad), -1 if has_missing else 0, dtype=np.int8)
    codes[:, :n] = g
    return codes


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("has_missing", [False, True])
@pytest.mark.parametrize("n", N_SAMPLES)
def test_pair_epilogue_is_bitwise_jax(n, has_missing, symmetric):
    rng = np.random.default_rng(n + 2 * has_missing + symmetric)
    m, rows = 192, slice(0, 64)
    codes = _codes(rng, m, n, has_missing)
    pre = ld_int8.preprocess_int8(torch.from_numpy(codes),
                                  torch.ones(m, dtype=torch.bool), 0.01, n,
                                  assume_no_missing=not has_missing)
    scal = ld_int8.stack_scalars(pre)
    dots = ld_int8.tile_products(pre["g"], pre["m"], pre["h"], has_missing,
                                 "int8", symmetric)(rows, slice(0, m))
    ours = ld_int8.corr_from_dots(dots, ld_int8.scal_views(scal[rows], "col"),
                                  ld_int8.scal_views(scal, "row"), float(n),
                                  float(codes.shape[1]), has_missing,
                                  symmetric)
    adj_c = ld_int8.adj_constant(n)
    ours = (*ours, *(ld_int8.adj_r2(r, adj_c) for r in ours))
    theirs = _jax_epilogue({k: jnp.asarray(v.numpy()) for k, v in dots.items()},
                           jnp.asarray(scal[rows].numpy()),
                           jnp.asarray(scal.numpy()), n=n,
                           n_pad=codes.shape[1], has_missing=has_missing,
                           symmetric=symmetric)
    assert len(ours) == len(theirs) == (6 if symmetric else 4)
    for k, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("has_missing", [False, True])
@pytest.mark.parametrize("n", N_SAMPLES + (16384,))
def test_per_snp_scalars_are_bitwise_jax(n, has_missing):
    rng = np.random.default_rng(n + has_missing)
    m = 512 if n < 16384 else 128
    codes = _codes(rng, m, n, has_missing)
    pos_ok = np.ones(m, dtype=bool)
    pos_ok[3] = False
    ours = ld_int8.preprocess_int8(torch.from_numpy(codes),
                                   torch.from_numpy(pos_ok), 0.01, n,
                                   assume_no_missing=not has_missing)
    theirs = jax_int8.preprocess_int8(
        jnp.asarray(codes), jnp.asarray(pos_ok), jnp.float32(0.01),
        n_samples=n, assume_no_missing=not has_missing)
    for k in (*ld_int8.SCAL_FIELDS, "maf", "rstd", "usable", "add_sd_zero"):
        a, b = ours[k].numpy(), np.asarray(theirs[k])
        if a.dtype == np.float32:
            a, b = _bits(a), _bits(b)
        np.testing.assert_array_equal(a, b, err_msg=k)
