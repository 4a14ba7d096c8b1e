"""The f32 engine of the PyTorch port (``ld --engine f32``) against the JAX
package's, on the CPU.

Both packages get the same numpy inputs.  ``preprocess_block`` agrees
within a few float32 ulp (the same operations, rounded by ATen and XLA);
the ``ld_xla`` engines get the JAX package's standardized rows carried
across by ``from_jax_f32_inputs``, so only their float32 products and
sums run in another order: scores within the golden tolerances, ``ws``
and ``wsd`` equal, ``wse`` under the contract of
``tests/contract.py`` with the f32 engine's tolerance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.ld import ld_xla as jax_xla
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu.ld import preprocess as jax_pre
from nldsc_tpu.ld import windows as jax_windows
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.errors import NLDSCParameterError
from nldsc_tpu_torch.io.plink import write_plink
from nldsc_tpu_torch.ld import ld_xla, pipeline, preprocess
from nldsc_tpu_torch.ld.convert import from_jax_f32_inputs

from test_golden import (ANNOT_STD, ANNOT_WIND, GOLDEN, GOLDEN_ANNOT, MAF,
                         RSQ, STD, WIND, check)
from contract import assert_counters_match, f32_tol
from test_torch_pipeline import _read_l2
from utils import adversarial_genotypes, make_positions, random_genotypes

KW = dict(ld_wind=9000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=32)
E2E_TOL = dict(rtol=2e-5, atol=2e-4, equal_nan=True)


def _codes(rng, m=160, n=200, missing_rate=0.03):
    g = random_genotypes(rng, m, n, missing_rate=missing_rate)
    adv = adversarial_genotypes(rng, n)
    g[10:16] = adv                 # monomorphic, all-het, rare, heavy missing
    g[30] = -1                     # all missing
    return g


def _padded(g, B):
    m, n = g.shape
    m_pad, n_pad = -(-m // B) * B, -(-n // 128) * 128
    gp = np.full((m_pad, n_pad), -1, np.int8)
    gp[:m, :n] = g
    return gp


def test_preprocess_block_matches_jax(rng):
    g = _codes(rng)
    gp = _padded(g, 32)
    pos_ok = np.ones(gp.shape[0], bool)
    pos_ok[3] = False
    pos_ok[g.shape[0]:] = False
    theirs = jax_pre.preprocess_block(jnp.asarray(gp), jnp.asarray(pos_ok),
                                      jnp.float32(0.01), n_samples=g.shape[1])
    ours = preprocess.preprocess_block(torch.from_numpy(gp),
                                       torch.from_numpy(pos_ok), 0.01,
                                       g.shape[1])
    for k in ("usable", "add_sd_zero"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      err_msg=k)
    for k in ("add", "res", "maf", "rstd"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=2e-6, atol=2e-6, equal_nan=True,
                                   err_msg=k)
    # the all-missing row is usable and a poison; the monomorphic ones not
    # usable; padded samples impute to exactly 0
    assert bool(ours["usable"][30]) and bool(ours["add_sd_zero"][30])
    assert not ours["usable"][10] and not ours["usable"][11]
    assert not ours["add"][:, g.shape[1]:].any()
    assert not ours["res"][:, g.shape[1]:].any()


def _engine_case(rng, B=32, wind=9000.0, annot=False):
    g = _codes(rng)
    m, n = g.shape
    pos = make_positions(m, spacing=700, jitter_rng=rng, skip_idx=(3,))
    gp = _padded(g, B)
    m_pad = gp.shape[0]
    lo, hi, pos_ok = jax_windows.window_bounds(pos, wind)
    pos_ok_p = np.zeros(m_pad, bool)
    pos_ok_p[:m] = pos_ok
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    blk_lo, blk_hi, band_k = jax_windows.band_blocks(lo, hi, B, m_pad // B)
    pre = jax_pre.preprocess_block(jnp.asarray(gp), jnp.asarray(pos_ok_p),
                                   jnp.float32(0.01), n_samples=n)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    jargs = (pre["add"], pre["res"], jnp.asarray(lo_p), jnp.asarray(hi_p),
             pre["usable"], dom_ok, pre["add_sd_zero"], jnp.asarray(blk_lo),
             jnp.asarray(blk_hi), jnp.float32(RSQ))
    inp = from_jax_f32_inputs({k: np.asarray(v) for k, v in pre.items()},
                              lo_p, hi_p, np.asarray(dom_ok), blk_lo, blk_hi)
    args = tuple(inp[k] for k in ("add", "res", "lo", "hi", "usable",
                                  "dom_ok", "add_sd_zero", "blk_lo",
                                  "blk_hi")) + (RSQ,)
    a = None
    if annot:
        a = np.zeros((m_pad, 3), np.float32)
        a[:m] = np.column_stack([np.ones(m), rng.random(m) < 0.3,
                                 rng.random(m)])
    cfg = LDConfig(ld_wind=wind, maf_thr=0.01, std_thr=1e-4, rsq_thr=RSQ)
    kw = dict(block_size=B, band_k=band_k, n_samples=n)
    right_k = jax_windows.right_band_blocks(blk_hi, B)
    return g, pos, cfg, jargs, args, a, kw, right_k


def _hold(ours, theirs, g, pos, cfg, keys=("l2", "l2d")):
    m = g.shape[0]
    for k, a, b in zip(keys, ours, theirs):
        np.testing.assert_allclose(np.asarray(a)[:m], np.asarray(b)[:m],
                                   err_msg=k, **E2E_TOL)
    names = ("l2_ws", "l2d_ws", "l2d_wse")
    n_pad = -(-g.shape[1] // 128) * 128
    return assert_counters_match(
        {k: np.asarray(x)[:m] for k, x in zip(names, ours[-3:])},
        {k: np.asarray(x)[:m] for k, x in zip(names, theirs[-3:])},
        g, pos, cfg, f32_tol(n_pad, g.shape[1], cfg.rsq_thr))


@pytest.mark.parametrize("engine", ["full band", "symmetric"])
def test_ld_xla_engines_match_jax(rng, engine):
    g, pos, cfg, jargs, args, _, kw, right_k = _engine_case(rng)
    if engine == "symmetric":
        theirs = jax_xla.ld_scores_xla_sym(*jargs, right_k=right_k, **kw)
        ours = ld_xla.ld_scores_xla_sym(*args, right_k=right_k, **kw)
    else:
        theirs = jax_xla.ld_scores_xla(*jargs, **kw)
        ours = ld_xla.ld_scores_xla(*args, **kw)
    assert _hold(ours, theirs, g, pos, cfg) <= 3


def test_ld_xla_annot_matches_jax(rng):
    g, pos, cfg, jargs, args, a, kw, _ = _engine_case(rng, annot=True)
    theirs = jax_xla.ld_scores_xla_annot(*jargs, jnp.asarray(a), **kw)
    ours = ld_xla.ld_scores_xla_annot(*args, torch.from_numpy(a), **kw)
    assert _hold(ours, theirs, g, pos, cfg,
                 ("l2_annot", "l2d_annot", "l2", "l2d")) <= 3


@pytest.mark.parametrize("symmetric", [True, False])
def test_golden_fixture_through_f32(symmetric):
    gold = dict(np.load(GOLDEN))
    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=32, use_int8=False,
                   symmetric=symmetric)
    check(pipeline.compute_ld_scores(gold["genotypes"], gold["positions"],
                                     cfg, device="cpu"), gold)


def test_golden_annot_fixture_through_f32():
    gold = dict(np.load(GOLDEN_ANNOT))
    cfg = LDConfig(ld_wind=ANNOT_WIND, wind_metric="bp", maf_thr=MAF,
                   std_thr=ANNOT_STD, rsq_thr=RSQ, block_size=32,
                   use_int8=False)
    res = pipeline.compute_ld_scores(gold["genotypes"], gold["positions"],
                                     cfg, annot=gold["annot"], device="cpu")
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(res[k], gold[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("kind, annot", [("clean", False), ("missing", False),
                                         ("missing", True)])
def test_compute_ld_scores_f32_matches_jax(rng, kind, annot):
    m, n = 200, 150
    g = random_genotypes(rng, m, n,
                         missing_rate=0.0 if kind == "clean" else 0.03)
    pos = make_positions(m, spacing=600, jitter_rng=rng, skip_idx=(20,))
    a = (np.column_stack([np.ones(m), rng.random(m)]) if annot else None)
    cfg = LDConfig(**KW, use_int8=False)
    ours = pipeline.compute_ld_scores(g, pos, cfg, annot=a, device="cpu")
    theirs = jax_pipeline.compute_ld_scores(
        g, pos, JaxLDConfig(**KW, use_int8=False), annot=a)
    keys = ("l2", "l2d", "maf") + (("l2_annot", "l2d_annot") if annot
                                   else ())
    for k in keys:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **E2E_TOL)
    np.testing.assert_allclose(ours["residuals_std"], theirs["residuals_std"],
                               rtol=1e-6, equal_nan=True)
    assert assert_counters_match(ours, theirs, g, pos, cfg,
                                 f32_tol(256, n, cfg.rsq_thr)) <= 3


def test_matmul_precision_high_runs_full_float32(rng):
    g = random_genotypes(rng, 120, 130, missing_rate=0.02)
    pos = make_positions(120, spacing=700, jitter_rng=rng)
    runs = [pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, use_int8=False, matmul_precision=p),
        device="cpu") for p in ("highest", "high")]
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)
    with pytest.raises(NLDSCParameterError, match="matmul_precision"):
        LDConfig(**KW, matmul_precision="default")


def test_f32_refuses_pallas_but_runs_annot_full_band(rng):
    g = random_genotypes(rng, 64, 130, missing_rate=0.0)
    pos = make_positions(64, spacing=700, jitter_rng=rng)
    with pytest.raises(NLDSCParameterError, match="f32"):
        pipeline.compute_ld_scores(
            g, pos, LDConfig(**KW, use_int8=False, use_pallas=True),
            device="cpu")
    res = pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, use_int8=False, use_pallas=True,
                         symmetric=True),
        annot=np.ones((64, 1)), device="cpu")
    assert res["l2_annot"].shape == (64, 1)


def _cli(prefix, out, *flags):
    cli.main(["ld", "--bfile", prefix, "-kb", "6", "-maf", "0.01", "--extra",
              "--device", "cpu", "-o", out, *flags])


@pytest.mark.parametrize("symmetric", [[], ["--no-symmetric"]])
def test_cli_engine_f32_matches_jax(rng, tmp_path, symmetric):
    g = random_genotypes(rng, 150, 140, missing_rate=0.02)
    bp = make_positions(150, spacing=600, jitter_rng=rng).astype(np.int64)
    prefix = write_plink(tmp_path / "c", g, bp=bp)
    ours, theirs = str(tmp_path / "ours.L2"), str(tmp_path / "theirs.L2")
    _cli(prefix, ours, "--engine", "f32", *symmetric)
    jax_pipeline.estimate_lds(prefix, ld_wind=6, wind_metric="kbp",
                              maf_thr=0.01, std_thr=1e-4, out=theirs,
                              extra=True, use_int8=False,
                              symmetric=not symmetric)
    a, b = _read_l2(ours), _read_l2(theirs)
    assert list(a) == list(b)
    for k in ("L2", "L2D", "MAF", "RSTD"):
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)
    cfg = LDConfig(ld_wind=6000.0, maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=1.0 / 150)
    names = {"WSA": "l2_ws", "WSD": "l2d_ws", "WSDE": "l2d_wse"}
    assert assert_counters_match(
        {v: a[k] for k, v in names.items()},
        {v: b[k] for k, v in names.items()}, g, bp.astype(np.float64), cfg,
        f32_tol(256, 140, cfg.rsq_thr)) <= 3
