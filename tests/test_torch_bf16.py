"""``--dot-dtype bf16`` of the PyTorch port (on the CPU: the plain twins
with the bf16 contraction ``ld_int8.bdot``) against its int8 runs and the
JAX package's bf16 runs.

The bf16 products are exact (codes in {0, 1, 2}, every partial sum an
integer below 2^24), so every port result under bf16 equals the int8
result bit for bit.  Against the JAX package: scores within
``tests/test_golden.py``'s tolerances, counters under the contract of
``tests/contract.py``.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.ld import ld_int8 as jax_int8
from nldsc_tpu.ld import ld_pallas_sym as jax_pallas
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.errors import NLDSCParameterError
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import (ld_int8, ld_pallas_sym, ld_split, pipeline,
                                 streaming)

import test_torch_ld_sym as sym
from test_ld_split import row_level_missing
from contract import assert_counters_equal
from utils import make_positions, random_genotypes

KW = dict(ld_wind=9000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=32)
E2E_TOL = dict(rtol=2e-5, atol=2e-4, equal_nan=True)


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bdot_is_exact_where_a_bf16_matmul_rounds():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 3, (40, 1024), dtype=np.int8))
    x[0] = 2                                     # Sgg of this row: 4,096
    y = x[:24].contiguous()
    exact = ld_int8.idot(x, y)
    assert exact[0, 0] == 4096.0
    assert torch.equal(ld_int8.bdot(x, y), exact)
    assert torch.equal(ld_int8.bdot(x.to(torch.bfloat16),
                                    y.to(torch.bfloat16)), exact)
    rounded = (x.to(torch.bfloat16) @ y.to(torch.bfloat16).t()).float()
    assert not torch.equal(rounded, exact)      # bf16 sums round
    assert ld_int8.make_idot("bf16") is ld_int8.bdot
    with pytest.raises(ValueError, match="dot_dtype"):
        ld_int8.make_idot("fp8")


def test_bf16_past_4m_samples_is_refused():
    n = ld_int8.BF16_MAX_SAMPLES
    ld_int8.check_dot_dtype("bf16", n)
    ld_int8.check_dot_dtype("int8", n + 128)
    with pytest.raises(NLDSCParameterError, match="4194304"):
        ld_int8.check_dot_dtype("bf16", n + 128)
    g = np.zeros((2, n + 1), dtype=np.int8)
    g[:, ::2] = 1
    with pytest.raises(NLDSCParameterError, match="--dot-dtype int8"):
        pipeline.compute_ld_scores(
            g, np.array([1.0, 2.0]), LDConfig(**KW, int8_dot_dtype="bf16"),
            device="cpu")


@pytest.mark.parametrize("case", ["clean", "missing"])
def test_sym_scan_bf16_matches_int8_and_jax_pallas(rng, case):
    g, pos, B = sym._case(rng, case)
    e = sym._engine_inputs(g, pos, B)
    pre = e["pre"]
    m, m_pad = g.shape[0], e["lo"].shape[0]
    jargs = (pre["g"], pre["m"], pre["h"], jax_int8.stack_scalars(pre),
             jnp.asarray(e["lo"]), jnp.asarray(e["hi"]), pre["usable"],
             e["dom_ok"], pre["add_sd_zero"])
    pallas = jax_pallas.ld_scores_pallas_int8_sym(
        *jargs, rsq_thr=sym.RSQ, block_size=B, right_k=e["right_k"],
        n_samples=e["n"], sample_chunk=128, interpret=True,
        has_missing=e["has_missing"], dot_dtype="bf16")
    inp, args = sym._port_args(e)

    def twin(a, dot_dtype):
        return ld_int8.sym_scan_segment(
            *a, sym.RSQ, 0, block_size=B, right_k=e["right_k"],
            n_samples=e["n"], n_scan_blocks=m_pad // B,
            has_missing=e["has_missing"], dot_dtype=dot_dtype)

    ops = dict(zip("gmh", args[:3]))
    ld_int8.to_operands(ops, "bf16")
    assert ops["g"].dtype == torch.bfloat16
    bf16 = twin((ops["g"], ops["m"], ops["h"], *args[3:]), "bf16")
    for a, b in zip(bf16, twin(args, "int8")):
        assert torch.equal(a, b)
    ours = sym._finalized(bf16, inp)
    for a, b in zip(ours[:2], pallas[:2]):
        np.testing.assert_allclose(a[:m], np.asarray(b)[:m], **sym.TOL)
    assert_counters_equal(
        dict(zip(("l2_ws", "l2d_ws", "l2d_wse"), (x[:m] for x in ours[2:]))),
        dict(zip(("l2_ws", "l2d_ws", "l2d_wse"),
                 (np.asarray(x)[:m] for x in pallas[2:]))))


@pytest.mark.parametrize("case", ["clean", "missing"])
def test_sym_credits_takes_the_contraction_from_the_operands(rng, case):
    g, pos, B = sym._case(rng, case)
    e = sym._engine_inputs(g, pos, B)
    _, args = sym._port_args(e)
    kw = dict(n_samples=e["n"], has_missing=e["has_missing"], block_size=B)
    ops = dict(zip("gmh", args[:3]))
    ld_int8.to_operands(ops, "bf16")
    assert ld_int8.dot_dtype_of(ops["g"]) == "bf16"
    assert ld_int8.dot_dtype_of(args[0]) == "int8"
    got = ld_pallas_sym.sym_credits(ops["g"], ops["m"], ops["h"], *args[3:],
                                    sym.RSQ, **kw)
    for a, b in zip(got, ld_pallas_sym.sym_credits(*args, sym.RSQ, **kw)):
        assert torch.equal(a, b)


def _data(rng, kind, m=256, n=150):
    if kind in ("clean", "annot"):
        g = random_genotypes(rng, m, n, missing_rate=0.0)
    elif kind == "global":
        g = random_genotypes(rng, m, n, missing_rate=0.03)
    else:
        g = row_level_missing(rng, m, n, row_frac=0.08, entry_rate=0.2)
    pos = make_positions(m, spacing=600, jitter_rng=rng, skip_idx=(20,))
    annot = None
    if kind in ("annot", "split annot"):
        annot = np.column_stack([np.ones(m), rng.random(m) < 0.3,
                                 rng.uniform(0, 1, m)]).astype(np.float64)
    return g, pos, annot


@pytest.mark.parametrize("kind, split", [
    ("clean", None), ("split", True), ("global", False), ("annot", None),
    ("split annot", True)])
def test_compute_ld_scores_bf16_matches_int8_and_jax(rng, kind, split):
    g, pos, annot = _data(rng, kind)
    kw = dict(KW, split_missing=split)
    ours = pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw, int8_dot_dtype="bf16"), annot=annot,
        device="cpu")
    _assert_bitwise(ours, pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw), annot=annot, device="cpu"))
    theirs = jax_pipeline.compute_ld_scores(
        g, pos, JaxLDConfig(**kw, int8_dot_dtype="bf16"), annot=annot)
    for k in ("l2", "l2d") + (("l2_annot", "l2d_annot") if annot is not None
                              else ()):
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **E2E_TOL)
    assert_counters_equal(ours, theirs)


def test_full_band_bf16_equals_int8(rng):
    g, pos, annot = _data(rng, "split annot")
    kw = dict(KW, symmetric=False)
    _assert_bitwise(
        pipeline.compute_ld_scores(g, pos, LDConfig(**kw,
                                                    int8_dot_dtype="bf16"),
                                   annot=annot, device="cpu"),
        pipeline.compute_ld_scores(g, pos, LDConfig(**kw), annot=annot,
                                   device="cpu"))


def test_split_corrections_plain_bf16_equals_int8(rng):
    g = row_level_missing(rng, 160, 200, row_frac=0.1, entry_rate=0.2)
    pos = make_positions(160, spacing=700, jitter_rng=rng)
    cfg = LDConfig(**KW)
    e = sym._engine_inputs(g, pos, 32, wind=cfg.ld_wind)
    inp, args = sym._port_args(e)
    m_pad, n_pad = inp["g"].shape
    rowmiss = (inp["scal"][:, 8] > float(n_pad - g.shape[1])) & inp["usable"]
    gp = np.full((m_pad, n_pad), -1, np.int8)
    gp[:g.shape[0], :g.shape[1]] = g
    plan = ld_split.plan_split_v2(rowmiss.numpy(), e["lo"], e["hi"], 64,
                                  m_pad)
    m_c = ld_split.compact_missing_rows(torch.from_numpy(gp),
                                        plan["miss_idx"])
    common = (inp["scal"], inp["lo"], inp["hi"], inp["usable"],
              inp["dom_ok"], rowmiss, cfg.rsq_thr, m_pad, plan)
    ref = ld_split.split_corrections(inp["g"], m_c, inp["h"], *common,
                                     n_samples=g.shape[1])
    ops = {"g": inp["g"], "m_c": m_c, "h": inp["h"]}
    ld_int8.to_operands(ops, "bf16")
    got = ld_split.split_corrections(ops["g"], ops["m_c"], ops["h"], *common,
                                     n_samples=g.shape[1])
    assert plan["n_miss"] > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["clean", "split annot"])
def test_streamed_bf16_equals_streamed_int8_and_in_core(tmp_path, rng, kind):
    g, pos, annot = _data(rng, kind)
    prefix = write_plink(tmp_path / "s", g, bp=pos.astype(np.int64))
    bed = PlinkDataset.parse(prefix).bed
    kw = dict(KW, block_size=16)

    def stream(dot_dtype):
        return streaming.compute_ld_scores_streaming(
            bed, pos, LDConfig(**kw, int8_dot_dtype=dot_dtype),
            chunk_rows=64, annot=annot, device="cpu")

    bf16 = stream("bf16")
    _assert_bitwise(bf16, stream("int8"))
    incore = pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw, int8_dot_dtype="bf16"), annot=annot,
        device="cpu")
    for k in incore:
        if k.startswith("l2_") and k != "l2_annot" or k.startswith("l2d_w"):
            np.testing.assert_array_equal(bf16[k], incore[k], err_msg=k)
        else:
            np.testing.assert_allclose(bf16[k], incore[k], rtol=1e-5,
                                       atol=1e-5, equal_nan=True, err_msg=k)


def test_int8_checkpoint_refuses_a_bf16_resume(tmp_path, rng):
    g, pos, _ = _data(rng, "clean")
    prefix = write_plink(tmp_path / "s", g, bp=pos.astype(np.int64))
    bed = PlinkDataset.parse(prefix).bed
    ck = tmp_path / "ck"

    def stream(dot_dtype):
        return streaming.compute_ld_scores_streaming(
            bed, pos, LDConfig(**KW, int8_dot_dtype=dot_dtype),
            chunk_rows=64, resume_path=str(ck), device="cpu")

    stream("int8")
    with pytest.raises(ValueError, match="dot_dtype"):
        stream("bf16")
