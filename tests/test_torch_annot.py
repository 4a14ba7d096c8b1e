"""Partitioned LD scores (``ld --annot``) of the PyTorch port against the
JAX package (on the CPU: the plain twins and the full-band engine).

Every test feeds both packages the same numpy inputs made from a seed;
the annotation matrix crosses over through ``annot_from_jax``.  Counters
must be exactly equal; the annotation accumulators of one engine agree
within rtol 1e-5, atol 1e-5 (float32 sums in another order), end-to-end
scores within ``tests/test_golden.py``'s rtol 2e-5, atol 2e-4.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.h2 import pipeline as jax_h2
from nldsc_tpu.io import ldscores as jax_ldscores
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.io.plink import PlinkDataset as JaxPlinkDataset
from nldsc_tpu.ld import ld_int8 as jax_int8
from nldsc_tpu.ld import ld_split as jax_split
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu.ld import streaming as jax_streaming
from nldsc_tpu.ld import windows as jax_windows
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.logging import log
from nldsc_tpu_torch.h2 import pipeline as h2_pipeline
from nldsc_tpu_torch.io import ldscores
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import (ld_int8, ld_pallas_sym, ld_split, pipeline,
                                streaming)
from nldsc_tpu_torch.ld.convert import annot_from_jax, from_jax_inputs

import test_torch_ld_sym as sym
import test_torch_split as split
from test_golden import GOLDEN_ANNOT, MAF, RSQ, STD, WIND
from test_ld_split import row_level_missing
from utils import make_positions, random_genotypes

ACC_TOL = dict(rtol=1e-5, atol=1e-5)
E2E_TOL = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
KW = dict(ld_wind=9000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=32)
COUNTERS = ("l2_ws", "l2d_ws", "l2d_wse")
SCORES = ("l2", "l2d", "l2_annot", "l2d_annot")


@pytest.fixture()
def port_log(caplog):
    """The port's log lines (its logger does not propagate)."""
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=log.name):
            yield caplog
    finally:
        log.removeHandler(caplog.handler)


def _annot(rng, m, p=3):
    """The all-ones base, a binary, and continuous annotations."""
    cols = [np.ones(m), (rng.random(m) < 0.3).astype(np.float64),
            rng.uniform(0, 2, m), rng.uniform(0, 1, m)]
    cols += [rng.uniform(0, 1, m) for _ in range(p - len(cols))]
    return np.column_stack(cols[:p])


def _genotypes(rng, kind, m, n):
    if kind == "clean":
        return random_genotypes(rng, m, n, missing_rate=0.0)
    if kind == "global":
        return random_genotypes(rng, m, n, missing_rate=0.03)
    return row_level_missing(rng, m, n, row_frac=0.08, entry_rate=0.2)


def _data(rng, kind, m=300, n=150, p=3, skip=(20, 21, 22)):
    g = _genotypes(rng, kind, m, n)
    pos = make_positions(m, spacing=600, jitter_rng=rng, skip_idx=skip)
    return g, pos, _annot(rng, m, p)


def _assert_results(ours, theirs, tol=E2E_TOL):
    for k in COUNTERS:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    for k in SCORES:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == np.float64
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **tol)


def _write_annot(path, snps, annot, names):
    with open(path, "w") as f:
        f.write("\t".join(["SNP", *names]) + "\n")
        for s, row in zip(snps, annot.tolist()):
            f.write("\t".join([s, *map(repr, row)]) + "\n")
    return str(path)


# --- files -----------------------------------------------------------------

def test_read_annot_matches_jax(tmp_path, port_log):
    # duplicates (first row counts), SNPs absent from the file and from
    # the bim, NaN cells, key columns, another order than the bim's
    bim_snps = [f"rs{i + 1}" for i in range(12)]
    prefix = write_plink(tmp_path / "b", np.zeros((12, 8), np.int8))
    lines = ["CHR BP SNP CM A1 A2 base cat cont"]
    for i in (7, 3, 3, 2, 11, 5, 99, 1):
        cat = "NA" if i == 5 else str(i % 2)
        lines.append(f"1 {100 * i} rs{i} 0.0 A G 1 {cat} {0.25 * i!r}")
    lines.insert(4, "1 300 rs3 0.0 A G 0 0 7.5")       # a later duplicate
    path = tmp_path / "t.annot"
    path.write_text("\n".join(lines) + "\n")
    bim = PlinkDataset.parse(prefix).bim
    assert bim["SNP"].tolist() == bim_snps
    ours, names = ldscores.read_annot(str(path), bim)
    theirs, their_names = jax_ldscores.read_annot(
        str(path), JaxPlinkDataset.parse(prefix).bim)
    assert names == their_names == ["base", "cat", "cont"]
    assert ours.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    assert ours[2].tolist() == [1.0, 1.0, 0.75] and ours[4, 1] == 0.0
    assert not ours[3].any()                           # rs4 is absent
    assert "6 of 12 bim SNPs absent" in port_log.text


@pytest.mark.parametrize("text, match", [
    ("CHR base\n1 1\n", "SNP column"), ("SNP CHR BP\nrs0 1 5\n", "no annot")])
def test_read_annot_refuses_bad_files(tmp_path, text, match):
    path = tmp_path / "bad.annot"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        ldscores.read_annot(str(path), {"SNP": np.array(["rs0"], object)})


# --- engines ---------------------------------------------------------------

def _sym_inputs(rng, case, p=4):
    g, pos, B = sym._case(rng, case)
    e = sym._engine_inputs(g, pos, B)
    pre, m_pad = e["pre"], e["lo"].shape[0]
    jargs = (pre["g"], pre["m"], pre["h"], jax_int8.stack_scalars(pre),
             jnp.asarray(e["lo"]), jnp.asarray(e["hi"]), pre["usable"],
             e["dom_ok"], pre["add_sd_zero"])
    inp, args = sym._port_args(e)
    annot = _annot(rng, g.shape[0], p)
    return g, pos, B, e, jargs, inp, args, annot, annot_from_jax(annot, m_pad)


# p = 64 and 97: the widths of two whole and four chunks of the kernels'
# annotation epilogue (97: baselineLD v2.2)
@pytest.mark.parametrize("case, p", [
    ("clean", 4), ("missing", 4), ("clean", 64), ("missing", 64),
    ("clean", 97), ("missing", 97)],
    ids=["clean", "missing", "clean-p64", "missing-p64", "clean-p97",
         "missing-p97"])
def test_twin_annot_matches_jax(rng, case, p):
    g, pos, B, e, jargs, inp, args, annot, a_t = _sym_inputs(rng, case, p)
    m_pad = a_t.shape[0]
    theirs = jax_int8.sym_scan_segment(
        *jargs, jnp.float32(RSQ), jnp.int32(0), jnp.asarray(a_t.numpy()),
        block_size=B, right_k=e["right_k"], n_samples=e["n"],
        n_scan_blocks=m_pad // B, has_missing=e["has_missing"])
    before = (ld_pallas_sym.launches, ld_pallas_sym.annot_launches)
    ours = ld_pallas_sym.sym_credits(
        *args, RSQ, n_samples=e["n"], has_missing=e["has_missing"],
        block_size=B, annot=a_t)
    assert (ld_pallas_sym.launches, ld_pallas_sym.annot_launches) == before
    assert len(ours) == len(theirs) == 8
    plain = ld_pallas_sym.sym_credits(
        *args, RSQ, n_samples=e["n"], has_missing=e["has_missing"],
        block_size=B)
    for a, b in zip(ours[:6], plain):
        assert torch.equal(a, b)            # annot changes no plain credit
    for at in (1, 2, 4, 5):
        np.testing.assert_array_equal(ours[at].numpy(),
                                      np.asarray(theirs[at]))
    for at in (0, 3, 6, 7):
        np.testing.assert_allclose(ours[at].numpy(), np.asarray(theirs[at]),
                                   **ACC_TOL)
    assert ours[6].shape == (m_pad, p) and ours[6].abs().max() > 0


@pytest.mark.parametrize("case", ["clean", "missing"])
def test_full_band_annot_matches_jax(rng, case):
    g, pos, B, e, jargs, inp, args, annot, a_t = _sym_inputs(rng, case)
    m_pad = a_t.shape[0]
    lo, hi, _ = jax_windows.window_bounds(pos, 6000.0)
    blk_lo, blk_hi, band_k = jax_windows.band_blocks(lo, hi, B, m_pad // B)
    kw = dict(block_size=B, band_k=band_k, n_samples=e["n"],
              has_missing=e["has_missing"])
    theirs = jax_int8.ld_scores_int8(
        *jargs, jnp.asarray(blk_lo), jnp.asarray(blk_hi), jnp.float32(RSQ),
        jnp.asarray(a_t.numpy()), **kw)
    ours = ld_int8.ld_scores_int8(*args, blk_lo, blk_hi, RSQ, a_t, **kw)
    plain = ld_int8.ld_scores_int8(*args, blk_lo, blk_hi, RSQ, **kw)
    assert len(ours) == 7 and len(plain) == 5
    for a, b in zip(ours[2:], plain):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    for a, b in zip(ours[4:], theirs[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), equal_nan=True,
                                   **ACC_TOL)
    # and the symmetric engine inside the port (tests/test_annot.py:54-68)
    accs = ld_pallas_sym.sym_credits(
        *args, RSQ, n_samples=e["n"], has_missing=e["has_missing"],
        block_size=B, annot=a_t)
    l2, ws, poi, l2d, wsd, wse = accs[:6]
    l2_a, l2d_a = ld_int8.finalize_annot(
        accs[6], accs[7], a_t, inp["usable"], inp["add_sd_zero"], poi, wsd)
    np.testing.assert_allclose(l2_a.numpy(), ours[0].numpy(), equal_nan=True,
                               **ACC_TOL)
    np.testing.assert_allclose(l2d_a.numpy(), ours[1].numpy(),
                               equal_nan=True, **ACC_TOL)
    fin = sym._finalized(accs[:6], inp)
    for a, b in zip(fin[2:], ours[4:]):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("own", ["all", "below"])
def test_split_corrections_annot_twin_matches_jax(rng, own):
    g, pos, B, S = split._split_case(rng, "rows")
    e = split._engine_inputs(g, pos, B)
    pre, m_pad = e["pre"], e["m_pad"]
    own_hi = m_pad if own == "all" else 128
    plan = jax_split.plan_split_v2(e["rowmiss"], e["lo"], e["hi"], S, m_pad)
    a_t = annot_from_jax(_annot(rng, g.shape[0], 4), m_pad)
    theirs = jax_split.split_corrections(
        pre["g"], jax_split.compact_missing_rows(
            jnp.asarray(e["gp"]), jnp.asarray(plan["miss_idx"])),
        pre["h"], jax_int8.stack_scalars(pre), jnp.asarray(e["lo"]),
        jnp.asarray(e["hi"]), pre["usable"], jnp.asarray(e["dom_ok"]),
        jnp.asarray(e["rowmiss"]), jnp.float32(RSQ), jnp.int32(own_hi),
        jnp.asarray(plan["miss_idx"]), jnp.asarray(plan["cs"]),
        jnp.asarray(plan["c_cnt"]), jnp.asarray(plan["xs"]),
        jnp.asarray(plan["x_cnt"]), jnp.asarray(a_t.numpy()), seg_rows=S,
        n_segs=plan["n_segs"], p_band=plan["p_band"], p_x=plan["p_x"],
        n_samples=e["n"])
    inp = from_jax_inputs({k: np.asarray(v) for k, v in pre.items()},
                          e["lo"], e["hi"], e["dom_ok"])
    sargs = (inp["g"], ld_split.compact_missing_rows(
        torch.from_numpy(e["gp"]), plan["miss_idx"]), inp["h"], inp["scal"],
        inp["lo"], inp["hi"], inp["usable"], inp["dom_ok"],
        torch.from_numpy(e["rowmiss"]), RSQ, own_hi, plan)
    before = (ld_split.corr_launches, ld_split.annot_launches)
    ours = ld_split.split_corrections(*sargs, a_t, n_samples=e["n"])
    assert (ld_split.corr_launches, ld_split.annot_launches) == before
    plain = ld_split.split_corrections(*sargs, n_samples=e["n"])
    assert len(ours) == len(theirs) == 5 and len(plain) == 3
    for a, b in zip(ours[:3], plain):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(theirs[2]))
    for at in (0, 1, 3, 4):
        np.testing.assert_allclose(ours[at].numpy(), np.asarray(theirs[at]),
                                   **ACC_TOL)
    assert ours[3].abs().max() > 0 and ours[4].abs().max() > 0
    if own == "below":      # fewer pairs are owned: other credits
        full = ld_split.split_corrections(*sargs[:10], m_pad, plan, a_t,
                                          n_samples=e["n"])
        assert not torch.equal(full[3], ours[3])


# --- in core ---------------------------------------------------------------

@pytest.mark.parametrize("kind, kw", [
    ("clean", {}), ("clean", {"symmetric": True}), ("split", {}),
    ("global", {}), ("global", {"symmetric": False}),
    ("split", {"split_missing": False})],
    ids=["clean-fullband", "clean-symmetric", "split", "global",
         "global-fullband", "split-rows-global-route"])
def test_compute_ld_scores_annot_matches_jax(rng, port_log, kind, kw):
    g, pos, annot = _data(rng, kind)
    ours = pipeline.compute_ld_scores(g, pos, LDConfig(**KW, **kw),
                                      annot=annot, device="cpu")
    theirs = jax_pipeline.compute_ld_scores_annot(
        g, pos, annot, JaxLDConfig(**KW, **kw))
    _assert_results(ours, theirs)
    # the CPU resolves the engine as the JAX package does
    full_band = kw.get("symmetric") is False or (kind == "clean" and not kw)
    route = "global" if kw.get("split_missing") is False else kind
    assert (f"LD route: {route}" + (", full-band engine" if full_band else "")
            + ", 3 annotations") in port_log.text
    skipped = [20, 21, 22]
    assert np.isnan(ours["l2_annot"][skipped]).all()
    assert np.isnan(ours["l2d_annot"][skipped]).all()
    np.testing.assert_array_equal(np.isnan(ours["l2_annot"]),
                                  np.isnan(theirs["l2_annot"]))
    plain = pipeline.compute_ld_scores(g, pos, LDConfig(**KW, **kw),
                                       device="cpu")
    if not full_band:       # the same engine: annot changes no plain score
        for k in ("l2", "l2d", *COUNTERS):
            np.testing.assert_array_equal(ours[k], plain[k], err_msg=k)


def test_compute_ld_scores_annot_wrapper_and_checks(rng):
    g, pos, annot = _data(rng, "clean", m=100, n=60)
    cfg = LDConfig(**KW)
    a = pipeline.compute_ld_scores_annot(g, pos, annot, cfg, device="cpu")
    b = pipeline.compute_ld_scores(g, pos, cfg, annot=annot, device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(Exception, match="annot must be"):
        pipeline.compute_ld_scores(g, pos, cfg, annot=annot[:50],
                                   device="cpu")
    with pytest.raises(Exception, match="drop --no-symmetric"):
        pipeline.compute_ld_scores(
            g, pos, LDConfig(**KW, use_pallas=True, symmetric=False),
            annot=annot, device="cpu")


@pytest.mark.parametrize("kind", ["clean", "global", "split"])
def test_all_ones_annotation_is_the_plain_score(rng, kind):
    g, pos, _ = _data(rng, kind)
    res = pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, symmetric=True),
        annot=np.ones((g.shape[0], 1)), device="cpu")
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(res[k + "_annot"][:, 0], res[k],
                                   rtol=1e-6, atol=1e-6, equal_nan=True)
        np.testing.assert_array_equal(np.isnan(res[k + "_annot"][:, 0]),
                                      np.isnan(res[k]))


def _golden():
    gold = dict(np.load(GOLDEN_ANNOT))
    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=32)
    return gold, cfg


@pytest.mark.parametrize("symmetric", [None, True, False])
def test_golden_annot_in_core(symmetric):
    gold, cfg = _golden()
    res = pipeline.compute_ld_scores(
        gold["genotypes"], gold["positions"],
        LDConfig(**{**cfg.__dict__, "symmetric": symmetric}),
        annot=gold["annot"], device="cpu")
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(res[k], gold[k], err_msg=k, **E2E_TOL)


def test_golden_annot_streamed(tmp_path):
    gold, cfg = _golden()
    prefix = write_plink(tmp_path / "gold", gold["genotypes"],
                         bp=gold["positions"].astype(np.int64))
    bed = PlinkDataset.parse(prefix).bed
    res = streaming.compute_ld_scores_streaming(
        bed, gold["positions"], cfg, chunk_rows=64, annot=gold["annot"],
        device="cpu")
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(res[k], gold[k], err_msg=k, **E2E_TOL)


# --- streaming -------------------------------------------------------------

def _bfile(tmp_path, rng, kind, m=300, n=150, spacing=600, name="a"):
    g = _genotypes(rng, kind, m, n)
    pos = make_positions(m, spacing=spacing, jitter_rng=rng)
    prefix = write_plink(tmp_path / name, g, bp=pos.astype(np.int64))
    return g, pos, PlinkDataset.parse(prefix).bed, prefix


def _stream(bed, pos, annot, chunk=64, resume_path=None, **kw):
    return streaming.compute_ld_scores_streaming(
        bed, pos, LDConfig(**{**KW, **kw}), chunk_rows=chunk,
        resume_path=resume_path, annot=annot, device="cpu")


@pytest.mark.parametrize("kind", ["clean", "split", "global"])
def test_streaming_annot_matches_in_core_and_jax(tmp_path, rng, kind):
    g, pos, bed, _ = _bfile(tmp_path, rng, kind)
    annot = _annot(rng, g.shape[0])
    ours = _stream(bed, pos, annot)
    incore = pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, symmetric=True), annot=annot, device="cpu")
    _assert_results(ours, incore)
    theirs = jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos,
        JaxLDConfig(**KW), chunk_rows=64, annot=annot)
    _assert_results(ours, theirs)
    plain = streaming.compute_ld_scores_streaming(
        bed, pos, LDConfig(**KW), chunk_rows=64, device="cpu")
    for k in ("l2", "l2d", *COUNTERS):
        np.testing.assert_array_equal(ours[k], plain[k], err_msg=k)


def test_streaming_annot_halo_wider_than_chunk(tmp_path, rng):
    g, pos, bed, _ = _bfile(tmp_path, rng, "split", spacing=100)
    annot = _annot(rng, g.shape[0], 2)
    lo, hi, _ = jax_windows.window_bounds(pos, KW["ld_wind"])
    geo = streaming.stream_geometry(len(pos), lo, hi, 32, 32, "cpu")
    assert geo.halo > geo.chunk_rows
    ours = _stream(bed, pos, annot, chunk=32)
    incore = pipeline.compute_ld_scores(
        g, pos, LDConfig(**KW, symmetric=True), annot=annot, device="cpu")
    _assert_results(ours, incore)


def _ld_args(prefix, out, *extra):
    return ["ld", "--bfile", prefix, "-kb", "9", "-maf", "0.01", "-rsq",
            "1e-3", "--block-size", "32", "--device", "cpu", "-o", str(out),
            *extra]


def test_streaming_annot_resume_is_byte_identical(tmp_path, rng, port_log):
    g, pos, bed, prefix = _bfile(tmp_path, rng, "split")
    snps = PlinkDataset.parse(prefix).bim["SNP"].tolist()
    apath = _write_annot(tmp_path / "a.annot", snps,
                         _annot(rng, g.shape[0]), ["base", "cat", "cont"])
    stream = ["--annot", apath, "--streaming", "--chunk-rows", "64"]
    cli.main(_ld_args(prefix, tmp_path / "whole.L2", *stream))
    ck = tmp_path / "ck"
    cli.main(_ld_args(prefix, tmp_path / "first.L2", *stream, "--resume",
                      str(ck)))
    shards = sorted(ck.glob("chunk_*.npz"))
    assert len(shards) == 5
    with np.load(shards[0]) as d:
        assert d["tail_a"].shape[0] == 2 and d["tail_a"].shape[2] == 3
        assert d["l2_annot"].shape == (64, 3)
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["annot_p"] == 3 and len(meta["annot_sha256"]) == 64
    for f in shards[2:]:
        f.unlink()
    cli.main(_ld_args(prefix, tmp_path / "resumed.L2", *stream, "--resume",
                      str(ck)))
    assert "Resuming: 2 chunks already complete" in port_log.text
    whole = (tmp_path / "whole.L2").read_bytes()
    assert (tmp_path / "first.L2").read_bytes() == whole
    assert (tmp_path / "resumed.L2").read_bytes() == whole
    for suffix in (".M", ".M_5_50"):
        assert ((tmp_path / "resumed.L2").with_suffix(suffix).read_bytes()
                == (tmp_path / "whole.L2").with_suffix(suffix).read_bytes())


@pytest.mark.parametrize("change", ["no_annot", "other_p", "other_values"])
def test_checkpoint_pins_the_annotations(tmp_path, rng, change):
    g, pos, bed, _ = _bfile(tmp_path, rng, "clean", m=200)
    annot = _annot(rng, g.shape[0])
    ck = str(tmp_path / "ck")
    _stream(bed, pos, annot, resume_path=ck)
    other = {"no_annot": None, "other_p": annot[:, :2],
             "other_values": np.where(annot == 1.0, 0.5, annot)}[change]
    key = "annot_sha256" if change == "other_values" else "annot_p"
    with pytest.raises(ValueError, match="different parameters") as ex:
        _stream(bed, pos, other, resume_path=ck)
    assert key in str(ex.value)
    # and shards written without annotations are refused with them
    plain_ck = str(tmp_path / "plain")
    _stream(bed, pos, None, resume_path=plain_ck)
    with pytest.raises(ValueError, match="annot_p"):
        _stream(bed, pos, annot, resume_path=plain_ck)


# --- commands --------------------------------------------------------------

def test_estimate_lds_annot_files_match_jax(tmp_path, rng):
    g, pos, bed, prefix = _bfile(tmp_path, rng, "clean")
    snps = PlinkDataset.parse(prefix).bim["SNP"].tolist()
    names = ["base", "cat", "cont"]
    apath = _write_annot(tmp_path / "a.annot", snps, _annot(rng, len(snps)),
                         names)
    kw = dict(ld_wind=9000, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
              rsq_thr=1e-3, block_size=32, annot=apath)
    out, ref = tmp_path / "ours.L2", tmp_path / "jax.L2"
    pipeline.estimate_lds(prefix, out=str(out), extra=True, device="cpu",
                          **kw)
    jax_pipeline.estimate_lds(prefix, out=str(ref), **kw)
    header = out.read_text().splitlines()[0].split("\t")
    assert header == (["CHR", "SNP", "BP"] + [f"{n}.L2" for n in names]
                      + [f"{n}.L2D" for n in names])   # --extra adds nothing
    assert header == ref.read_text().splitlines()[0].split("\t")
    ours_t, ref_t = (ldscores.read_delimited(str(p), sep="\t")
                     for p in (out, ref))
    for col in header[3:]:
        np.testing.assert_allclose(ours_t[col], ref_t[col], rtol=2e-5,
                                   atol=2e-4, equal_nan=True, err_msg=col)
    for suffix in (".M", ".M_5_50"):
        a, b = (ldscores.read_delimited(str(p.with_suffix(suffix)), sep="\t")
                for p in (out, ref))
        assert list(a) == list(b) == [f"{n}.L2" for n in names]
        for col in a:
            np.testing.assert_allclose(a[col], b[col], rtol=1e-12)
    table = pipeline.estimate_lds(prefix, device="cpu", **kw)
    assert list(table) == header and len(table) == len(snps)


def test_ld_genome_annot_on_two_bfiles(tmp_path, rng):
    # one file for every chromosome, matched by SNP id: the second bfile
    # holds 30 SNPs that the file lacks
    names = ["base", "cat"]
    prefixes = []
    for c, m in ((1, 150), (2, 200)):
        g = random_genotypes(rng, m, 90, missing_rate=0.0)
        pos = make_positions(m, spacing=600, jitter_rng=rng)
        prefixes.append(write_plink(tmp_path / f"chr{c}", g, chrom=c,
                                    bp=pos.astype(np.int64)))
    rows = [f"rs{i + 1}" for i in range(170)]
    apath = _write_annot(tmp_path / "genome.annot", rows,
                         _annot(rng, len(rows), 2), names)
    gdir = tmp_path / "out"
    cli.main(["ld-genome", "--bfiles", ",".join(prefixes), "--out-dir",
              str(gdir), "-kb", "9", "-maf", "0.01", "--annot", apath,
              "--device", "cpu"])
    for c, prefix in zip((1, 2), prefixes):
        single = tmp_path / f"single{c}.L2"
        cli.main(["ld", "--bfile", prefix, "-kb", "9", "-maf", "0.01",
                  "--annot", apath, "--device", "cpu", "-o", str(single)])
        for suffix in (".L2", ".M", ".M_5_50"):
            assert ((gdir / f"chr{c}{suffix}").read_bytes()
                    == single.with_suffix(suffix).read_bytes())
        tab = ldscores.read_delimited(str(gdir / f"chr{c}.L2"), sep="\t")
        assert list(tab)[3:] == ["base.L2", "cat.L2", "base.L2D", "cat.L2D"]
        m_row = ldscores.read_delimited(str(gdir / f"chr{c}.M"), sep="\t")
        assert 0 < m_row["base.L2"][0] <= 170


@pytest.mark.parametrize("flag, engine", [
    ("--symmetric", "LD route: clean, 3 annotations"),
    ("--no-symmetric", "LD route: clean, full-band engine, 3 annotations"),
    (None, "LD route: clean, full-band engine, 3 annotations")],
    ids=["symmetric", "no-symmetric", "auto"])
def test_symmetric_flags_parse_and_route(tmp_path, rng, port_log, flag,
                                         engine):
    args = cli.build_parser().parse_args(
        ["ld", "--bfile", "x", "-kb", "5"] + ([flag] if flag else []))
    assert args.symmetric is {"--symmetric": True, "--no-symmetric": False,
                              None: None}[flag]
    g, pos, bed, prefix = _bfile(tmp_path, rng, "clean", m=120, n=64)
    snps = PlinkDataset.parse(prefix).bim["SNP"].tolist()
    apath = _write_annot(tmp_path / "a.annot", snps, _annot(rng, 120),
                         ["base", "cat", "cont"])
    cli.main(_ld_args(prefix, tmp_path / "o.L2", "--annot", apath,
                      *([flag] if flag else [])))
    assert engine in port_log.text
    # on a card the symmetric engine (the kernels) is the default
    assert pipeline.resolve_symmetric(None, True, False, "cuda") is True
    assert pipeline.resolve_symmetric(False, True, False, "cuda") is False
    assert pipeline.resolve_symmetric(None, None, True, "cpu") is True


def test_ld_annot_then_h2_partitioned_matches_jax(tmp_path, rng):
    g, pos, bed, prefix = _bfile(tmp_path, rng, "split", m=400, n=200)
    snps = PlinkDataset.parse(prefix).bim["SNP"].tolist()
    apath = _write_annot(tmp_path / "a.annot", snps, _annot(rng, 400),
                         ["base", "cat", "cont"])
    l2 = tmp_path / "p.L2"
    cli.main(_ld_args(prefix, l2, "--annot", apath))
    w = tmp_path / "w.L2"
    cli.main(_ld_args(prefix, w))
    ss = tmp_path / "t.sumstats"
    ss.write_text("SNP\tZ\tN\n" + "".join(
        f"{s}\t{z!r}\t10000.0\n"
        for s, z in zip(snps, rng.normal(size=len(snps)).tolist())))
    kw = dict(n_blocks=20, chisq_max=1e9)
    ours = h2_pipeline.estimate_h2_partitioned(
        sumstats=str(ss), ref_ld=str(l2), w_ld=str(w), device="cpu", **kw)
    theirs = jax_h2.estimate_h2_partitioned(str(ss), str(l2), str(w), **kw)
    assert list(ours["annotations"]) == list(theirs["annotations"]) == [
        "base.L2", "cat.L2", "cont.L2"]

    def same(a, b, where=""):
        assert set(a) == set(b), where
        for k, v in b.items():
            if isinstance(v, dict):
                same(a[k], v, f"{where}.{k}")
            elif isinstance(v, (str, bool)) or v is None:
                assert a[k] == v, f"{where}.{k}"
            else:
                np.testing.assert_allclose(a[k], v, rtol=1e-8, atol=1e-12,
                                           equal_nan=True,
                                           err_msg=f"{where}.{k}")

    same(ours, theirs)


def test_annot_from_jax_pads_with_zero_rows(rng):
    annot = _annot(rng, 10, 4)
    t = annot_from_jax(annot, 16)
    assert t.dtype == torch.float32 and tuple(t.shape) == (16, 4)
    assert t.is_contiguous() and t.device.type == "cpu"
    np.testing.assert_array_equal(t[:10].numpy(), annot.astype(np.float32))
    assert not t[10:].any()


@pytest.mark.parametrize("case", ["clean", "missing"])
def test_k1_annot_fold_matches_twin(rng, case):
    """The kernel's annotation partial layout, filled per (pivot tile,
    band slot) on the CPU, through ``_fold_annot``."""
    g, pos, _ = sym._case(rng, case)
    e = sym._engine_inputs(g, pos, ld_pallas_sym.ROW_ALIGN, wind=9000.0)
    inp, args = sym._port_args(e)
    T = ld_pallas_sym.tile(e["has_missing"])
    m_pad = args[0].shape[0]
    a_t = annot_from_jax(_annot(rng, g.shape[0], 4), m_pad)
    nt = m_pad // T
    tile_hi, band = ld_int8.band_extent(inp["hi"], T)
    apart = torch.zeros((nt, band, 2, 2, T, 4))
    hi_all = inp["hi"]
    for b in range(nt):
        for k in range(band):
            t = b + k
            if t >= nt or t > int(tile_hi[b]):
                continue
            # the tile's credits alone: every other pair out of the window
            lo_t = torch.full_like(inp["lo"], m_pad)
            hi_t = torch.full_like(hi_all, -1)
            rows = slice(b * T, b * T + T)
            lo_t[rows] = torch.clamp(inp["lo"][rows], min=t * T)
            hi_t[rows] = torch.clamp(hi_all[rows], max=t * T + T - 1)
            one = ld_int8.sym_scan_segment(
                *args[:4], lo_t, hi_t, *args[6:], RSQ, b, a_t, block_size=T,
                right_k=band, n_samples=e["n"], n_scan_blocks=1,
                has_missing=e["has_missing"])
            cols = slice(t * T, t * T + T)
            for v, acc in enumerate(one[6:]):
                apart[b, k, 0, v] = acc[rows]
                if t > b:
                    apart[b, k, 1, v] = acc[cols]
    ours = ld_pallas_sym._fold_annot(apart)
    twin = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=e["n"],
                                     has_missing=e["has_missing"],
                                     block_size=T, annot=a_t)
    for a, b in zip(ours, twin[6:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ACC_TOL)
    assert ours[0].abs().max() > 0


def test_k2_annot_fold_adds_segments_at_their_columns():
    # two segments of one x tile each, P = 40 (two column tiles); segment
    # 0 reaches both column tiles, segment 1 its first only; 40
    # contaminated rows, compact row c at global row 5 c + 1
    TM, TC, p, S, m_pad = ld_split.TILE_X, ld_split.TILE_C, 3, 128, 256
    seg = torch.tensor([[0, 0, 40, 0], [128, 3, 30, 128]], dtype=torch.int32)
    cidx = torch.arange(40, dtype=torch.int32) * 5 + 1
    live = torch.tensor([[[True, True]], [[True, False]]])
    slot = ld_split.tile_slots(live)
    assert slot.tolist() == [[[0, 1]], [[2, -1]]]
    gen = torch.Generator().manual_seed(5)
    # rows of annot_ld(p) = 8 floats: the 5 past p are not summed
    rpa = torch.rand((3, 2, TM, ld_split.annot_ld(p)), generator=gen)
    cpa = torch.rand((3, TC, 2, ld_split.annot_ld(p)), generator=gen)
    full = ld_split.fold_annot(rpa, cpa, slot, seg, cidx, S, m_pad, p)
    assert len(full) == 2
    rpa, cpa = rpa[..., :p], cpa[..., :p]
    for v in range(2):
        rows = torch.cat([rpa[0, v] + rpa[1, v], rpa[2, v]])
        cols = torch.zeros((40, p))
        cols[0:32] += cpa[0, :, v]                 # segment 0, columns 0-31
        cols[32:40] += cpa[1, :8, v]               # 32-39: its c_cnt ends
        cols[3:33] += cpa[2, :30, v]               # segment 1 at c0 = 3
        rows[cidx.long()] += cols                  # at their global rows
        torch.testing.assert_close(full[v], rows)
