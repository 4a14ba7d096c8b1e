"""``ld``'s progress on the symmetric integer pass in core: the pass runs
in up to 16 segments with a tick after each, as the JAX package runs it
(``nldsc_tpu/ld/pipeline.py:346-359``); the logger; K1's range launch
(``ld_pallas_sym.range_partials``) on its CPU twin; ``ld --pallas``.

On the CPU each segment runs the twin ``ld_int8.sym_scan_segment`` and
the segments' credit vectors are added in order, so the scores lie
within the golden tolerances of the unsegmented run (and of the JAX
package's), the counters equal; on the card the segments' partials fold
once, bitwise one launch (``tests/test_torch_kernel.py``).
"""

import numpy as np
import pytest
import torch

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.logging import log
from nldsc_tpu_torch.io.plink import write_plink
from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, pipeline, windows

from contract import assert_counters_equal
from test_torch_split_kernel import row_level_missing
from utils import make_positions, random_genotypes

GOLDEN = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
FLOATS = ("l2", "l2d", "maf", "residuals_std")
COUNTERS = ("l2_ws", "l2d_ws", "l2d_wse")
KW = dict(ld_wind=6000.0, maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3)

# case -> (m, block size, route); 38 blocks: 12 segments of
# ceil(38 / 16) = 3 blocks and a last one of 2; 10 blocks: one a segment
CASES = {
    "clean": (600, 16, "clean"),
    "split": (600, 16, "split"),
    "global": (600, 16, "global"),
    "clean_ten_blocks": (300, 32, "clean"),
}


def _genotypes(rng, m, route):
    if route == "clean":
        return random_genotypes(rng, m, 150, missing_rate=0.0)
    if route == "split":
        return row_level_missing(rng, m, 150, 0.05, 0.3)
    return random_genotypes(rng, m, 150, missing_rate=0.05)


@pytest.fixture()
def port_log(caplog):
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level("INFO", logger=log.name):
            yield caplog
    finally:
        log.removeHandler(caplog.handler)


@pytest.mark.parametrize("case", list(CASES))
def test_ticks_and_scores_match_jax(rng, port_log, case):
    m, block, route = CASES[case]
    g = _genotypes(rng, m, route)
    pos = make_positions(m, spacing=700, jitter_rng=rng)
    kw = {**KW, "block_size": block}
    ticks = {"ours": [], "jax": []}
    ours = pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw), device="cpu",
        progress=lambda done, total: ticks["ours"].append((done, total)))
    assert f"LD route: {route}" in port_log.text
    theirs = jax_pipeline.compute_ld_scores(
        g, pos, JaxLDConfig(**kw),
        progress=lambda done, total: ticks["jax"].append((done, total)))
    assert ticks["ours"] == ticks["jax"]
    assert len(ticks["ours"]) == 1 + len(ld_pallas_sym.segments(m, block,
                                                                 True))
    assert ticks["ours"][0] == (0, m) and ticks["ours"][-1] == (m, m)
    whole = pipeline.compute_ld_scores(g, pos, LDConfig(**kw), device="cpu")
    for k in FLOATS:
        np.testing.assert_allclose(ours[k], whole[k], err_msg=k, **GOLDEN)
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **GOLDEN)
    for k in COUNTERS:
        np.testing.assert_array_equal(ours[k], whole[k], err_msg=k)
    assert_counters_equal(ours, theirs)


def test_logger_skips_zero_and_prints_an_eta(port_log):
    cb = pipeline._progress_logger()
    for done in (0, 250, 1000):
        cb(done, 1000)
    lines = [r.getMessage() for r in port_log.records
             if r.getMessage().startswith("LD pass")]
    assert len(lines) == 2
    assert lines[0].startswith("LD pass: 250/1000 SNPs (25%) | elapsed ")
    assert lines[1].startswith("LD pass: 1000/1000 SNPs (100%) | elapsed ")
    assert all("| ETA " in line for line in lines)
    assert lines[1].endswith("| ETA 0.0s")


def _range_args(rng, has_missing, p, m=256, n=96, T=16):
    """Engine inputs of ``m`` rows on the CPU, ``p`` annotations (None at
    0), and the keywords of a whole pass's band in tiles of ``T``."""
    g = random_genotypes(rng, m, n, missing_rate=0.03 if has_missing else 0)
    pos = make_positions(m, spacing=500, jitter_rng=rng)
    lo, hi, ok = (torch.from_numpy(x) for x in
                  windows.window_bounds(pos, 9000.0))
    codes = torch.from_numpy(np.concatenate(
        [g, np.full((m, 128 - n), -1, np.int8)], axis=1))
    pre = ld_int8.preprocess_int8(codes, ok, 0.01, n,
                                  assume_no_missing=not has_missing)
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre), lo,
            hi, pre["usable"], dom_ok, pre["add_sd_zero"], 1e-3)
    annot = (torch.from_numpy(rng.random((m, p)).astype(np.float32))
             if p else None)
    band = ld_int8.band_extent(hi, T)[1]
    return args, dict(n_samples=n, has_missing=has_missing, band=band,
                      block_size=T, annot=annot)


@pytest.mark.parametrize("has_missing, p", [(False, 0), (True, 0),
                                            (True, 2)])
def test_range_partials_put_together_equal_one_call(rng, has_missing, p):
    # consecutive tile ranges, their halos' windows emptied, give each
    # pivot tile the partials of one call over all the tiles
    args, kw = _range_args(rng, has_missing, p)
    one = ld_pallas_sym.sym_partials(*args, **kw)
    nt, band = 256 // 16, kw["band"]
    assert band > 1
    pieces = [ld_pallas_sym.range_partials(*args, x0, x1, **kw)
              for x0, x1 in ((0, 3), (3, 4), (4, 11), (11, nt))]
    for whole, *parts in zip(one, *pieces):
        if whole is None:
            assert all(x is None for x in parts)
        else:
            assert torch.equal(whole, torch.cat(parts))


@pytest.mark.parametrize("has_missing, p", [(False, 0), (True, 0),
                                            (False, 37), (True, 37)])
def test_range_partials_into_one_buffer_equal_one_call(rng, has_missing, p):
    # as the segmented pass on the card: one set of zero-filled partials
    # for the whole pass, each range writing its tiles' slots into it
    args, kw = _range_args(rng, has_missing, p)
    one = ld_pallas_sym.sym_partials(*args, **kw)
    nt = 256 // 16
    whole = ld_pallas_sym.new_partials(nt, kw["band"], 16, p, "cpu")
    assert (whole[2] is None) == (p == 0)
    for x0, x1 in ((0, 3), (3, 4), (4, 11), (11, nt)):
        got = ld_pallas_sym.range_partials(
            *args, x0, x1, out=tuple(None if x is None else x[x0:x1]
                                     for x in whole), **kw)
        for a, b in zip(got, whole):
            assert (a is None and b is None) or (
                a.data_ptr() == b[x0:x1].data_ptr())
    for a, b in zip(one, whole):
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_wave_bounds_cut_the_launches_at_whole_waves():
    # the chromosome shape of K1's clean branch: 512 pivot tiles of 9
    # CTAs (the last few fewer), 132 multiprocessors, 16 launches
    ctas = [9] * 500 + [5, 4, 3, 2, 1] + [0] * 7
    b = ld_pallas_sym.wave_bounds(ctas, 16, 132)
    assert len(b) == 17 and b[0] == 0 and b[-1] == len(ctas)
    assert all(x0 < x1 for x0, x1 in zip(b, b[1:]))
    waves = [-(-sum(ctas[x0:x1]) // 132) for x0, x1 in zip(b, b[1:])]
    assert sum(waves) == -(-sum(ctas) // 132) == 35
    # the segments' own edges (32 tiles, 288 CTAs each) take 3 waves each
    assert sum(-(-sum(ctas[x:x + 32]) // 132)
               for x in range(0, 512, 32)) == 47
    # as many launches as tiles: one tile each
    assert ld_pallas_sym.wave_bounds([4] * 16, 16, 132) == list(range(17))


def test_segments_are_the_reference_count():
    assert ld_pallas_sym.segments(600, 16, True) == (
        [(s0, 3) for s0 in range(0, 36, 3)] + [(36, 2)])
    assert ld_pallas_sym.segments(600, 16, False) == [(0, 38)]
    assert ld_pallas_sym.segments(65_536, 512, True) == [
        (s0, 8) for s0 in range(0, 128, 8)]
    assert ld_pallas_sym.segments(300, 512, True) == [(0, 1)]


def test_cli_pallas_and_progress(rng, tmp_path, port_log):
    g = random_genotypes(rng, 300, 120, missing_rate=0.02)
    bp = make_positions(300, spacing=700, jitter_rng=rng).astype(np.int64)
    prefix = write_plink(tmp_path / "chr3", g, bp=bp)
    base = ["ld", "--bfile", prefix, "-kb", "6", "-maf", "0.01", "--extra",
            "--device", "cpu", "--block-size", "32"]
    out = {}
    for name, flags in (("engine", ["--engine", "pallas"]),
                        ("alias", ["--pallas"]),
                        ("progress", ["--progress"]),
                        ("quiet", ["--no-progress"])):
        port_log.clear()
        cli.main([*base, *flags, "-o", str(tmp_path / f"{name}.L2")])
        out[name] = (tmp_path / f"{name}.L2").read_bytes()
        ticks = [r.getMessage() for r in port_log.records
                 if r.getMessage().startswith("LD pass")]
        # 10 blocks of 32 rows: a line after each segment, none at 0
        assert len(ticks) == (10 if name == "progress" else 0), name
    # every row carries a missing genotype: --engine pallas and the
    # default both take the global route
    assert out["alias"] == out["engine"] == out["quiet"]
    a, b = (_columns(out[k]) for k in ("progress", "quiet"))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **GOLDEN)


def _columns(l2: bytes) -> dict:
    header, *rows = (line.split("\t") for line in l2.decode().splitlines())
    return {h: np.array([float(r[i]) if r[i] else np.nan for r in rows])
            for i, h in enumerate(header) if h != "SNP"}
