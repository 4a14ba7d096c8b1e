"""The port at UK Biobank width on the CPU: N = 315,599 samples (the
reference's UK Biobank count; N_pad = 315,648, so the sample padding runs
at width) on a thin slice of SNPs, against the JAX package.

The chromosome is ``chip_smoke.write_chromosome``'s, the one
``scripts/ukb_width_cuda.py`` and phase 32 draw on the card (local LD, 5%
missing genotypes in every 50th SNP), 100 bp apart, with a +-50-SNP
window and 64-row pivot blocks, so that windows cross blocks.  In core (split and
global routes) and streamed (64-row chunks, then resumed): counters
equal to the JAX package's, l2/l2d within tests/test_golden.py's
tolerances, the resume bitwise the uninterrupted run; the card-side
.bed packer against ``write_plink``'s bytes; the unpack and
count steps bounded by width; and ``scan_rowmiss`` in small blocks
bitwise one block.  The module's runs at N = 315,599 are made once, in
a module fixture: the suite's ``--dist loadfile`` (pytest-xdist) keeps a
module on one worker.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.io.plink import PackedBed as JaxPackedBed
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu.ld import streaming as jax_streaming
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.io.plink import (BedReader, encode_bed_bytes,
                                      scan_rowmiss, write_plink)
from nldsc_tpu_torch.ld import ld_int8, pipeline, preprocess, streaming

import chip_smoke as cs
from contract import assert_counters_equal
from test_torch_split import _route_spies

M, N = 256, 315_599
KW = dict(ld_wind=5000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=64)
CHUNK = 64


@pytest.fixture
def one_thread():
    """torch on one thread, for the tests of many small ops: beside the
    suite's other workers, each op's intra-op threads wait longer for a
    core than they work (a packer case took 1.5 s on eight threads under
    six workers, 0.08 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """The .bed, its packed rows and positions, and the results of each
    run, computed once for the module."""
    tmp = tmp_path_factory.mktemp("wide")
    prefix = cs.write_chromosome(torch, str(tmp / "ukb"), M, N, 2026, "cpu")
    bed = BedReader(prefix + ".bed", M, N)
    return {"tmp": tmp, "bed": bed, "packed": bed.read_raw(),
            "pos": np.arange(1, M + 1, dtype=np.int64) * cs.SPACING,
            "runs": {}}


def _incore(wide, route, monkeypatch):
    """The port's and the JAX package's in-core run on ``route``, each
    checked to take it."""
    if route not in wide["runs"]:
        spies = _route_spies(monkeypatch)
        split = None if route == "split" else False
        ours = pipeline.compute_ld_scores(
            wide["packed"], wide["pos"],
            LDConfig(split_missing=split, **KW), device="cpu")
        raw = wide["packed"]
        theirs = jax_pipeline.compute_ld_scores(
            JaxPackedBed(raw.raw, M, N, raw.has_missing), wide["pos"],
            JaxLDConfig(split_missing=split, **KW))
        assert spies("ours") == spies("jax") == route
        wide["runs"][route] = ours, {k: np.asarray(v)
                                     for k, v in theirs.items()}
    return wide["runs"][route]


def _close(a, b):
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(a[k], b[k], equal_nan=True, err_msg=k,
                                   **cs.GOLDEN_TOL)


@pytest.mark.parametrize("route", ["split", "global"])
def test_wide_incore_matches_jax(wide, route, monkeypatch):
    ours, theirs = _incore(wide, route, monkeypatch)
    assert np.isfinite(ours["l2"]).all()
    assert_counters_equal(ours, theirs)
    _close(ours, theirs)


def test_wide_split_equals_global(wide, monkeypatch):
    split, _ = _incore(wide, "split", monkeypatch)
    glob, _ = _incore(wide, "global", monkeypatch)
    assert_counters_equal(split, glob)
    _close(split, glob)


def test_wide_streamed_matches_jax_and_resumes(wide, monkeypatch):
    ck = wide["tmp"] / "ck"
    cfg = LDConfig(**KW)
    ours = streaming.compute_ld_scores_streaming(
        wide["bed"], wide["pos"], cfg, chunk_rows=CHUNK,
        resume_path=str(ck), device="cpu")
    shards = sorted(ck.glob("chunk_*.npz"))
    assert len(shards) == M // CHUNK
    shards[-1].unlink()
    resumed = streaming.compute_ld_scores_streaming(
        wide["bed"], wide["pos"], cfg, chunk_rows=CHUNK,
        resume_path=str(ck), device="cpu")
    assert set(resumed) == set(ours)
    for k in ours:
        np.testing.assert_array_equal(resumed[k], ours[k], err_msg=k)
    theirs = jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(wide["bed"].path, M, N), wide["pos"],
        JaxLDConfig(**KW), chunk_rows=CHUNK)
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    assert_counters_equal(ours, theirs)
    _close(ours, theirs)
    incore, _ = _incore(wide, "split", monkeypatch)
    assert_counters_equal(ours, incore)
    _close(ours, incore)


@pytest.mark.parametrize("n", [1001, 1002, 1003, 1004])
@pytest.mark.usefixtures("one_thread")
def test_packer_writes_write_plinks_bytes(tmp_path, n):
    """The card-side packer of ``chip_smoke.py`` (phase 32 and
    scripts/ukb_width_cuda.py) gives the bytes ``write_plink`` writes for
    the same codes, pad bitpairs included, and its bfile is
    ``write_plink``'s byte for byte."""
    m = 120
    codes = torch.cat([c for _, c in cs.chromosome_blocks(
        torch, m, n, 7, "cpu", block=64)])
    g = codes.numpy()
    assert set(np.unique(g)) == {-1, 0, 1, 2}
    assert (g[::cs.MISS_EVERY] < 0).any(axis=1).all()
    np.testing.assert_array_equal(cs.pack_codes(torch, codes).numpy(),
                                  encode_bed_bytes(g))
    ours = cs.write_chromosome(torch, str(tmp_path / "ours"), m, n, 7, "cpu",
                               block=64)
    ref = write_plink(tmp_path / "ref", g,
                      bp=np.arange(1, m + 1, dtype=np.int64) * cs.SPACING)
    for suffix in (".bed", ".bim", ".fam"):
        assert (Path(ours + suffix).read_bytes()
                == Path(ref + suffix).read_bytes()), suffix


@pytest.mark.parametrize("n_pad", [3_072, 16_384, 315_648])
def test_steps_bound_their_temporaries_at_width(n_pad):
    """F5: the unpack, the per-row counts and the f32 engine's rows go
    through the rows in steps of a fixed number of genotypes, whatever
    the width: at N = 16,384 the steps the in-core peaks were measured
    with (8,192, 4,096 and 2,048 rows), at UK Biobank width fewer rows,
    so that their temporaries stay a few hundred MB and the in-core bytes
    per genotype hold."""
    budgets = (preprocess.STEP_GENOTYPES, ld_int8.COUNT_GENOTYPES,
               preprocess.F32_STEP_GENOTYPES)
    rows = [ld_int8.step_rows(n_pad, b) for b in budgets]
    for r, b in zip(rows, budgets):
        assert r * n_pad <= b
    if n_pad == 16_384:
        assert rows == [8192, 4096, 2048]
    if n_pad == 315_648:
        assert rows == [425, 212, 106]


@pytest.mark.usefixtures("one_thread")
def test_steps_at_width_equal_one_step(monkeypatch):
    """At N = 315,599 the unpack, the class counts and the f32 engine's
    standardized rows in steps of a few rows (the last one ragged) equal
    a single step over every row."""
    rng = np.random.default_rng(32)
    g = rng.integers(-1, 3, size=(12, N), dtype=np.int8)
    raw = torch.from_numpy(encode_bed_bytes(g))
    ok = torch.ones(12, dtype=torch.bool)
    n_pad = 315_648

    def run(budget):
        for name in ("STEP_GENOTYPES", "F32_STEP_GENOTYPES"):
            monkeypatch.setattr(preprocess, name, budget)
        monkeypatch.setattr(ld_int8, "COUNT_GENOTYPES", budget)
        codes = preprocess.unpack_bed(raw, N, n_pad, -1)
        return (codes, *ld_int8.code_matrices(codes, N)[1],
                *preprocess.preprocess_block(codes, ok, 0.01, N).values())

    assert ld_int8.step_rows(n_pad, 5 * n_pad) == 5
    many = run(5 * n_pad)
    np.testing.assert_array_equal(many[0][:, :N].numpy(), g)
    for a, b in zip(many, run(1 << 40)):
        assert torch.equal(a, b)


def test_scan_rowmiss_blocks_equal_one_block(wide):
    """``scan_rowmiss`` at any block size (here down to a row) flags the
    rows one block over the whole file flags."""
    one = scan_rowmiss(wide["bed"], block_rows=M)
    assert one.sum() == -(-M // 50)
    for rows in (1, 7, 64):
        np.testing.assert_array_equal(scan_rowmiss(wide["bed"],
                                                   block_rows=rows), one)


def test_missing_scans_hold_little_host_memory(tmp_path):
    """F6: the row-missing scan and ``read_raw``'s missing test hold one
    read of the .bed and small temporaries, not 4-5x a 65,536-row block
    (18.7 GiB of host memory at N = 300,032): the peak numpy allocation
    of each, traced, stays near the bytes it must hold."""
    import tracemalloc

    from nldsc_tpu_torch.io import plink

    m = 512
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, (m, (N + 3) // 4), dtype=np.uint8)
    raw &= ~plink._miss_bytes(raw, N)
    raw[::50, 7] = 0x55                       # 2% of the rows contaminated
    with open(tmp_path / "w.bed", "wb") as f:
        f.write(plink.PLINK_MAGIC)
        f.write(raw.tobytes())
    bed = plink.BedReader(tmp_path / "w.bed", m, N)
    tracemalloc.start()
    try:
        flags = scan_rowmiss(bed)
        scan_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        packed = bed.read_raw()
        read_peak = tracemalloc.get_traced_memory()[1] - raw.nbytes
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(flags, np.arange(m) % 50 == 0)
    assert packed.has_missing
    assert scan_peak <= 96 << 20, scan_peak
    assert read_peak <= 8 << 20, read_peak
