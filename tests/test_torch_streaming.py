"""The port's streaming route (``nldsc_tpu_torch/ld/streaming.py``) against
the JAX package's and the port's in-core route, its checkpoint/resume
contract and its routing rules (on the CPU: the plain twins)."""

import json
import logging
import os

import numpy as np
import pytest
import torch

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu.ld import streaming as jax_streaming
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.logging import log
from nldsc_tpu_torch.core.timing import STAGE_TIMES
from nldsc_tpu_torch.io.plink import PlinkDataset, scan_rowmiss, write_plink
from nldsc_tpu_torch.ld import (ld_int8, ld_pallas_sym, ld_split, pipeline,
                                streaming)

from test_ld_split import row_level_missing
from test_torch_split import _route_spies
from utils import make_positions, random_genotypes

KW = dict(wind_metric="bp", maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3,
          block_size=16)
FLOATS = ("l2", "l2d", "maf", "residuals_std")
COUNTERS = ("l2_ws", "l2d_ws", "l2d_wse")


def _genotypes(rng, kind, m, n):
    if kind == "clean":
        return random_genotypes(rng, m, n, missing_rate=0.0)
    if kind == "global":
        return random_genotypes(rng, m, n, missing_rate=0.04)
    return row_level_missing(rng, m, n, row_frac=0.1, entry_rate=0.3)


def _bfile(tmp_path, rng, kind, m=300, n=180, name="s", spacing=800):
    g = _genotypes(rng, kind, m, n)
    pos = make_positions(m, spacing=spacing, jitter_rng=rng)
    prefix = write_plink(tmp_path / name, g, bp=pos.astype(np.int64))
    return g, pos, PlinkDataset.parse(prefix).bed


def _assert_close(a, b):
    for k in FLOATS:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in COUNTERS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _stream(bed, pos, wind, chunk, resume_path=None, **kw):
    cfg = LDConfig(ld_wind=wind, **{**KW, **kw})
    return streaming.compute_ld_scores_streaming(
        bed, pos, cfg, chunk_rows=chunk, resume_path=resume_path,
        device="cpu")


def _jax_stream(bed, pos, wind, chunk, **kw):
    cfg = JaxLDConfig(ld_wind=wind, **{**KW, **kw})
    return jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos, cfg,
        chunk_rows=chunk)


def _chunk_routes(monkeypatch):
    """Per-chunk routes of both streaming engines: ``clean``, ``global``
    (the 8-product branch) or ``split`` (clean pass + corrections)."""
    seen = {"ours": [], "jax": []}
    k1, k2 = ld_pallas_sym.sym_credits, ld_split.split_corrections
    jax_chunk = jax_streaming._chunk_dispatch_sym

    def our_k1(*a, **kw):
        seen["ours"].append("global" if kw["has_missing"] else "clean")
        return k1(*a, **kw)

    def our_k2(*a, **kw):
        seen["ours"][-1] = "split"
        return k2(*a, **kw)

    def their_chunk(*a, **kw):
        seen["jax"].append("split" if kw["use_split"] else
                           "global" if kw["has_missing"] else "clean")
        return jax_chunk(*a, **kw)

    monkeypatch.setattr(ld_pallas_sym, "sym_credits", our_k1)
    monkeypatch.setattr(ld_split, "split_corrections", our_k2)
    monkeypatch.setattr(jax_streaming, "_chunk_dispatch_sym", their_chunk)
    return seen


@pytest.mark.parametrize("kind", ["clean", "global", "split"])
def test_streaming_matches_jax_and_incore(tmp_path, rng, monkeypatch, kind):
    g, pos, bed = _bfile(tmp_path, rng, kind)
    routes = _chunk_routes(monkeypatch)
    ours = _stream(bed, pos, 9000, 64)
    theirs = _jax_stream(bed, pos, 9000, 64)
    _assert_close(ours, theirs)
    assert routes["ours"] == routes["jax"]
    assert len(routes["ours"]) == 5
    assert kind in routes["ours"]
    if kind != "split":
        assert set(routes["ours"]) == {kind}
    incore = pipeline.compute_ld_scores(g, pos, LDConfig(ld_wind=9000, **KW),
                                        device="cpu")
    _assert_close(ours, incore)


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_streaming_chunk_sweep_wide_halo(tmp_path, rng, chunk):
    # a 30 kb window spans ~37 rows: halo 48 > chunk_rows 16 and 32, so
    # column credits ride the carry across several chunks
    g, pos, bed = _bfile(tmp_path, rng, "split", m=260, n=150)
    lo, hi, _ = streaming.windows.window_bounds(pos, 30000.0)
    geo = streaming.stream_geometry(len(pos), lo, hi, chunk, 16, "cpu")
    assert geo.halo == 48 and geo.chunk_rows == chunk
    ours = _stream(bed, pos, 30000, chunk)
    _assert_close(ours, _jax_stream(bed, pos, 30000, chunk))
    _assert_close(ours, pipeline.compute_ld_scores(
        g, pos, LDConfig(ld_wind=30000, **KW), device="cpu"))


@pytest.mark.parametrize("chunk", [16, 64])
def test_retention_on_off_bitwise(tmp_path, rng, chunk):
    # split_missing=False skips the row scan, which retention needs; on
    # clean data both runs take the clean route
    _, pos, bed = _bfile(tmp_path, rng, "clean")
    STAGE_TIMES.clear()
    on = _stream(bed, pos, 9000, chunk)
    put_on = STAGE_TIMES["stream_put_mb"]
    STAGE_TIMES.clear()
    off = _stream(bed, pos, 9000, chunk, split_missing=False)
    put_off = STAGE_TIMES["stream_put_mb"]
    _assert_bitwise(on, off)
    geo = streaming.stream_geometry(300, *streaming.windows.window_bounds(
        pos, 9000.0)[:2], chunk, 16, "cpu")
    bps = bed.bytes_per_snp
    # retention sends the first band whole, then chunk_rows per chunk
    assert put_on * 1e6 == pytest.approx(
        (geo.band_rows + (geo.n_chunks - 1) * geo.chunk_rows) * bps)
    assert put_off * 1e6 == pytest.approx(geo.n_chunks * geo.band_rows * bps)


def _shards(ck):
    return sorted(f for f in os.listdir(ck) if f.startswith("chunk_"))


def test_resume_bitwise_and_noncontiguous(tmp_path, rng, caplog):
    _, pos, bed = _bfile(tmp_path, rng, "split")
    ck = str(tmp_path / "ck")
    full = _stream(bed, pos, 20000, 32, resume_path=ck)
    shards = _shards(ck)
    assert len(shards) == 10 and os.path.exists(os.path.join(ck, "meta.json"))
    with np.load(os.path.join(ck, "rowmiss.npz")) as rm:
        np.testing.assert_array_equal(rm["rowmiss"], scan_rowmiss(bed))
    _assert_bitwise(full, _stream(bed, pos, 20000, 32))   # no checkpoint
    for f in shards[3:]:
        os.remove(os.path.join(ck, f))
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=log.name):
            resumed = _stream(bed, pos, 20000, 32, resume_path=ck)
    finally:
        log.removeHandler(caplog.handler)
    _assert_bitwise(resumed, full)
    assert "Resuming: 3 chunks already complete" in caplog.text
    assert "rowmiss: read the cached bitmap" in caplog.text
    assert "resumed 3" in caplog.text
    # a hole: the shards after it are orphans and run again
    os.remove(os.path.join(ck, shards[1]))
    _assert_bitwise(_stream(bed, pos, 20000, 32, resume_path=ck), full)
    # no reusable prefix at all
    os.remove(os.path.join(ck, shards[0]))
    _assert_bitwise(_stream(bed, pos, 20000, 32, resume_path=ck), full)


@pytest.mark.parametrize("change", ["chunk_rows", "maf_thr", "rsq_thr",
                                    "ld_wind", "device"])
def test_resume_refuses_other_parameters(tmp_path, rng, change):
    _, pos, bed = _bfile(tmp_path, rng, "clean", m=160, n=130)
    ck = str(tmp_path / "ck")
    _stream(bed, pos, 9000, 32, resume_path=ck)
    kw = {"chunk_rows": dict(chunk=64), "maf_thr": dict(maf_thr=0.05),
          "rsq_thr": dict(rsq_thr=0.05), "ld_wind": dict(wind=8000),
          "device": {}}[change]
    if change == "device":
        # a checkpoint of a CUDA run is never spliced into a CPU run
        meta_path = os.path.join(ck, "meta.json")
        meta = json.load(open(meta_path))
        assert meta["device"] == "cpu" and meta["row_unit"] == 16
        meta["device"] = "cuda"
        json.dump(meta, open(meta_path, "w"))
    args = {"wind": 9000, "chunk": 32, **kw}
    wind, chunk = args.pop("wind"), args.pop("chunk")
    with pytest.raises(ValueError, match="different parameters"):
        _stream(bed, pos, wind, chunk, resume_path=ck, **args)


def test_regenerated_bed_is_not_spliced(tmp_path, rng):
    """A .bed written anew with the same shape has the same size: the
    rowmiss cache and the meta key on its modification time too."""
    g, pos, bed = _bfile(tmp_path, rng, "split", m=200, n=120)
    ck = tmp_path / "ck"
    _stream(bed, pos, 9000, 32, resume_path=str(ck))
    size, mtime = os.path.getsize(bed.path), os.stat(bed.path).st_mtime_ns
    g2 = row_level_missing(rng, 200, 120, row_frac=0.3, entry_rate=0.3)
    write_plink(tmp_path / "s", g2, bp=pos.astype(np.int64))
    os.utime(bed.path, ns=(mtime + 10**9, mtime + 10**9))
    assert os.path.getsize(bed.path) == size
    rowmiss = streaming.load_rowmiss(bed, ck)
    np.testing.assert_array_equal(rowmiss, (g2 < 0).any(axis=1))
    assert not np.array_equal(rowmiss, (g < 0).any(axis=1))
    with pytest.raises(ValueError, match="bed_mtime_ns"):
        _stream(bed, pos, 9000, 32, resume_path=str(ck))


@pytest.mark.parametrize("m, n", [(1000, 100), (2_796_203, 1024),
                                  (2_796_202, 1024), (1_000_000, 3000)])
def test_auto_streaming_on_cpu_is_the_reference_rule(m, n):
    n_pad = -(-n // 128) * 128
    want = 3 * m * n_pad > jax_pipeline.STREAMING_BYTES_THRESHOLD
    assert pipeline.wants_streaming(m, n, torch.device("cpu")) == want


def test_estimate_lds_auto_streams_above_threshold(tmp_path, rng,
                                                   monkeypatch, caplog):
    g = random_genotypes(rng, 200, 130, missing_rate=0.0)
    prefix = write_plink(tmp_path / "a", g,
                         bp=make_positions(200, spacing=700).astype(np.int64))
    incore = pipeline.estimate_lds(prefix, 5, "kbp", maf_thr=0.01,
                                   block_size=16, device="cpu")
    monkeypatch.setattr(pipeline, "STREAMING_BYTES_THRESHOLD", 0)
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=log.name):
            streamed = pipeline.estimate_lds(prefix, 5, "kbp", maf_thr=0.01,
                                             block_size=16, chunk_rows=64,
                                             device="cpu")
    finally:
        log.removeHandler(caplog.handler)
    assert "LD route: streaming (4 chunks of 64 rows" in caplog.text
    for k in ("L2", "L2D"):
        np.testing.assert_allclose(streamed[k], incore[k], rtol=1e-6,
                                   atol=1e-6, equal_nan=True)
    np.testing.assert_array_equal(streamed["BP"], incore["BP"])


def _rules_case(rng, case):
    """``threshold``: 78 of 300 rows contaminated, 24.4% of the in-core
    denominator (320 rows at block 32) but 26% of the real rows;
    ``unusable``: only rows that fail the MAF filter are contaminated."""
    m, n = 300, 160
    g = random_genotypes(rng, m, n, missing_rate=0.0, maf_low=0.1)
    if case == "threshold":
        rows = rng.choice(m, 78, replace=False)
    else:
        rows = rng.choice(m, 12, replace=False)
        g[rows] = 0                         # monomorphic: unusable
    for r in rows:
        g[r] = np.where(rng.random(n) < 0.2, np.int8(-1), g[r])
    return g, {"threshold": ("split", "global"),
               "unusable": ("clean", "split")}[case]


@pytest.mark.parametrize("case", ["threshold", "unusable"])
def test_incore_and_streaming_routing_rules(tmp_path, rng, monkeypatch,
                                            case):
    g, (want_incore, want_stream) = _rules_case(rng, case)
    pos = make_positions(g.shape[0], spacing=800, jitter_rng=rng)
    prefix = write_plink(tmp_path / "r", g, bp=pos.astype(np.int64))
    bed = PlinkDataset.parse(prefix).bed
    kw = {**KW, "block_size": 32}
    route = _route_spies(monkeypatch)
    pipeline.compute_ld_scores(g, pos, LDConfig(ld_wind=9000, **kw),
                               device="cpu")
    jax_pipeline.compute_ld_scores(g, pos, JaxLDConfig(ld_wind=9000, **kw))
    assert route("ours") == route("jax") == want_incore
    monkeypatch.undo()
    routes = _chunk_routes(monkeypatch)
    ours = streaming.compute_ld_scores_streaming(
        bed, pos, LDConfig(ld_wind=9000, **kw), chunk_rows=64, device="cpu")
    theirs = jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos,
        JaxLDConfig(ld_wind=9000, **kw), chunk_rows=64)
    assert routes["ours"] == routes["jax"]
    assert want_stream in routes["ours"]
    _assert_close(ours, theirs)


def test_f1_route_fraction_uses_the_reference_denominator(rng, monkeypatch):
    """M = 600 with 200 contaminated usable rows: the reference takes the
    fraction over 1,024 rows (block 512) and splits; over the CUDA
    padding (640 rows) it would be 0.3125 and global."""
    m, n = 600, 64
    g = random_genotypes(rng, m, n, missing_rate=0.0, maf_low=0.2)
    rows = rng.choice(m, 200, replace=False)
    g[rows[:, None], rng.integers(0, n, (200, 3))] = -1
    pos = make_positions(m, spacing=800)
    route = _route_spies(monkeypatch)
    jax_pipeline.compute_ld_scores(
        g, pos, JaxLDConfig(ld_wind=3000, **{**KW, "block_size": 512}))
    assert route("jax") == "split"
    m_pad_cuda, _ = pipeline.padded_shape(m, n, "cuda", 512)
    assert m_pad_cuda == 640 and 200 / m_pad_cuda > 0.25
    rowmiss = np.zeros(m_pad_cuda, bool)
    rowmiss[:m] = (g < 0).any(axis=1)
    assert pipeline.incore_route(rowmiss, m, 512, None) == ("split",
                                                            200 / 1024)
    ours = pipeline.compute_ld_scores(
        g, pos, LDConfig(ld_wind=3000, **{**KW, "block_size": 512}),
        device="cpu")
    assert route("ours") == "split"
    assert np.isfinite(ours["l2"]).all()


@pytest.mark.parametrize("has_missing", [False, True])
def test_sym_credits_band_scans_pivots_only(rng, has_missing):
    """``pivot_rows``: the halo rows are neighbours only, as a scan of
    the pivot blocks alone credits them."""
    m, n, B = 128, 140, 16
    g = random_genotypes(rng, m, n, missing_rate=0.03 if has_missing else 0)
    gp = np.full((m, 256), -1, np.int8)
    gp[:, :n] = g
    lo, hi, pos_ok = streaming.windows.window_bounds(
        make_positions(m, spacing=700), 5000.0)
    pre = ld_int8.preprocess_int8(torch.from_numpy(gp),
                                  torch.from_numpy(pos_ok), 0.01, n)
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            torch.from_numpy(lo), torch.from_numpy(hi), pre["usable"],
            dom_ok, pre["add_sd_zero"])
    band = ld_pallas_sym.sym_credits(*args, 1e-3, n_samples=n,
                                     has_missing=has_missing, block_size=B,
                                     pivot_rows=64)
    ref = ld_int8.sym_scan_segment(
        *args, 1e-3, 0, block_size=B,
        right_k=ld_int8.band_extent(args[5], B)[1], n_samples=n,
        n_scan_blocks=64 // B, has_missing=has_missing)
    for a, b in zip(band, ref):
        assert torch.equal(a, b)
    assert int(band[1][64:].sum()) > 0          # the halo's column credits
