"""The full-band streaming chunk engines of the port (``ld --no-symmetric
--streaming`` on int8 or bf16 operands, ``ld --engine f32 --streaming``)
against the JAX package's and the port's own in-core full band, their
checkpoint/resume contract and routing, and the ``ld`` flags
``--profile-dir`` and ``--log-file``, on the CPU.

Tolerances: against the JAX package the scores within the golden
tolerances (rtol 2e-5, atol 2e-4) and the counters equal for the integer
engines, under ``contract.assert_counters_match`` with ``f32_tol`` for the
f32 engine; against the port's in-core full band the
integer engines' counters equal and scores within rtol 1e-6 (the same
products, in other tiles); bf16 operands bit for bit the int8 run.
"""

import json
import logging
import os

import numpy as np
import pytest

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.ld import streaming as jax_streaming
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.logging import log
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import ld_pallas_sym, ld_split, pipeline, streaming

from contract import assert_counters_equal, assert_counters_match, f32_tol
from test_torch_streaming import _assert_bitwise
from utils import adversarial_genotypes, make_positions, random_genotypes

KW = dict(wind_metric="bp", maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3,
          block_size=16)
GOLDEN_TOL = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
SCORES = ("l2", "l2d", "maf")
COUNTERS = ("l2_ws", "l2d_ws", "l2d_wse")


def _genotypes(rng, kind, m, n):
    """``clean``, ``missing`` (4% of the genotypes) or ``adversarial``
    (2% missing, the edge-case rows of ``adversarial_genotypes`` and an
    all-missing row)."""
    if kind == "clean":
        return random_genotypes(rng, m, n, missing_rate=0.0)
    if kind == "missing":
        return random_genotypes(rng, m, n, missing_rate=0.04)
    g = random_genotypes(rng, m, n, missing_rate=0.02)
    g[40:46] = adversarial_genotypes(rng, n)
    g[100] = -1
    return g


def _bfile(tmp_path, rng, kind, m=300, n=180, name="f", spacing=800):
    g = _genotypes(rng, kind, m, n)
    pos = make_positions(m, spacing=spacing, jitter_rng=rng)
    prefix = write_plink(tmp_path / name, g, bp=pos.astype(np.int64))
    return g, pos, PlinkDataset.parse(prefix).bed, prefix


def _cfg(wind, **kw):
    return LDConfig(ld_wind=wind, **{**KW, "symmetric": False, **kw})


def _stream(bed, pos, wind, chunk, resume_path=None, annot=None, **kw):
    return streaming.compute_ld_scores_streaming(
        bed, pos, _cfg(wind, **kw), chunk_rows=chunk,
        resume_path=resume_path, annot=annot, device="cpu")


def _jax_stream(bed, pos, wind, chunk, annot=None, **kw):
    cfg = JaxLDConfig(ld_wind=wind, **{**KW, "symmetric": False, **kw})
    return jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos, cfg,
        chunk_rows=chunk, annot=annot)


def _incore(g, pos, wind, annot=None, **kw):
    return pipeline.compute_ld_scores(g, pos, _cfg(wind, **kw), annot=annot,
                                      device="cpu")


def _assert_jax(ours, theirs, g, pos, wind, tol=None, keys=SCORES):
    """Scores within the golden tolerances; counters equal (the integer
    engines, ``tol`` None) or under the f32 contract with ``tol``:
    returns the number of exempted rows."""
    for k in keys:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k,
                                   **GOLDEN_TOL)
    np.testing.assert_allclose(ours["residuals_std"], theirs["residuals_std"],
                               rtol=1e-6, equal_nan=True)
    if tol is None:
        assert_counters_equal(ours, theirs)
        return 0
    return assert_counters_match(ours, theirs, g, pos, _cfg(wind), tol)


def _assert_same_engine(ours, incore):
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(ours[k], incore[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in COUNTERS:
        np.testing.assert_array_equal(ours[k], incore[k], err_msg=k)


def _no_kernel_calls(monkeypatch):
    """Fail on any call of the symmetric kernels' wrappers: the full band
    runs neither K1 nor K2."""
    def refuse(*a, **kw):
        raise AssertionError("a full-band chunk called a K1/K2 wrapper")
    monkeypatch.setattr(ld_pallas_sym, "sym_credits", refuse)
    monkeypatch.setattr(ld_split, "split_corrections", refuse)


@pytest.mark.parametrize("chunk", [64, 96, 512])
@pytest.mark.parametrize("kind", ["clean", "missing", "adversarial"])
def test_full_band_int8_matches_jax_and_incore(tmp_path, rng, monkeypatch,
                                               kind, chunk):
    g, pos, bed, _ = _bfile(tmp_path, rng, kind)
    _no_kernel_calls(monkeypatch)
    ours = _stream(bed, pos, 9000, chunk)
    assert _assert_jax(ours, _jax_stream(bed, pos, 9000, chunk), g, pos,
                       9000) == 0
    _assert_same_engine(ours, _incore(g, pos, 9000))


def test_full_band_halo_wider_than_chunk(tmp_path, rng):
    # a 30 kb window spans ~37 rows: halo 48 > chunk_rows 16, and each
    # band holds the 48 rows before its 16 pivots and the 48 after
    g, pos, bed, _ = _bfile(tmp_path, rng, "missing", m=260, n=150)
    lo, hi, _ = streaming.windows.window_bounds(pos, 30000.0)
    geo = streaming.stream_geometry(len(pos), lo, hi, 16, 16, "cpu",
                                    full_band=True)
    assert (geo.halo, geo.lead, geo.band_rows) == (48, 48, 16 + 2 * 48)
    ours = _stream(bed, pos, 30000, 16)
    assert _assert_jax(ours, _jax_stream(bed, pos, 30000, 16), g, pos,
                       30000) == 0
    _assert_same_engine(ours, _incore(g, pos, 30000))


@pytest.mark.parametrize("kind", ["clean", "missing"])
def test_full_band_bf16_bitwise_int8(tmp_path, rng, kind):
    _, pos, bed, _ = _bfile(tmp_path, rng, kind)
    _assert_bitwise(_stream(bed, pos, 9000, 96, int8_dot_dtype="bf16"),
                    _stream(bed, pos, 9000, 96))


@pytest.mark.parametrize("kind", ["clean", "missing", "adversarial"])
def test_f32_streaming_matches_jax_and_incore(tmp_path, rng, monkeypatch,
                                              kind):
    g, pos, bed, _ = _bfile(tmp_path, rng, kind)
    _no_kernel_calls(monkeypatch)
    tol = f32_tol(256, 180, 1e-3)
    ours = _stream(bed, pos, 9000, 96, use_int8=False)
    assert _assert_jax(ours, _jax_stream(bed, pos, 9000, 96, use_int8=False),
                       g, pos, 9000, tol) <= 3
    assert _assert_jax(ours, _incore(g, pos, 9000, use_int8=False), g, pos,
                       9000, tol) <= 3


@pytest.mark.parametrize("use_int8", [True, False], ids=["int8", "f32"])
def test_annot_full_band_streamed_matches_jax(tmp_path, rng, use_int8):
    g, pos, bed, _ = _bfile(tmp_path, rng, "missing")
    a = np.column_stack([np.ones(300), rng.random(300) < 0.3,
                         rng.random(300)]).astype(np.float64)
    ours = _stream(bed, pos, 9000, 96, annot=a, use_int8=use_int8)
    theirs = _jax_stream(bed, pos, 9000, 96, annot=a, use_int8=use_int8)
    tol = None if use_int8 else f32_tol(256, 180, 1e-3)
    assert _assert_jax(ours, theirs, g, pos, 9000, tol,
                       SCORES + ("l2_annot", "l2d_annot")) <= 3
    incore = _incore(g, pos, 9000, annot=a, use_int8=use_int8)
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(ours[k], incore[k], err_msg=k,
                                   **GOLDEN_TOL)
    # the plain scores of an annotated run are the plain run's
    plain = _stream(bed, pos, 9000, 96, use_int8=use_int8)
    for k in plain:
        np.testing.assert_array_equal(ours[k], plain[k], err_msg=k)


def _capture(fn):
    log_lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            log_lines.append((record.levelno, record.getMessage()))

    handler = Keep(logging.INFO)
    log.addHandler(handler)
    try:
        return fn(), log_lines
    finally:
        log.removeHandler(handler)


@pytest.mark.parametrize("use_int8", [True, False], ids=["int8", "f32"])
def test_full_band_resume_takes_any_finished_chunks(tmp_path, rng,
                                                    monkeypatch, use_int8):
    _, pos, bed, _ = _bfile(tmp_path, rng, "missing")
    ck = str(tmp_path / "ck")
    full = _stream(bed, pos, 9000, 64, resume_path=ck, use_int8=use_int8)
    shards = sorted(f for f in os.listdir(ck) if f.startswith("chunk_"))
    assert len(shards) == 5 and "rowmiss.npz" not in os.listdir(ck)
    meta = json.load(open(os.path.join(ck, "meta.json")))
    assert meta["engine"] == "full"
    assert meta["dot_dtype"] == ("int8" if use_int8 else "f32")
    with np.load(os.path.join(ck, shards[0])) as shard:
        assert "tail" not in shard.files
    for i in (1, 3):
        os.remove(os.path.join(ck, shards[i]))
    read = streaming._BandReader.read
    ran = []

    def spy(self, ci, slot, tail_only):
        ran.append(ci)
        return read(self, ci, slot, tail_only)

    monkeypatch.setattr(streaming._BandReader, "read", spy)
    resumed, lines = _capture(lambda: _stream(
        bed, pos, 9000, 64, resume_path=ck, use_int8=use_int8))
    _assert_bitwise(resumed, full)
    assert ran == [1, 3]
    text = "\n".join(msg for _, msg in lines)
    assert "Resuming: 3 chunks already complete" in text
    assert "full band, " in text and "resumed 3)" in text


@pytest.mark.parametrize("first, second", [
    (dict(symmetric=None), dict()),
    (dict(), dict(symmetric=None)),
    (dict(), dict(use_int8=False)),
], ids=["symmetric-then-full", "full-then-symmetric", "int8-then-f32"])
def test_checkpoint_of_one_engine_refuses_another(tmp_path, rng, first,
                                                  second):
    _, pos, bed, _ = _bfile(tmp_path, rng, "clean", m=160, n=130)
    ck = str(tmp_path / "ck")
    _stream(bed, pos, 9000, 32, resume_path=ck, **first)
    key = "dot_dtype" if "use_int8" in second else "engine"
    with pytest.raises(ValueError, match=f"different parameters.*{key}"):
        _stream(bed, pos, 9000, 32, resume_path=ck, **second)


def test_geometry_and_band_reads_with_a_lead_halo(tmp_path, rng):
    g, pos, bed, _ = _bfile(tmp_path, rng, "clean", m=200, n=130)
    lo, hi, _ = streaming.windows.window_bounds(pos, 9000.0)
    sym = streaming.stream_geometry(200, lo, hi, 256, 64, "cuda")
    full = streaming.stream_geometry(200, lo, hi, 256, 64, "cuda",
                                     full_band=True)
    # on CUDA the symmetric route rounds to whole K1 tiles; no K1 tile
    # runs on the full band
    assert (sym.unit, sym.lead, sym.band_rows) == (128, 0, 256 + 128)
    assert (full.unit, full.halo, full.lead) == (64, 64, 64)
    assert full.band_rows == 256 + 2 * 64
    reader = streaming._BandReader(bed, full, None, pipeline.resolve_device(
        "cpu"))
    band = reader.read(0, 0, False).stage.numpy()
    # the lead rows before row 0, and the rows past the .bed, are missing
    assert (band[:64] == 0x55).all() and (band[64 + 200:] == 0x55).all()
    raw = bed.read_raw()
    np.testing.assert_array_equal(band[64:264], raw.raw)
    assert not reader.read(0, 0, False).has_missing


def test_estimate_lds_no_symmetric_streaming_runs_the_full_band(
        tmp_path, rng, monkeypatch):
    _, pos, bed, prefix = _bfile(tmp_path, rng, "missing", m=200, n=130)
    kw = dict(maf_thr=0.01, block_size=16, symmetric=False, device="cpu")
    incore = pipeline.estimate_lds(prefix, 9, "kbp", **kw)
    _no_kernel_calls(monkeypatch)
    streamed, lines = _capture(lambda: pipeline.estimate_lds(
        prefix, 9, "kbp", streaming=True, chunk_rows=64, **kw))
    text = "\n".join(msg for _, msg in lines)
    assert "LD route: streaming (4 chunks of 64 rows, halo 16: full band, "\
        "global 4)" in text
    assert not [msg for lvl, msg in lines if lvl >= logging.WARNING]
    for k in ("L2", "L2D"):
        np.testing.assert_allclose(streamed[k], incore[k], rtol=1e-6,
                                   atol=1e-6, equal_nan=True)


def test_estimate_lds_f32_streams_when_the_rule_says_so(tmp_path, rng,
                                                        monkeypatch):
    g, pos, bed, prefix = _bfile(tmp_path, rng, "clean", m=200, n=130)
    kw = dict(maf_thr=0.01, block_size=16, use_int8=False, symmetric=False,
              device="cpu", chunk_rows=64)
    incore = pipeline.estimate_lds(prefix, 9, "kbp", **kw)
    asked = []

    def wants(m, n, device, engine="int8"):
        asked.append(engine)
        return True

    monkeypatch.setattr(pipeline, "wants_streaming", wants)
    streamed, lines = _capture(lambda: pipeline.estimate_lds(
        prefix, 9, "kbp", **kw))
    assert asked == ["f32"]
    assert "halo 16: full band, f32 4)" in "\n".join(m for _, m in lines)
    for k in ("L2", "L2D"):
        np.testing.assert_allclose(streamed[k], incore[k], **GOLDEN_TOL)
    np.testing.assert_array_equal(streamed["BP"], incore["BP"])


def test_log_file_writes_nldsc_log(tmp_path, rng, monkeypatch):
    _, _, _, prefix = _bfile(tmp_path, rng, "clean", m=120, n=130)
    monkeypatch.chdir(tmp_path)
    before = list(log.handlers)
    cli.main(["--log-file", "ld", "--bfile", prefix, "-kb", "9", "-maf",
              "0.01", "--device", "cpu", "-o", str(tmp_path / "t.L2")])
    text = (tmp_path / "nldsc.log").read_text()
    assert "Estimation completed: 120 SNPs" in text
    assert "Wrote LD scores" in text
    # the command removes and closes its file handler
    assert log.handlers == before


@pytest.mark.parametrize("flags", [[], ["--streaming", "--chunk-rows", "64",
                                        "--engine", "f32"]],
                         ids=["in core", "streamed f32"])
def test_profile_dir_writes_a_trace(tmp_path, rng, flags):
    _, _, _, prefix = _bfile(tmp_path, rng, "clean", m=150, n=130)
    argv = ["ld", "--bfile", prefix, "-kb", "9", "-maf", "0.01", "--extra",
            "--device", "cpu", "--block-size", "16", *flags]
    cli.main(argv + ["-o", str(tmp_path / "plain.L2")])
    cli.main(argv + ["-o", str(tmp_path / "prof.L2"), "--profile-dir",
                     str(tmp_path / "prof")])
    assert ((tmp_path / "prof.L2").read_bytes()
            == (tmp_path / "plain.L2").read_bytes())
    trace = json.loads((tmp_path / "prof" / pipeline.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
