"""The PyTorch port's ``ld`` main path against the JAX package, the
golden fixture and its own CLI contract (run on the CPU: the plain twin)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.ld import pipeline as jax_pipeline
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.errors import NLDSCParameterError
from nldsc_tpu_torch.core.logging import log
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import ld_pallas_sym, pipeline

from test_golden import GOLDEN, MAF, RSQ, STD, WIND, check
from utils import adversarial_genotypes, make_positions, random_genotypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(rng, missing_rate, m=150, n=203):
    g = random_genotypes(rng, m, n, missing_rate=missing_rate)
    adv = adversarial_genotypes(rng, n)
    g[40:45] = adv[:5]
    if missing_rate:
        g[50] = adv[5]
        g[60] = -1
    pos = make_positions(m, spacing=700, jitter_rng=rng, skip_idx=(5, 90))
    return g, pos


def _assert_parity(ours, theirs):
    check(ours, theirs)
    np.testing.assert_allclose(ours["residuals_std"], theirs["residuals_std"],
                               rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("missing_rate", [0.0, 0.03])
@pytest.mark.parametrize("block_size", [32, 64])
def test_compute_ld_scores_matches_jax(rng, missing_rate, block_size):
    g, pos = _data(rng, missing_rate)
    kw = dict(ld_wind=5000, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
              rsq_thr=1e-3, block_size=block_size)
    ours = pipeline.compute_ld_scores(g, pos, LDConfig(**kw), device="cpu")
    theirs = jax_pipeline.compute_ld_scores(
        g, pos, JaxLDConfig(**kw, split_missing=False))
    _assert_parity(ours, theirs)


@pytest.mark.parametrize("m, n", [(1, 1), (64, 128), (127, 129),
                                  (300, 203), (65_536, 16_384)])
def test_kernel_path_pads_rows_to_row_alignment(m, n):
    # on CUDA the rows are padded before the route (clean 128-row tiles,
    # or missing 64-row tiles) is known: to a multiple of both tiles
    align = ld_pallas_sym.ROW_ALIGN
    assert align % ld_pallas_sym.TILE_CLEAN == 0
    assert align % ld_pallas_sym.TILE_MISSING == 0
    m_pad, n_pad = pipeline.padded_shape(m, n, "cuda", block_size=32)
    assert m_pad % align == 0 and m <= m_pad < m + align
    assert n_pad % 128 == 0 and n <= n_pad < n + 128
    m_cpu, n_cpu = pipeline.padded_shape(m, n, "cpu", block_size=32)
    assert m_cpu % 32 == 0 and m <= m_cpu < m + 32 and n_cpu == n_pad


def test_compute_ld_scores_pads_through_helper(rng, monkeypatch):
    calls = []

    def spy(m, n, device_type, block_size):
        calls.append((m, n, device_type, block_size))
        return padded_shape(m, n, device_type, block_size)

    padded_shape = pipeline.padded_shape
    monkeypatch.setattr(pipeline, "padded_shape", spy)
    g, pos = _data(rng, 0.0)
    cfg = LDConfig(ld_wind=5000, maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3,
                   block_size=32)
    out = pipeline.compute_ld_scores(g, pos, cfg, device="cpu")
    assert calls == [(g.shape[0], g.shape[1], "cpu", 32)]
    assert out["l2"].shape == (g.shape[0],)


def test_packed_input_matches_codes(rng, tmp_path):
    g, _ = _data(rng, 0.03, n=301)
    bp = make_positions(g.shape[0], spacing=700).astype(np.int64)
    ds = PlinkDataset.parse(write_plink(tmp_path / "p", g, bp=bp))
    cfg = LDConfig(ld_wind=5000, maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3,
                   block_size=32)
    packed = pipeline.compute_ld_scores(ds.bed.read_raw(), ds.positions("bp"),
                                        cfg, device="cpu")
    codes = pipeline.compute_ld_scores(g, ds.positions("bp"), cfg,
                                       device="cpu")
    for k in packed:
        np.testing.assert_array_equal(packed[k], codes[k], err_msg=k)


@pytest.mark.parametrize("block_size", [8, 32])
def test_golden_fixture(block_size):
    gold = dict(np.load(GOLDEN))
    cfg = LDConfig(ld_wind=WIND, wind_metric="bp", maf_thr=MAF, std_thr=STD,
                   rsq_thr=RSQ, block_size=block_size)
    res = pipeline.compute_ld_scores(gold["genotypes"], gold["positions"],
                                     cfg, device="cpu")
    check(res, gold)


def _read_l2(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    cols = list(zip(*rows))
    return {h: np.array([float(v) if v else np.nan for v in c])
            for h, c in zip(header, cols) if h not in ("SNP",)}


@pytest.mark.parametrize("extra", [False, True])
def test_cli_end_to_end_matches_jax(rng, tmp_path, extra):
    g = random_genotypes(rng, 300, 203, missing_rate=0.02)
    bp = make_positions(300, spacing=600, jitter_rng=rng).astype(np.int64)
    prefix = write_plink(tmp_path / "chr22", g, bp=bp)
    ours, theirs = str(tmp_path / "ours.L2"), str(tmp_path / "theirs.L2")
    argv = ["ld", "--bfile", prefix, "-kb", "5", "-maf", "0.01", "-o", ours,
            "--device", "cpu", "--block-size", "64"]
    cli.main(argv + (["--extra"] if extra else []))
    jax_pipeline.estimate_lds(prefix, ld_wind=5, wind_metric="kbp",
                              maf_thr=0.01, std_thr=1e-4, out=theirs,
                              extra=extra, block_size=64,
                              split_missing=False)
    a, b = _read_l2(ours), _read_l2(theirs)
    assert list(a) == list(b)
    for k in ("CHR", "BP", "WSA", "WSD", "WSDE"):
        if k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("L2", "L2D", "MAF", "RSTD"):
        if k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                       equal_nan=True, err_msg=k)
    for suffix in (".M", ".M_5_50"):
        with open(ours[:-3] + suffix, "rb") as fa, \
                open(theirs[:-3] + suffix, "rb") as fb:
            assert fa.read() == fb.read()


def test_cuda_without_gpu_raises(rng, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NLDSCParameterError, match="--device cpu"):
        pipeline.resolve_device("cuda")
    g, pos = _data(rng, 0.0, m=100, n=30)
    with pytest.raises(NLDSCParameterError):
        pipeline.compute_ld_scores(g, pos, LDConfig(ld_wind=5000,
                                                    rsq_thr=1e-3))
    prefix = write_plink(tmp_path / "t", g)
    with pytest.raises(SystemExit) as ex:
        cli.main(["ld", "--bfile", prefix, "-kb", "5", "-o",
                  str(tmp_path / "t.L2")])
    assert ex.value.code == 1
    assert not os.path.exists(tmp_path / "t.L2")


@pytest.mark.parametrize("argv, item", [
    (["--shard-axis", "grid"], "item 10"),
    (["--n-devices", "2"], "item 10"),
])
def test_unported_flags_name_their_roadmap_item(tmp_path, caplog, argv, item):
    # the flags of ROADMAP item 10 (multi-GPU) were refused naming it until
    # the item was ported: they now run, and route as the reference does
    # (one CPU device by default: --shard-axis grid alone stays on one
    # device; --n-devices 2 shards the SNP axis over two CPU shards)
    g = random_genotypes(np.random.default_rng(0), 200, 60, missing_rate=0.0)
    prefix = write_plink(tmp_path / "t", g, bp=np.arange(1, 201) * 500)
    base = ["ld", "--bfile", prefix, "-kb", "5", "-maf", "0.01", "--extra",
            "--device", "cpu", "--block-size", "32"]
    cli.main(base + ["-o", str(tmp_path / "one.L2")])
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level("INFO", logger=log.name):
            cli.main(base + argv + ["-o", str(tmp_path / "flag.L2")])
    finally:
        log.removeHandler(caplog.handler)
    sharded = "--n-devices" in argv
    assert ("2 cpu devices (SNP axis)" in caplog.text) == sharded, item
    a, b = _read_l2(tmp_path / "flag.L2"), _read_l2(tmp_path / "one.L2")
    for k in ("WSA", "WSD", "WSDE"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("L2", "L2D"):          # printed to 5 decimals
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("flags", [
    ["--dot-dtype", "bf16"],
    ["--dot-dtype", "bf16", "--no-symmetric"],
    ["--dot-dtype", "bf16", "--streaming", "--chunk-rows", "64"],
    ["--engine", "f32"],
    ["--engine", "f32", "--no-symmetric"],
], ids=["bf16", "bf16-full-band", "bf16-streamed", "f32", "f32-full-band"])
def test_cli_engine_flags_against_the_int8_run(rng, tmp_path, flags):
    # bf16 operands give the int8 run's .L2 byte for byte; the f32 engine
    # its scores within the golden tolerances and its window counts
    g = random_genotypes(rng, 200, 150, missing_rate=0.0)
    bp = make_positions(200, spacing=600, jitter_rng=rng).astype(np.int64)
    prefix = write_plink(tmp_path / "c", g, bp=bp)
    argv = ["ld", "--bfile", prefix, "-kb", "5", "-maf", "0.01", "--extra",
            "--device", "cpu", "--block-size", "32"]
    stream = flags[flags.index("--streaming"):] if "--streaming" in flags \
        else []
    cli.main(argv + stream + ["-o", str(tmp_path / "int8.L2")])
    cli.main(argv + flags + ["-o", str(tmp_path / "flag.L2")])
    ours = (tmp_path / "flag.L2").read_bytes()
    if "bf16" in flags:
        assert ours == (tmp_path / "int8.L2").read_bytes()
        return
    a, b = _read_l2(tmp_path / "flag.L2"), _read_l2(tmp_path / "int8.L2")
    for k in ("L2", "L2D"):
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)
    for k in ("WSA", "WSD"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("command, argv, item", [
    ("ld-genome", ["--n-devices", "2"], "item 10"),
], ids=["ld-genome"])
def test_unported_commands_raise(tmp_path, command, argv, item):
    # ld-genome refused the multi-device flags (ROADMAP item 10) until the
    # item was ported; it now runs each chromosome on the shards, and
    # still refuses a glob that matches no bfile before it makes --out-dir
    g = random_genotypes(np.random.default_rng(1), 150, 60, missing_rate=0.0)
    write_plink(tmp_path / "c1", g, bp=np.arange(1, 151) * 500)
    args = ["--out-dir", str(tmp_path / "out"), "-kb", "5", "-maf", "0.01",
            "--device", "cpu", *argv]
    cli.main([command, "--bfiles", str(tmp_path / "c*.bed"), *args])
    cli.main(["ld", "--bfile", str(tmp_path / "c1"), *args[2:],
              "-o", str(tmp_path / "ld.L2")])
    assert (tmp_path / "out" / "c1.L2").read_bytes() == \
        (tmp_path / "ld.L2").read_bytes(), item
    with pytest.raises(SystemExit) as ex:
        cli.main([command, "--bfiles", str(tmp_path / "none*.bed"),
                  "--out-dir", str(tmp_path / "out2"), *args[2:]])
    assert "No bfiles match" in str(ex.value.__cause__)
    assert not (tmp_path / "out2").exists()


@pytest.mark.parametrize("command", ["h2", "convert"])
def test_ported_commands_run_on_cpu(rng, tmp_path, command):
    g = random_genotypes(rng, 400, 120, missing_rate=0.0)
    prefix = write_plink(tmp_path / "c", g)
    l2 = str(tmp_path / "c.L2")
    cli.main(["ld", "--bfile", prefix, "-kb", "5", "-maf", "0.01", "-o", l2,
              "--device", "cpu"])
    if command == "convert":
        cli.main(["convert", "--to-ldsc", str(tmp_path / "x"), "-i", l2])
        assert (tmp_path / "x.l2.ldscore.gz").stat().st_size > 0
        assert (tmp_path / "x.d.l2.M_5_50").read_text().strip().isdigit()
        return
    snp = [line.split("\t")[1] for line in open(l2).readlines()[1:]]
    (tmp_path / "t.sumstats").write_text("SNP Z N\n" + "".join(
        f"{s} {z!r} 1000\n" for s, z in zip(snp, rng.normal(size=len(snp)).tolist())))
    out = tmp_path / "h2.json"
    cli.main(["h2", "--sumstats", str(tmp_path / "t.sumstats"), "--ref-ld",
              l2, "--w-ld", l2, "--n-blocks", "20", "--device", "cpu",
              "-s", str(out)])
    summary = json.loads(out.read_text())
    assert np.isfinite(summary["additive"]["hsq"])
    assert np.isfinite(summary["dominant"]["hsq.std"])


def test_port_never_imports_jax():
    code = ("import sys, nldsc_tpu_torch, nldsc_tpu_torch.cli, "
            "nldsc_tpu_torch.ld.pipeline, nldsc_tpu_torch.ld.convert, "
            "nldsc_tpu_torch.ld.streaming, nldsc_tpu_torch.compat, "
            "nldsc_tpu_torch.h2.pipeline, nldsc_tpu_torch.io.sumstats, "
            "nldsc_tpu_torch.io.convert, nldsc_tpu_torch.routines; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'nldsc_tpu', 'pandas', 'click')]; "
            "print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_package_data_covers_every_kernel_include():
    """An installed port must carry every file its kernels include."""
    import fnmatch
    import glob
    import re
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "nldsc_tpu_torch"]
    pkg = os.path.join(ROOT, "nldsc_tpu_torch")
    sources = glob.glob(os.path.join(pkg, "csrc", "*.cu"))
    assert sources
    for src in sources:
        rel = os.path.relpath(src, pkg)
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
        for inc in re.findall(r'#include\s+"([^"]+)"', open(src).read()):
            path = os.path.relpath(os.path.normpath(
                os.path.join(os.path.dirname(src), inc)), pkg)
            assert os.path.exists(os.path.join(pkg, path)), path
            assert any(fnmatch.fnmatch(path, g) for g in globs), path


def test_show_summary(rng, capsys):
    g, pos = _data(rng, 0.0)
    res = pipeline.compute_ld_scores(
        g, pos, LDConfig(ld_wind=5000, maf_thr=0.01, rsq_thr=1e-3,
                         block_size=32), device="cpu")
    text = pipeline.show_summary(res)
    assert "Correlation matrix" in text
    assert f"non-null LD: {int((~np.isnan(res['l2'])).sum())}" in text
