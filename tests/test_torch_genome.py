"""The port's ``ld-genome`` command: its bfile list, its outputs against
the port's own ``ld`` and the JAX ``ld-genome``, and its streaming
checkpoints (on the CPU)."""

import os

import numpy as np
import pytest
from click.testing import CliRunner

from nldsc_tpu.cli import main as jax_cli
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.io.plink import write_plink

from test_ld_split import row_level_missing
from test_torch_pipeline import _read_l2
from utils import make_positions, random_genotypes

SIDECARS = (".L2", ".M", ".M_5_50")


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Three chromosomes: clean, split-route missing and global-route
    missing."""
    td = tmp_path_factory.mktemp("genome")
    rng = np.random.default_rng(61)
    n = 150
    for c, g in ((1, random_genotypes(rng, 240, n, missing_rate=0.0)),
                 (2, row_level_missing(rng, 300, n, row_frac=0.05,
                                       entry_rate=0.2)),
                 (3, random_genotypes(rng, 200, n, missing_rate=0.03))):
        bp = make_positions(g.shape[0], spacing=500, jitter_rng=rng)
        write_plink(td / f"chr{c:02d}", g, chrom=c, bp=bp.astype(np.int64))
    return td


def _genome(td, out_dir, *extra):
    cli.main(["ld-genome", "--bfiles", f"{td}/chr*.bed", "--out-dir",
              str(out_dir), "-kb", "10", "-maf", "0.01", "--extra",
              "--device", "cpu", *extra])


def test_bfile_lists(tmp_path):
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        for c in (1, 2):
            for suffix in (".bed", ".bim", ".fam"):
                (tmp_path / sub / f"chr{c}{suffix}").write_text("")
    a, b = tmp_path / "a", tmp_path / "b"
    assert cli.genome_prefixes(f"{a}/chr*.bed") == [f"{a}/chr1", f"{a}/chr2"]
    # every suffix of one bfile is the one prefix
    assert cli.genome_prefixes(f"{a}/chr1.*") == [f"{a}/chr1"]
    assert cli.genome_prefixes(f" {a}/chr2.bim, {a}/chr1 ,") == [
        f"{a}/chr1", f"{a}/chr2"]
    assert cli.genome_prefixes(f"{a}/chr1") == [f"{a}/chr1"]
    with pytest.raises(RuntimeError, match="identical basenames"):
        cli.genome_prefixes(f"{a}/chr1.bed,{b}/chr1.bed")
    with pytest.raises(RuntimeError, match="identical basenames"):
        cli.genome_prefixes(f"{tmp_path}/*/chr2.bed")
    with pytest.raises(RuntimeError, match="No bfiles match"):
        cli.genome_prefixes(f"{a}/chr9*.bed")


@pytest.mark.parametrize("bucket", [[], ["--bucket-shapes"],
                                    ["--no-bucket-shapes"]])
def test_outputs_equal_ld_byte_for_byte(genome, tmp_path, bucket):
    out_dir = tmp_path / "scores"
    _genome(genome, out_dir, *bucket)
    names = sorted(os.listdir(out_dir))
    assert names == sorted(f"chr{c:02d}{s}" for c in (1, 2, 3)
                           for s in SIDECARS)
    for c in (1, 2, 3):
        ld_out = tmp_path / f"ld{c}.L2"
        cli.main(["ld", "--bfile", str(genome / f"chr{c:02d}"), "-kb", "10",
                  "-maf", "0.01", "--extra", "--device", "cpu", "-o",
                  str(ld_out)])
        for s in SIDECARS:
            assert (out_dir / f"chr{c:02d}{s}").read_bytes() == \
                ld_out.with_suffix(s).read_bytes(), (c, s)


def test_matches_jax_ld_genome(genome, tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _genome(genome, ours)
    res = CliRunner().invoke(jax_cli, [
        "ld-genome", "--bfiles", f"{genome}/chr01.bed,{genome}/chr02.bed,"
        f"{genome}/chr03.bed", "--out-dir", str(theirs), "-kb", "10",
        "-maf", "0.01", "--extra", "--n-devices", "1", "--display"])
    assert res.exit_code == 0, res.output
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for c in (1, 2, 3):
        a = _read_l2(ours / f"chr{c:02d}.L2")
        b = _read_l2(theirs / f"chr{c:02d}.L2")
        assert list(a) == list(b)
        for k in ("CHR", "BP", "WSA", "WSD", "WSDE"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("L2", "L2D", "MAF", "RSTD"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                       equal_nan=True, err_msg=k)
        for s in (".M", ".M_5_50"):
            assert (ours / f"chr{c:02d}{s}").read_bytes() == \
                (theirs / f"chr{c:02d}{s}").read_bytes()


def test_resume_dir_per_chromosome(genome, tmp_path):
    out_dir, ck = tmp_path / "scores", tmp_path / "ck"
    _genome(genome, out_dir, "--streaming", "--chunk-rows", "128",
            "--resume-dir", str(ck))
    assert sorted(os.listdir(ck)) == ["chr01", "chr02", "chr03"]
    for c in (1, 2, 3):
        # 128 chunk rows round up to the 512-row block, as in nldsc_tpu
        files = sorted(os.listdir(ck / f"chr{c:02d}"))
        assert files == ["chunk_000000.npz", "meta.json", "rowmiss.npz"]
    # the streamed scores agree with the in-core ones
    incore = tmp_path / "incore"
    _genome(genome, incore, "--no-streaming")
    for c in (1, 2, 3):
        a = _read_l2(out_dir / f"chr{c:02d}.L2")
        b = _read_l2(incore / f"chr{c:02d}.L2")
        for k in ("WSA", "WSD", "WSDE"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("L2", "L2D"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                       equal_nan=True, err_msg=k)


def test_cuda_without_gpu_raises(genome, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as ex:
        cli.main(["ld-genome", "--bfiles", f"{genome}/chr01.bed",
                  "--out-dir", str(tmp_path / "o"), "-kb", "10"])
    assert ex.value.code == 1
    assert "--device cpu" in str(ex.value.__cause__)
    assert not list((tmp_path / "o").glob("*.L2"))
