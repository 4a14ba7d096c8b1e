"""Host side of the PyTorch port against the JAX package: window
geometry, PLINK readers and the byte-exact .L2/.M writers."""

import os

import numpy as np
import pytest

from nldsc_tpu.io import ldscores as jax_ldscores
from nldsc_tpu.io import plink as jax_plink
from nldsc_tpu.ld import windows as jax_windows
from nldsc_tpu_torch.io import ldscores, plink
from nldsc_tpu_torch.ld import windows

from utils import make_positions, random_genotypes

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_chr22_toy.npz")


def _position_sets(rng):
    gold = np.load(GOLDEN)["positions"]
    jitter = make_positions(500, spacing=700, jitter_rng=rng,
                            skip_idx=(0, 3, 250, 499))
    return [(gold, 12000.0), (jitter, 5000.0), (jitter, 1.0),
            (make_positions(40, spacing=10), 1e6)]


@pytest.mark.parametrize("block_size", [8, 32, 64, 512])
def test_window_geometry_matches_jax(rng, block_size):
    for pos, wind in _position_sets(rng):
        lo, hi, ok = windows.window_bounds(pos, wind)
        jlo, jhi, jok = jax_windows.window_bounds(pos, wind)
        for a, b in ((lo, jlo), (hi, jhi), (ok, jok)):
            np.testing.assert_array_equal(a, b)
        nb = -(-len(pos) // block_size)
        blo, bhi, k = windows.band_blocks(lo, hi, block_size, nb)
        jblo, jbhi, jk = jax_windows.band_blocks(jlo, jhi, block_size, nb)
        np.testing.assert_array_equal(blo, jblo)
        np.testing.assert_array_equal(bhi, jbhi)
        assert k == jk
        assert (windows.right_band_blocks(bhi, block_size)
                == jax_windows.right_band_blocks(jbhi, block_size))


def _bfile(tmp_path, rng, m=37, n=23, missing_rate=0.05):
    g = random_genotypes(rng, m, n, missing_rate=missing_rate)
    bp = make_positions(m, spacing=900, jitter_rng=rng).astype(np.int64)
    prefix = jax_plink.write_plink(tmp_path / "toy", g, bp=bp)
    return prefix, g


def test_bim_fam_readers_match_pandas(tmp_path, rng):
    prefix, _ = _bfile(tmp_path, rng)
    for ours, theirs in ((plink.read_bim(prefix + ".bim"),
                          jax_plink.read_bim(prefix + ".bim")),
                         (plink.read_fam(prefix + ".fam"),
                          jax_plink.read_fam(prefix + ".fam"))):
        assert list(ours) == list(theirs.columns)
        for name in theirs.columns:
            col = theirs[name].to_numpy()
            if np.issubdtype(col.dtype, np.floating):
                # pandas' default C float parser is not correctly rounded;
                # ours (Python float) is: they differ near 1e-13 relative
                assert ours[name].dtype == col.dtype, name
                np.testing.assert_allclose(ours[name], col, rtol=1e-12,
                                           atol=0)
            elif np.issubdtype(col.dtype, np.number):
                assert ours[name].dtype == col.dtype, name
                np.testing.assert_array_equal(ours[name], col)
            else:
                assert list(ours[name]) == [str(v) for v in col], name


def test_write_plink_matches_jax(tmp_path, rng):
    g = random_genotypes(rng, 29, 31, missing_rate=0.1)
    bp = make_positions(29, spacing=500).astype(np.int64)
    a = plink.write_plink(tmp_path / "ours", g, bp=bp)
    b = jax_plink.write_plink(tmp_path / "theirs", g, bp=bp)
    for ext in (".bed", ".bim", ".fam"):
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


@pytest.mark.parametrize("missing_rate", [0.0, 0.05])
def test_read_raw_matches_jax(tmp_path, rng, missing_rate):
    prefix, _ = _bfile(tmp_path, rng, missing_rate=missing_rate)
    ds = plink.PlinkDataset.parse(prefix)
    jds = jax_plink.PlinkDataset.parse(prefix)
    ours, theirs = ds.bed.read_raw(), jds.bed.read_raw()
    np.testing.assert_array_equal(ours.raw, theirs.raw)
    assert ours.has_missing == theirs.has_missing == (missing_rate > 0)
    np.testing.assert_array_equal(ds.positions("bp"), jds.positions("bp"))
    np.testing.assert_allclose(ds.positions("cm"), jds.positions("cm"),
                               rtol=1e-12, atol=0)


def _result(rng, m):
    res = {
        "l2": rng.normal(2.0, 1.0, m), "l2d": rng.normal(0.0, 0.1, m),
        "maf": rng.uniform(0.0, 0.5, m),
        "residuals_std": rng.uniform(0.0, 0.5, m),
        "l2_ws": rng.integers(1, 60, m), "l2d_ws": rng.integers(0, 60, m),
        "l2d_wse": rng.integers(0, 30, m),
    }
    for k in ("l2", "l2d", "maf", "residuals_std"):
        res[k][rng.choice(m, 4, replace=False)] = np.nan
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        res[k][rng.choice(m, 3, replace=False)] = -1
    res["l2"][0] = -0.0
    res["l2d"][1] = 1e-9
    return res


@pytest.mark.parametrize("extra", [False, True])
def test_l2_and_m_files_byte_identical(tmp_path, rng, extra):
    prefix, _ = _bfile(tmp_path, rng)
    res = _result(rng, 37)
    ours, theirs = tmp_path / "ours.L2", tmp_path / "theirs.L2"
    ldscores.write_l2(ldscores.make_output(
        plink.read_bim(prefix + ".bim"), res, extra=extra), str(ours))
    jax_ldscores.write_l2(jax_ldscores.make_output(
        jax_plink.read_bim(prefix + ".bim"), res, extra=extra), str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    ldscores.write_m_files(res, str(ours))
    jax_ldscores.write_m_files(res, str(theirs))
    for suffix in (".M", ".M_5_50"):
        assert (ours.with_suffix(suffix).read_bytes()
                == theirs.with_suffix(suffix).read_bytes()), suffix
