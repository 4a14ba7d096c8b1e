"""The port's float64 ``h2`` (regression, jackknife, pipeline, CLI) against
the JAX package's default float64 CPU path, on the same files and arrays.

Every summary field must agree within rtol 1e-8, atol 1e-12: the port
solves by Householder QR where the JAX package uses an SVD ``lstsq``, and
sums the jackknife blocks in another order, so the two differ in the last
digits only.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from nldsc_tpu.config import H2Config as JaxH2Config
from nldsc_tpu.h2 import jackknife as jax_jk
from nldsc_tpu.h2 import pipeline as jax_pipeline
from nldsc_tpu.h2 import regression as jax_regression
from nldsc_tpu.io import ldscores as jax_ldscores
from nldsc_tpu.io import sumstats as jax_sumstats
from nldsc_tpu.io.plink import write_plink as jax_write_plink
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.config import H2Config
from nldsc_tpu_torch.h2 import jackknife as jk
from nldsc_tpu_torch.h2 import pipeline, regression
from nldsc_tpu_torch.io import ldscores, sumstats
from nldsc_tpu_torch.io.plink import Table
from nldsc_tpu_torch.ld.pipeline import estimate_lds

from utils import make_positions, random_genotypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-8, atol=1e-12)


def assert_summaries_close(ours, theirs, where=""):
    assert set(ours) == set(theirs), where
    for key, want in theirs.items():
        got = ours[key]
        if isinstance(want, dict):
            assert_summaries_close(got, want, f"{where}.{key}")
        elif isinstance(want, (bool, str)):
            assert got == want, f"{where}.{key}"
        else:
            np.testing.assert_allclose(np.float64(got), np.float64(want),
                                       equal_nan=True, err_msg=f"{where}.{key}",
                                       **TOL)


# ---------------------------------------------------------------- data


def _ld_frame(rng, chrom, m):
    bp = np.sort(rng.integers(1, 60 * m, m))
    bp[20:24] = bp[20]                                   # BP ties
    l2 = rng.uniform(1, 30, m)
    df = pd.DataFrame({"CHR": chrom, "SNP": [f"rs{chrom}_{i}" for i in
                                             range(m)],
                       "BP": bp, "L2": l2,
                       "L2D": 0.15 * l2 + rng.uniform(0, 2, m)})
    df.loc[[7, 40], "L2"] = np.nan                       # NaN rows
    return df.sample(frac=1.0, random_state=int(rng.integers(1 << 30)))


def _write_l2(df, path, m, m_5_50):
    df.to_csv(path, sep="\t", index=False, float_format="%.5f")
    for suffix, (a, b) in ((".M", m), (".M_5_50", m_5_50)):
        pd.DataFrame({"M": [a], "MD": [b]}).to_csv(
            path.with_suffix(suffix), sep="\t", index=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An LD directory (two chromosomes), a separate weights file, two
    partitioned directories and shuffled sumstats with SNPs missing on
    either side, NA fields and a duplicate."""
    rng = np.random.default_rng(4242)
    tmp = tmp_path_factory.mktemp("h2files")
    ld_dir = tmp / "ld"
    ld_dir.mkdir()
    frames = []
    for chrom, m in ((21, 1300), (22, 1700)):
        df = _ld_frame(rng, chrom, m)
        _write_l2(df, ld_dir / f"chr{chrom}.L2", (m, m // 2),
                  (m - 100, m // 2 - 60))
        frames.append(df)
    ld = pd.concat(frames).dropna()
    M, MD = 2600.0, 1300.0
    n = len(ld)
    N = 3000.0 + rng.integers(-200, 200, n)
    expect = 1.0 + N * (0.35 * ld["L2"].to_numpy() / M
                        + 0.05 * ld["L2D"].to_numpy() / MD)
    z = rng.normal(size=n) * np.sqrt(expect)
    ss = pd.DataFrame({"SNP": ld["SNP"].to_numpy(), "Z": z, "N": N})
    ss = ss.iloc[rng.permutation(n)[: n - 150]]                # LD-only SNPs
    extra = pd.DataFrame({"SNP": [f"rsX_{i}" for i in range(120)],
                          "Z": rng.normal(size=120), "N": 3000.0})
    ss = pd.concat([ss, extra, ss.iloc[:3]]).sample(
        frac=1.0, random_state=5)                               # duplicates
    ss["P"] = 0.5
    text = ss.to_csv(sep="\t", index=False).splitlines()
    text[5] = text[5].split("\t")[0] + "\t.\t3000.0\t0.5"       # NA Z
    (tmp / "trait.sumstats").write_text("\n".join(text) + "\n")

    w = ld[["CHR", "SNP", "BP"]].copy()
    w["L2"] = ld["L2"].to_numpy() * rng.uniform(0.7, 1.3, n)
    w["L2D"] = ld["L2D"].to_numpy() * rng.uniform(0.7, 1.3, n) + 0.1
    _write_l2(w.iloc[rng.permutation(n)[: n - 80]], tmp / "w.L2",
              (n, n // 2), (n, n // 2))

    for n_annot in (2, 3):
        for headerless in (False, True):
            d = tmp / f"part{n_annot}{'h' if headerless else ''}"
            d.mkdir()
            names = ["A.L2", "B.L2", "C.L2"][:n_annot]
            for df in frames:
                chrom = int(df["CHR"].iloc[0])
                part = df[["CHR", "SNP", "BP"]].copy()
                share = rng.dirichlet(np.ones(n_annot), len(df))
                for k, nm in enumerate(names):
                    part[nm] = df["L2"].to_numpy() * share[:, k]
                part.to_csv(d / f"chr{chrom}.L2", sep="\t", index=False,
                            float_format="%.5f")
                counts = rng.integers(200, 800, n_annot)
                with open(d / f"chr{chrom}.M_5_50", "w") as f:
                    if not headerless:
                        f.write("\t".join(names) + "\n")
                    f.write("\t".join(map(str, counts)) + "\n")
    return {"ld": str(ld_dir), "w": str(tmp / "w.L2"),
            "ss": str(tmp / "trait.sumstats"), "tmp": tmp}


# ------------------------------------------------- pipeline and CLI parity


H2_MODES = {
    "two_step_default": ([], {}),
    "two_step_cutoff": (["--two-step", "12"], {"two_step": 12.0}),
    "constrained": (["--intercept-h2", "1.0"], {"intercept_h2": 1.0}),
    "one_stg": (["--strategy", "one-stg"], {"strategy": "one-stg"}),
    "separate_w_ld": ([], {}),
    "use_m": (["--use-M"], {"use_m": True}),
    "liability": (["--samp-prev", "0.4", "--pop-prev", "0.05"],
                  {"samp_prev": 0.4, "pop_prev": 0.05}),
}


@pytest.mark.parametrize("mode", list(H2_MODES))
def test_h2_cli_matches_jax(files, tmp_path, mode):
    argv, kw = H2_MODES[mode]
    w_ld = files["w"] if mode == "separate_w_ld" else files["ld"]
    out = tmp_path / "ours.json"
    cli.main(["h2", "--sumstats", files["ss"], "--ref-ld", files["ld"],
              "--w-ld", w_ld, "--n-blocks", "60", "--device", "cpu",
              "-s", str(out), *argv])
    ours = json.loads(out.read_text())
    theirs = jax_pipeline.estimate_h2(
        files["ss"], files["ld"], n_blocks=60,
        w_ldscore=w_ld if w_ld != files["ld"] else None, **kw)
    assert_summaries_close(ours, theirs)


def _frames(files, pandas: bool):
    if pandas:
        ss = jax_sumstats.read_sumstats(files["ss"])
        ld, M, MD = jax_ldscores.read_ld_scores(files["ld"])
        return ss, ld, M, MD
    ss = sumstats.read_sumstats(files["ss"])
    ld, M, MD = ldscores.read_ld_scores(files["ld"])
    return ss, ld, M, MD


def test_slow_jackknife_matches_jax(files):
    kw = dict(n_blocks=40, chisq_max=80.0, two_step=30.0,
              slow_jackknife=True)
    ours = pipeline.estimate_h2_frames(*_frames(files, False),
                                       H2Config(device="cpu", **kw))
    theirs = jax_pipeline.estimate_h2_frames(*_frames(files, True),
                                             JaxH2Config(**kw))
    assert_summaries_close(ours["summary"], theirs["summary"])
    fast = pipeline.estimate_h2_frames(
        *_frames(files, False),
        H2Config(device="cpu", **{**kw, "slow_jackknife": False}))
    for part in ("additive", "dominant"):
        for key in ("hsq", "hsq.std", "intercept"):
            np.testing.assert_allclose(ours["summary"][part][key],
                                       fast["summary"][part][key],
                                       rtol=1e-8, err_msg=f"{part}.{key}")


def test_row_selection_and_order_match_jax(files):
    ss, ld, _, _ = _frames(files, False)
    jss, jld, _, _ = _frames(files, True)
    ours, chisq = pipeline.drop_large_chisq(
        pipeline.merge_ld_sumstats(ss, ld), 20.0)
    merged = jax_pipeline.merge_ld_sumstats(jss, jld)
    jchisq = merged["Z"].to_numpy() ** 2
    assert list(ours["SNP"]) == list(merged["SNP"][jchisq < 20.0])
    # pandas' C float parser is not correctly rounded (a few ulps of Z)
    np.testing.assert_allclose(chisq, jchisq[jchisq < 20.0], rtol=1e-12)
    assert len(ours) < len(merged)
    # the jackknife separators of both stages follow that order
    cfg = dict(n_blocks=50, chisq_max=80.0, two_step=30.0)
    res = pipeline.estimate_h2_frames(ss, ld, 2600, 1300,
                                      H2Config(device="cpu", **cfg))
    jres = jax_pipeline.estimate_h2_frames(jss, jld, 2600, 1300,
                                           JaxH2Config(**cfg))
    for part in ("additive", "dominant"):
        np.testing.assert_array_equal(res[part].jknife.separators,
                                      jres[part].jknife.separators)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def test_hsq_result_tensors_are_float64(files):
    res = pipeline.estimate_h2_frames(
        *_frames(files, False),
        H2Config(n_blocks=30, chisq_max=80.0, two_step=30.0, device="cpu"))
    found = [t for part in ("additive", "dominant")
             for t in _tensors(res[part])]
    assert len(found) > 20
    assert all(t.dtype == torch.float64 for t in found)


@pytest.mark.parametrize("n_annot, headerless",
                         [(2, False), (2, True), (3, False), (3, True)])
def test_partitioned_cli_matches_jax(files, tmp_path, n_annot, headerless):
    ref = str(files["tmp"] / f"part{n_annot}{'h' if headerless else ''}")
    out = tmp_path / "ours.json"
    cli.main(["h2", "--partitioned", "--sumstats", files["ss"], "--ref-ld",
              ref, "--w-ld", files["ld"], "--n-blocks", "40", "--device",
              "cpu", "-s", str(out)])
    theirs = jax_pipeline.estimate_h2_partitioned(
        files["ss"], ref, files["ld"], n_blocks=40)
    assert_summaries_close(json.loads(out.read_text()), theirs)


def test_partitioned_weights_from_ref_ld_match_jax(files):
    ref = str(files["tmp"] / "part3")
    ours = pipeline.estimate_h2_partitioned(files["ss"], ref, ref,
                                            n_blocks=30, intercept_h2=1.0,
                                            device="cpu")
    theirs = jax_pipeline.estimate_h2_partitioned(files["ss"], ref, ref,
                                                  n_blocks=30,
                                                  intercept_h2=1.0)
    assert_summaries_close(ours, theirs)


def test_json_round_trip_and_no_overwrite(files, tmp_path):
    out = tmp_path / "h2.json"
    summary = pipeline.estimate_h2(files["ss"], files["ld"], n_blocks=20,
                                   save_to_json=str(out), device="cpu")
    assert json.loads(out.read_text()) == summary
    before = out.read_bytes()
    with pytest.raises(FileExistsError):
        pipeline.attempt_save(str(out), {"x": 1.0})
    assert out.read_bytes() == before
    with pytest.raises(SystemExit) as ex:
        cli.main(["h2", "--sumstats", files["ss"], "--ref-ld", files["ld"],
                  "--w-ld", files["ld"], "--device", "cpu", "-s", str(out)])
    assert ex.value.code == 1
    assert isinstance(ex.value.__cause__, FileExistsError)


# ------------------------------------------------------ regression pieces


def _synth(rng, m, n_gwas=20000.0, h2_add=0.3, h2_dom=0.05):
    ld = rng.uniform(1.0, 40.0, size=(m, 1))
    ldd = np.abs(0.25 * ld + rng.normal(0, 2, size=(m, 1)))
    M, MD = float(m), float(m // 2)
    chisq = ((1.0 + n_gwas * (h2_add * ld / M + h2_dom * ldd / MD))
             * rng.chisquare(1, size=(m, 1))).clip(1e-8)
    N = (n_gwas + rng.integers(-500, 500, size=(m, 1))).astype(np.float64)
    return chisq, ld, ldd, N, np.array([[M]]), np.array([[MD]])


def test_lambda_gc_even_row_count_matches_jax(rng):
    chisq, ld, ldd, N, M, MD = _synth(rng, 4000)
    y = torch.as_tensor(chisq)
    assert float(regression.median(y)) == float(np.median(chisq))
    assert float(torch.median(y)) != float(np.median(chisq))   # the trap
    ours = regression.hsq_estimate(chisq, ld, ld, ldd, ldd, N, M, MD,
                                   n_blocks=80, two_step=30)["summary"]
    with jax.enable_x64(True):
        theirs = jax_regression.hsq_estimate(
            chisq, ld, ld, ldd, ldd, N, M, MD, n_blocks=80,
            two_step=30)["summary"]
    assert_summaries_close(ours, theirs)
    assert ours["additive"]["lambda_gc"] == theirs["additive"]["lambda_gc"]


def test_fast_jackknife_matches_slow_and_jax(rng):
    n, p = 5000, 2
    x = np.column_stack([rng.uniform(1, 50, n), np.ones(n)])
    y = (x @ np.array([0.003, 1.1]) + rng.normal(0, 0.6, n)).reshape(n, 1)
    fast = jk.lstsq_jackknife_fast(torch.as_tensor(x), torch.as_tensor(y),
                                   n_blocks=47)
    slow = jk.lstsq_jackknife_slow(torch.as_tensor(x), torch.as_tensor(y),
                                   n_blocks=47)
    np.testing.assert_allclose(fast.est, slow.est, rtol=1e-9)
    np.testing.assert_allclose(fast.delete_values, slow.delete_values,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(fast.jk_std, slow.jk_std, rtol=1e-6)
    with jax.enable_x64(True):
        jfast = jax_jk.lstsq_jackknife_fast(x, y, n_blocks=47)
        jslow = jax_jk.lstsq_jackknife_slow(x, y, n_blocks=47)
    for ours, theirs in ((fast, jfast), (slow, jslow)):
        for f in ("est", "delete_values", "jk_est", "jk_std", "jk_cov"):
            np.testing.assert_allclose(getattr(ours, f),
                                       np.asarray(getattr(theirs, f)),
                                       err_msg=f, **TOL)


def test_nnls_slow_jackknife_matches_jax():
    # a true coefficient below zero, so that the constraint is active in
    # the full fit and in the delete fits
    rng = np.random.default_rng(21)
    n, p = 600, 3
    x = np.column_stack([rng.uniform(1, 50, n), rng.normal(0, 1, n),
                         np.ones(n)])
    y = (x @ np.array([0.02, -0.4, 1.1])
         + rng.normal(0, 0.6, n)).reshape(n, 1)
    ours = jk.lstsq_jackknife_slow(torch.as_tensor(x), torch.as_tensor(y),
                                   n_blocks=20, nn=True)
    with jax.enable_x64(True):
        theirs = jax_jk.lstsq_jackknife_slow(x, y, n_blocks=20, nn=True)
    assert ours.est.dtype == torch.float64 and ours.est.shape == (1, p)
    assert ours.delete_values.shape == (20, p)
    assert (ours.est[0, 1] == 0) and (ours.delete_values[:, 1] == 0).all()
    for f in ("est", "delete_values", "jk_est", "jk_std", "jk_cov"):
        np.testing.assert_allclose(getattr(ours, f),
                                   np.asarray(getattr(theirs, f)),
                                   rtol=1e-12, atol=0, err_msg=f)
    # without the constraint the fit goes negative
    assert jk.lstsq_jackknife_slow(torch.as_tensor(x), torch.as_tensor(y),
                                   n_blocks=20).est[0, 1] < 0


def test_block_sums_equal_reduceat(rng):
    v = torch.as_tensor(rng.normal(size=(1003, 5)))
    seps = jk.get_separators(1003, 17)
    want = np.add.reduceat(v.numpy(), seps[:-1], axis=0)
    np.testing.assert_allclose(jk.block_sums(v, seps), want, rtol=1e-13)


def test_pseudovalues_separators_and_remap_match_jax(rng):
    d = rng.normal(size=(30, 2))
    est = rng.normal(size=(1, 2))
    pseudo = jk.delete_values_to_pseudovalues(torch.as_tensor(d),
                                              torch.as_tensor(est))
    np.testing.assert_allclose(pseudo, 30 * est - 29 * d, rtol=1e-15)
    for n, nb in ((100, 7), (4001, 200), (57, 57)):
        np.testing.assert_array_equal(jk.get_separators(n, nb),
                                      jax_jk.get_separators(n, nb))
        seps = jk.get_separators(n, nb)
        np.testing.assert_array_equal(jk.block_ids(seps, n),
                                      jax_jk.block_ids(seps, n))
    mask = rng.random(500) < 0.8
    seps = jk.get_separators(int(mask.sum()), 25)
    np.testing.assert_array_equal(
        regression._remap_separators(seps, mask),
        jax_regression._remap_separators(seps, mask))
    with pytest.raises(ValueError, match="More blocks"):
        jk.lstsq_jackknife_fast(torch.ones(5, 1), torch.ones(5, 1), 6)


def test_ratio_jackknife_matches_jax(rng):
    est = rng.uniform(0.1, 1, (1, 3))
    numer = rng.uniform(0.1, 1, (25, 3))
    denom = rng.uniform(1, 2, (25, 3))
    ours = jk.ratio_jackknife(*(torch.as_tensor(a) for a in
                                (est, numer, denom)))
    with jax.enable_x64(True):
        theirs = jax_jk.ratio_jackknife(est, numer, denom)
    for f in ("jk_est", "jk_var", "jk_std", "jk_cov", "delete_values"):
        np.testing.assert_allclose(getattr(ours, f),
                                   np.asarray(getattr(theirs, f)),
                                   err_msg=f, **TOL)


def test_separate_weights_and_constrained_regression_match_jax(rng):
    chisq, ld, ldd, N, M, MD = _synth(rng, 6000)
    w_add = ld * rng.uniform(0.5, 1.5, size=ld.shape)
    w_dom = ldd * rng.uniform(0.5, 1.5, size=ldd.shape) + 0.1
    for kw in ({"two_step": 30}, {"intercept_add": 1.0}, {}):
        ours = regression.hsq_estimate(chisq, ld, w_add, ldd, w_dom, N, M,
                                       MD, n_blocks=50, **kw)["summary"]
        with jax.enable_x64(True):
            theirs = jax_regression.hsq_estimate(
                chisq, ld, w_add, ldd, w_dom, N, M, MD, n_blocks=50,
                **kw)["summary"]
        assert_summaries_close(ours, theirs, str(kw))


def test_liability_conversion_matches_jax():
    for P, K in ((0.5, 0.01), (0.3, 0.2), (float("nan"), float("nan"))):
        assert (regression.h2_obs_to_liability(0.3, P, K)
                == jax_regression.h2_obs_to_liability(0.3, P, K))
    with pytest.raises(ValueError):
        regression.h2_obs_to_liability(0.3, 1.5, 0.01)


def test_degenerate_ukb_subset_is_finite():
    data = np.load(os.path.join(ROOT, "tests", "data",
                                "degenerate_ukb_subset.npz"))
    m = data["l2"].shape[0]
    snp = np.array([f"rs{i}" for i in range(m)], dtype=object)
    ss = Table(SNP=snp, Z=data["z"].astype(np.float64),
               N=np.full(m, float(data["n"])))
    ld = Table(SNP=snp, L2=data["l2"].astype(np.float64),
               L2D=data["l2d"].astype(np.float64))
    summary = pipeline.estimate_h2_frames(
        ss, ld, m, m, H2Config(n_blocks=200, two_step=30.0, device="cpu"))
    assert np.isfinite(summary["summary"]["additive"]["hsq"])
    assert np.isfinite(summary["summary"]["additive"]["hsq.std"])


def test_h2_config_validation():
    from nldsc_tpu_torch.core.errors import NLDSCParameterError

    for kw in ({"strategy": "bogus"}, {"n_blocks": 1}, {"device": "tpu"}):
        with pytest.raises(NLDSCParameterError):
            H2Config(**kw)


# ------------------------------------------------------ end to end, CLI


def test_signal_recovery_through_port_ld_and_h2(tmp_path):
    rng = np.random.default_rng(20260817)
    m, n = 1200, 600
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    bp = make_positions(m, spacing=500)
    prefix = jax_write_plink(tmp_path / "sig", g, bp=bp.astype(np.int64))
    out = str(tmp_path / "sig.L2")
    estimate_lds(prefix, ld_wind=20, wind_metric="kbp", maf_thr=0.01,
                 std_thr=1e-4, out=out, extra=True, block_size=64,
                 device="cpu")

    gf = g.astype(np.float64)
    x = (gf - gf.mean(1, keepdims=True)) / gf.std(1, keepdims=True)
    betas = rng.normal(0, np.sqrt(0.5 / m), size=m)
    genetic = betas @ x
    pheno = genetic + rng.normal(0, np.sqrt(1 - genetic.var()), size=n)
    pheno = (pheno - pheno.mean()) / pheno.std()
    z = (x @ pheno / n) * np.sqrt(60_000.0)
    snp = pd.read_csv(out, sep="\t")["SNP"]
    ss_path = str(tmp_path / "sig.sumstats")
    pd.DataFrame({"SNP": snp, "Z": z, "N": 60_000.0}).to_csv(
        ss_path, sep="\t", index=False)

    summary = pipeline.estimate_h2(ss_path, out, n_blocks=40, device="cpu")
    assert summary["additive"]["hsq"] > 0.1, summary
    assert summary["additive"]["intercept"] > 0.5
    assert_summaries_close(summary,
                           jax_pipeline.estimate_h2(ss_path, out,
                                                    n_blocks=40))


def test_h2_cuda_without_gpu_exits_cleanly(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "nldsc_tpu_torch", "h2", "--sumstats",
         files["ss"], "--ref-ld", files["ld"], "--w-ld", files["ld"]],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "--device cpu" in proc.stderr + proc.stdout
    assert "Traceback" not in proc.stderr + proc.stdout
    with pytest.raises(SystemExit) as ex:
        cli.main(["h2", "--sumstats", files["ss"], "--ref-ld", files["ld"],
                  "--w-ld", files["ld"], "--on-device", "--device", "cpu"])
    assert ex.value.code == 1
