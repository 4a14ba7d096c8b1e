"""The port's float64 ``h2`` on a CUDA device against the same code on the
CPU, and two CUDA runs against each other.

Needs a CUDA device (``gpu`` marker): every test skips without one.  The
file imports no JAX and no pandas, so on a machine with a card it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_h2_gpu.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nldsc_tpu_torch.config import H2Config
from nldsc_tpu_torch.h2 import pipeline
from nldsc_tpu_torch.io.ldscores import format_table, read_ld_scores
from nldsc_tpu_torch.io.plink import Table
from nldsc_tpu_torch.io.sumstats import read_sumstats

TOL = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture()
def files(tmp_path):
    """Two chromosome .L2 files with sidecars, a two-annotation copy, and
    shuffled sumstats simulated from the LD-score model."""
    rng = np.random.default_rng(77)
    ld_dir, part_dir = tmp_path / "ld", tmp_path / "part"
    ld_dir.mkdir()
    part_dir.mkdir()
    snps, l2s, l2ds = [], [], []
    for chrom, m in ((1, 2500), (2, 2000)):
        snp = np.array([f"rs{chrom}_{i}" for i in range(m)], dtype=object)
        bp = np.sort(rng.integers(1, 100 * m, m))
        l2 = rng.uniform(1, 30, m)
        l2d = 0.2 * l2 + rng.uniform(0, 2, m)
        chr_col = np.full(m, chrom)
        (ld_dir / f"chr{chrom}.L2").write_text(format_table(Table(
            CHR=chr_col, SNP=snp, BP=bp, L2=l2, L2D=l2d)))
        for suffix in (".M", ".M_5_50"):
            (ld_dir / f"chr{chrom}{suffix}").write_text(
                f"M\tMD\n{m}\t{m // 2}\n")
        a = rng.uniform(0, 1, m)
        (part_dir / f"chr{chrom}.L2").write_text(format_table(Table(
            CHR=chr_col, SNP=snp, BP=bp, **{"A.L2": a * l2,
                                             "B.L2": (1 - a) * l2})))
        (part_dir / f"chr{chrom}.M_5_50").write_text(
            f"A.L2\tB.L2\n{a.sum():.1f}\t{(1 - a).sum():.1f}\n")
        snps.append(snp)
        l2s.append(l2)
        l2ds.append(l2d)
    snp, l2, l2d = (np.concatenate(v) for v in (snps, l2s, l2ds))
    n = 4000.0
    z = rng.normal(size=len(snp)) * np.sqrt(
        1 + n * (0.3 * l2 / 4500 + 0.05 * l2d / 2250))
    order = rng.permutation(len(snp))[:-100]
    z = z.tolist()
    (tmp_path / "t.sumstats").write_text("SNP Z N\n" + "".join(
        f"{snp[i]} {z[i]!r} {n}\n" for i in order.tolist()))
    return {"ld": str(ld_dir), "part": str(part_dir),
            "ss": str(tmp_path / "t.sumstats"), "tmp": tmp_path}


def _close(ours, theirs):
    for key, want in theirs.items():
        if isinstance(want, dict):
            _close(ours[key], want)
        elif isinstance(want, (bool, str)):
            assert ours[key] == want, key
        else:
            np.testing.assert_allclose(ours[key], want, err_msg=key,
                                       equal_nan=True, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["two-stg", "one-stg"])
def test_h2_cuda_matches_cpu_and_is_deterministic(cuda, files, strategy):
    runs = [pipeline.estimate_h2(files["ss"], files["ld"], n_blocks=100,
                                 strategy=strategy, device=dev)
            for dev in ("cuda", "cuda", "cpu")]
    assert json.dumps(runs[0]) == json.dumps(runs[1])
    _close(runs[0], runs[2])


@pytest.mark.gpu
def test_h2_partitioned_cuda_matches_cpu(cuda, files):
    runs = [pipeline.estimate_h2_partitioned(files["ss"], files["part"],
                                             files["ld"], n_blocks=100,
                                             device=dev)
            for dev in ("cuda", "cuda", "cpu")]
    assert json.dumps(runs[0]) == json.dumps(runs[1])
    _close(runs[0], runs[2])


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


@pytest.mark.gpu
def test_every_cuda_tensor_is_float64_and_bitwise_repeatable(cuda, files):
    ss = read_sumstats(files["ss"])
    ld, M, MD = read_ld_scores(files["ld"])
    cfg = H2Config(n_blocks=100, chisq_max=80.0, two_step=30.0,
                   device="cuda")
    a, b = (pipeline.estimate_h2_frames(ss, ld, M, MD, cfg)
            for _ in range(2))
    for part in ("additive", "dominant"):
        ta, tb = list(_tensors(a[part])), list(_tensors(b[part]))
        assert ta and len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert x.device.type == "cuda" and x.dtype == torch.float64
            assert torch.equal(x, y)
