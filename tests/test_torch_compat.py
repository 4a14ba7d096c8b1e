"""The port's drop-in low-level API (``nldsc_tpu_torch.compat``) against
the JAX package's (``nldsc_tpu.compat``) and the float64 oracle, on the
CPU; mirrors ``tests/test_compat.py``.

Tolerances: scores within the golden tolerances (rtol 2e-5, atol 2e-4)
of the oracle and of the JAX package, counters equal to the oracle's and
to the JAX package's under ``contract.assert_counters_match``; the
streamed route within rtol 1e-6 of the in-core one on the integer
engine, and the f32 engine's full band within the golden tolerances of
its in-core symmetric run.
"""

import dataclasses
import inspect
import subprocess
import sys

import numpy as np
import pytest
import torch

from nldsc_tpu import compat as jax_compat
from nldsc_tpu.ld.oracle import oracle_ld
from nldsc_tpu_torch import compat
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.errors import NLDSCParameterError
from nldsc_tpu_torch.io.plink import write_plink
from nldsc_tpu_torch.ld import pipeline, streaming

from contract import assert_counters_equal, assert_counters_match, f32_tol
from test_torch_pipeline import ROOT
from utils import make_positions, random_genotypes

GOLDEN_TOL = dict(rtol=2e-5, atol=2e-4, equal_nan=True)


def _params(tmp_path, rng, m, n, spacing, wind, missing_rate=0.03,
            name="compat"):
    g = random_genotypes(rng, m, n, missing_rate=missing_rate)
    bp = make_positions(m, spacing=spacing)
    prefix = write_plink(tmp_path / name, g, bp=bp.astype(np.int64))
    kw = dict(bfile=prefix + ".bed", n_snp=m, n_org=n, ld_wind=wind,
              maf=0.01, std_thr=1e-4, rsq_thr=1e-3, positions=list(bp))
    return g, bp, kw


def _arrays(res) -> dict:
    return {f.name: np.asarray(getattr(res, f.name))
            for f in dataclasses.fields(res)}


def test_calculate_matches_oracle_and_jax(tmp_path, rng):
    m, n = 120, 150
    g, bp, kw = _params(tmp_path, rng, m, n, 600, 5000.0)
    res = compat.calculate(compat.LDScoreParams(**kw), block_size=16,
                           device="cpu")
    assert isinstance(res, compat.LDScoreResult)
    assert len(res.l2) == m and len(res.l2d_wse) == m
    ours = _arrays(res)
    ora = oracle_ld(g, bp, 5000.0, 0.01, 1e-4, 1e-3)
    np.testing.assert_allclose(ours["l2"], ora["l2"], **GOLDEN_TOL)
    np.testing.assert_array_equal(ours["l2_ws"], ora["l2_ws"])
    theirs = _arrays(jax_compat.calculate(jax_compat.LDScoreParams(**kw),
                                          block_size=16))
    for k in ("l2", "l2d", "maf"):
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k,
                                   **GOLDEN_TOL)
    assert_counters_equal(ours, theirs)


def test_positions_sentinel_via_compat(tmp_path, rng):
    m, n = 48, 60
    _, _, kw = _params(tmp_path, rng, m, n, 1000, 3000.0, missing_rate=0.0,
                       name="sent")
    kw["positions"][5] = -1.0                      # reference sentinel
    res = compat.calculate(compat.LDScoreParams(**kw), block_size=16,
                           device="cpu")
    assert np.isnan(res.l2[5]) and np.isnan(res.maf[5])
    assert res.l2_ws[5] == -1
    theirs = jax_compat.calculate(jax_compat.LDScoreParams(**kw),
                                  block_size=16)
    np.testing.assert_array_equal(res.l2_ws, theirs.l2_ws)


@pytest.mark.parametrize("use_int8", [True, False], ids=["int8", "f32"])
def test_calculate_streams_when_the_rule_says_so(tmp_path, rng, monkeypatch,
                                                 use_int8):
    m, n = 96, 70
    g, bp, kw = _params(tmp_path, rng, m, n, 700, 4000.0, missing_rate=0.02,
                        name="big")
    params = compat.LDScoreParams(**kw)
    dense = compat.calculate(params, block_size=16, use_int8=use_int8,
                             device="cpu")
    called = []
    orig = streaming.compute_ld_scores_streaming

    def spy(*a, **k):
        called.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(streaming, "compute_ld_scores_streaming", spy)
    # the CPU rule of the reference: 3 (integer) or 8 (f32) bytes per
    # padded genotype above the threshold
    monkeypatch.setattr(pipeline, "STREAMING_BYTES_THRESHOLD", 1)
    streamed = compat.calculate(params, block_size=16, use_int8=use_int8,
                                device="cpu")
    assert len(called) == 1 and called[0].use_int8 is use_int8
    ours, ref = _arrays(streamed), _arrays(dense)
    cfg = LDConfig(ld_wind=4000.0, maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3)
    if use_int8:
        np.testing.assert_allclose(ours["l2"], ref["l2"], rtol=1e-6,
                                   atol=1e-6, equal_nan=True)
        np.testing.assert_array_equal(ours["l2d_wse"], ref["l2d_wse"])
    else:
        # streamed: the f32 full band; in core: the f32 symmetric engine
        for k in ("l2", "l2d"):
            np.testing.assert_allclose(ours[k], ref[k], err_msg=k,
                                       **GOLDEN_TOL)
    if use_int8:
        assert_counters_equal(ours, ref)
    else:
        assert assert_counters_match(ours, ref, g, bp, cfg,
                                     f32_tol(128, n, 1e-3)) <= 3


def test_calculate_defaults_to_cuda(tmp_path, rng, monkeypatch):
    _, _, kw = _params(tmp_path, rng, 32, 40, 1000, 3000.0)
    assert inspect.signature(compat.calculate).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NLDSCParameterError, match="no CUDA device"):
        compat.calculate(compat.LDScoreParams(**kw))


@pytest.mark.parametrize("name", ["LDScoreParams", "LDScoreResult"])
def test_fields_are_the_reference_fields(name):
    ours, theirs = getattr(compat, name)(), getattr(jax_compat, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ([f.name for f in dataclasses.fields(ours)]
            == [f.name for f in dataclasses.fields(theirs)])


def test_compat_imports_no_jax():
    code = ("import sys, nldsc_tpu_torch.compat; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'nldsc_tpu', 'pandas', 'click')]; "
            "print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
