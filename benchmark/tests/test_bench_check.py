"""A run's ``correct``: true for the program on the CPU at a size a test
holds, false with the timed path broken underneath (the harness's look
for a card skipped, the rest of the run driven)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness

from .conftest import CELLS, tiny_cell


def run_cell(name: str, device="cpu", seed: int = 11) -> dict:
    bench, config, workload = tiny_cell(name)
    return harness.run(bench, name, config, workload, seed, 0.3, False,
                       device, 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    r = run_cell(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"ld_snps_per_s", "ld_peak_gib", "setup_s"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_on_the_card(name, cuda):
    r = run_cell(name, cuda)
    assert r["correct"], r["checks"]


def _stale(real):
    """A call that returns the state of another chromosome unchanged."""
    kept = {}

    def fake(packed, positions, config, **kw):
        if "out" not in kept:
            other = type(packed)(np.roll(packed.raw, 64, axis=0),
                                 packed.n_snp, packed.n_samples,
                                 packed.has_missing)
            kept["out"] = real(other, positions, config, **kw)
        return {k: v.copy() for k, v in kept["out"].items()}
    return fake


def _half(real):
    """Half of the samples left out, the statistics taken over the rest."""
    def fake(packed, positions, config, **kw):
        bps = packed.raw.shape[1] // 2
        half = type(packed)(np.ascontiguousarray(packed.raw[:, :bps]),
                            packed.n_snp, 4 * bps, packed.has_missing)
        return real(half, positions, config, **kw)
    return fake


def _altered(field, delta):
    """One answer altered where it is produced: row 0 (always checked), by
    ``delta`` (for l2, one perfectly linked pair counted once more)."""
    def wrap(real):
        def fake(*a, **kw):
            out = real(*a, **kw)
            out[field] = out[field].copy()
            out[field][0] += delta
            return out
        return fake
    return wrap


FAULTS = {"stale": _stale, "half_samples": _half,
          "l2_altered": _altered("l2", 1.0),
          "counter_altered": _altered("l2d_wse", 3)}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    from nldsc_tpu_torch.ld import pipeline

    monkeypatch.setattr(pipeline, "compute_ld_scores",
                        FAULTS[fault](pipeline.compute_ld_scores))
    r = run_cell(name)
    assert not r["correct"], r["checks"]


def test_a_call_that_raises_is_counted(monkeypatch):
    from nldsc_tpu_torch.ld import pipeline

    real, calls = pipeline.compute_ld_scores, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "compute_ld_scores", flaky)
    r = run_cell("ukb_hm3.split")
    assert r["failed"] == 1 and not r["correct"] and "planted" in r["error"]
