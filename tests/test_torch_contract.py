"""Tests of the counter contract of ``tests/contract.py`` (these import
the JAX package): on the F2 draw the integer engines' counters equal the
JAX package's on every route, a flipped or unequal counter fails both
contracts, and the f32 engine's measured error stays within its bound.
"""

import numpy as np
import pytest

from contract import (EPILOGUE_TOL, assert_counters_equal,
                      assert_counters_match, f32_adj_error, f32_tol,
                      near_threshold_pairs)
from utils import make_positions, random_genotypes


KW = dict(ld_wind=12000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=64)


def _f2_draw():
    """The F2 draw: seed 42, M = 300, N = 150, 15 rows with 10% missing
    genotypes (``tests/test_ld_split.py::row_level_missing``), 600 bp
    apart with 3 skipped positions.  Before the port computed its float32
    epilogue as XLA compiles the JAX package's, rows 191 and 192 counted
    one pair less in ``l2d_wse`` on the port."""
    from test_ld_split import row_level_missing

    rng = np.random.default_rng(42)
    g = row_level_missing(rng, 300, 150)
    pos = make_positions(300, spacing=600, jitter_rng=rng,
                         skip_idx=(20, 21, 22))
    return g, pos


def _both(g, pos, annot=None, **kw):
    from nldsc_tpu.config import LDConfig as JaxLDConfig
    from nldsc_tpu.ld import pipeline as jax_pipeline
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.ld import pipeline

    cfg = LDConfig(**KW, **kw)
    return (pipeline.compute_ld_scores(g, pos, cfg, annot=annot,
                                       device="cpu"),
            jax_pipeline.compute_ld_scores(g, pos, JaxLDConfig(**KW, **kw),
                                           annot=annot),
            cfg)


def _rejects(check, result, needle):
    """``check(result)`` raises an AssertionError naming ``needle``."""
    try:
        check(result)
    except AssertionError as ex:
        assert needle in str(ex), str(ex)
    else:
        raise AssertionError(f"an unequal result passed ({needle})")


def test_f2_draw_counters_equal():
    # the split and the global route: rows 191 and 192 included
    g, pos = _f2_draw()
    for split in (True, False):
        ours, theirs, _ = _both(g, pos, split_missing=split)
        assert_counters_equal(ours, theirs)


def _f2_stream(tmp_path, g, pos, **kw):
    from nldsc_tpu.config import LDConfig as JaxLDConfig
    from nldsc_tpu.io.plink import BedReader as JaxBedReader
    from nldsc_tpu.ld import streaming as jax_streaming
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
    from nldsc_tpu_torch.ld import streaming

    bed = PlinkDataset.parse(write_plink(tmp_path / "f2", g,
                                         bp=pos.astype(np.int64))).bed
    ours = streaming.compute_ld_scores_streaming(
        bed, pos, LDConfig(**KW, **kw), chunk_rows=128, device="cpu")
    theirs = jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos,
        JaxLDConfig(**KW, **kw), chunk_rows=128)
    return ours, theirs


@pytest.mark.parametrize("route", ["streamed", "annot", "full_band"])
def test_f2_draw_counters_equal_on_route(tmp_path, route):
    g, pos = _f2_draw()
    if route == "streamed":
        ours, theirs = _f2_stream(tmp_path, g, pos)
    elif route == "annot":
        rng = np.random.default_rng(7)
        annot = np.column_stack([np.ones(len(g)), rng.random(len(g)) < 0.3,
                                 rng.random(len(g))])
        ours, theirs, _ = _both(g, pos, annot=annot)
    else:
        ours, theirs, _ = _both(g, pos, symmetric=False)
    assert_counters_equal(ours, theirs)


def test_a_flipped_counter_far_from_the_threshold_fails():
    g, pos = _f2_draw()
    ours, theirs, cfg = _both(g, pos, split_missing=True)
    tol = f32_tol(256, 150, cfg.rsq_thr)
    assert near_threshold_pairs(g, pos, cfg, [100], tol)[0] == 0
    flipped = dict(ours, l2d_wse=ours["l2d_wse"].copy())
    flipped["l2d_wse"][100] += 1
    _rejects(lambda r: assert_counters_equal(r, theirs), flipped, "(100,")
    _rejects(lambda r: assert_counters_match(r, theirs, g, pos, cfg, tol),
             flipped, "(100,")


def test_unequal_window_counts_fail():
    g, pos = _f2_draw()
    ours, theirs, cfg = _both(g, pos, split_missing=True)
    for k in ("l2_ws", "l2d_ws"):
        bad = dict(ours, **{k: ours[k] + (np.arange(len(ours[k])) == 7)})
        _rejects(lambda r: assert_counters_equal(r, theirs), bad, k)
        _rejects(lambda r: assert_counters_match(r, theirs, g, pos, cfg,
                                                 EPILOGUE_TOL), bad, k)


def test_f32_adj_error_is_measured_within_its_worst_case_bound():
    from nldsc_tpu_torch.config import LDConfig

    rng = np.random.default_rng(5)
    g = random_genotypes(rng, 200, 300, missing_rate=0.02)
    pos = make_positions(200, spacing=600, jitter_rng=rng)
    cfg = LDConfig(**KW)
    bound = f32_tol(384, 300, cfg.rsq_thr)
    err, n_pairs = f32_adj_error(g, pos, cfg, bound)
    assert n_pairs > 0
    assert 0.0 < err <= bound
    # a narrower window reads fewer pairs, none with a larger error
    err_n, n_narrow = f32_adj_error(g, pos, cfg, bound / 4)
    assert n_narrow < n_pairs and err_n <= err
