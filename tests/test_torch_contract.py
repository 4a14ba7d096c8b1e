"""Tests of the counter contract of ``tests/contract.py`` (these import
the JAX package): the F2 draw passes it, a flipped or unequal counter
fails it, and the f32 engine's measured error stays within its bound.
"""

import numpy as np

from contract import (INT_TOL, assert_counters_match, f32_adj_error, f32_tol,
                      near_threshold_pairs)
from utils import make_positions, random_genotypes


KW = dict(ld_wind=12000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=64)


def _f2_draw():
    """The F2 draw: seed 42, M = 300, N = 150, 15 rows with 10% missing
    genotypes (``tests/test_ld_split.py::row_level_missing``), 600 bp
    apart with 3 skipped positions; rows 191 and 192 count one pair less
    on the port than on the JAX package."""
    from test_ld_split import row_level_missing

    rng = np.random.default_rng(42)
    g = row_level_missing(rng, 300, 150)
    pos = make_positions(300, spacing=600, jitter_rng=rng,
                         skip_idx=(20, 21, 22))
    return g, pos


def _both(g, pos, **kw):
    from nldsc_tpu.config import LDConfig as JaxLDConfig
    from nldsc_tpu.ld import pipeline as jax_pipeline
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.ld import pipeline

    cfg = LDConfig(**KW, **kw)
    return (pipeline.compute_ld_scores(g, pos, cfg, device="cpu"),
            jax_pipeline.compute_ld_scores(g, pos, JaxLDConfig(**KW, **kw)),
            cfg)


def test_f2_draw_passes_the_contract():
    g, pos = _f2_draw()
    for split in (True, False):
        ours, theirs, cfg = _both(g, pos, split_missing=split)
        assert not np.array_equal(ours["l2d_wse"], theirs["l2d_wse"])
        n_exempt = assert_counters_match(ours, theirs, g, pos, cfg, INT_TOL)
        assert 1 <= n_exempt <= 2


def test_a_flipped_counter_far_from_the_threshold_fails():
    g, pos = _f2_draw()
    ours, theirs, cfg = _both(g, pos, split_missing=True)
    assert near_threshold_pairs(g, pos, cfg, [100], INT_TOL)[0] == 0
    flipped = dict(ours, l2d_wse=ours["l2d_wse"].copy())
    flipped["l2d_wse"][100] += 1
    try:
        assert_counters_match(flipped, theirs, g, pos, cfg, INT_TOL)
    except AssertionError as ex:
        assert "(100," in str(ex)
    else:
        raise AssertionError("a flipped counter passed the contract")


def test_unequal_window_counts_fail():
    g, pos = _f2_draw()
    ours, theirs, cfg = _both(g, pos, split_missing=True)
    for k in ("l2_ws", "l2d_ws"):
        bad = dict(ours, **{k: ours[k] + (np.arange(len(ours[k])) == 7)})
        try:
            assert_counters_match(bad, theirs, g, pos, cfg, INT_TOL)
        except AssertionError as ex:
            assert k in str(ex)
        else:
            raise AssertionError(f"an unequal {k} passed the contract")


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
