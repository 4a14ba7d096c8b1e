"""The SNP axis of the port's multi-device route
(``nldsc_tpu_torch.parallel.sharded``) on repeated CPU devices, against the
JAX package's ``ld_scores_sharded`` on the same number of its virtual CPU
devices (``tests/conftest.py``), and against itself across device counts.

Scores within ``tests/test_golden.py``'s tolerances, counters under the
contract of ``tests/contract.py``; the port's l2/l2d bitwise invariant in
the device count (the symmetric body folds the shards' unfolded partials
once, in tile order; the full-band body gives every pivot block the same
columns on any count).
"""

import numpy as np
import pytest
import torch

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.parallel import ld_scores_sharded as jax_sharded
from nldsc_tpu.parallel import snp_mesh
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import ld_pallas_sym, pipeline
from nldsc_tpu_torch.parallel import ld_scores_sharded, mesh, sharded

from contract import assert_counters_equal, assert_counters_match, f32_tol
from utils import adversarial_genotypes, make_positions, random_genotypes

GOLDEN = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
FLOATS = ("l2", "l2d", "maf", "residuals_std")
COUNTERS = ("l2_ws", "l2d_ws", "l2d_wse")
BASE = dict(wind_metric="bp", maf_thr=0.01, std_thr=1e-4, rsq_thr=1e-3,
            block_size=16)

# case -> (m, n, missing rate, spacing bp, window bp, config fields)
CASES = {
    "clean": (256, 140, 0.0, 800, 6000.0, {}),
    "missing": (256, 140, 0.03, 800, 6000.0, {}),
    # the window spans several shards: the halo comes from shards beyond
    # the neighbour (cf. tests/test_sharded.py:64-85)
    "multi_hop": (200, 96, 0.02, 300, 30000.0, {}),
    "no_symmetric": (256, 140, 0.03, 800, 6000.0, {"symmetric": False}),
    "f32": (256, 140, 0.03, 800, 6000.0, {"use_int8": False}),
}


def _data(rng, case):
    m, n, rate, spacing, wind, fields = CASES[case]
    g = random_genotypes(rng, m, n, missing_rate=rate)
    g[40:45] = adversarial_genotypes(rng, n)[:5]
    pos = make_positions(m, spacing=spacing, jitter_rng=rng, skip_idx=(7,))
    return g, pos, {**BASE, "ld_wind": wind, **fields}


def _hold(ours, theirs, g, pos, kw, keys=FLOATS):
    for k in keys:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **GOLDEN)
    if kw.get("use_int8", True):
        assert_counters_equal(ours, theirs)
        return
    n = g.shape[1]
    assert assert_counters_match(ours, theirs, g, pos, LDConfig(**kw),
                                 f32_tol(-(-n // 128) * 128, n,
                                         kw["rsq_thr"])) <= 3


def _assert_bitwise(a, b, what):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {what}")


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_and_is_invariant_in_d(rng, case, d):
    g, pos, kw = _data(rng, case)
    ours = ld_scores_sharded(g, pos, LDConfig(**kw),
                             mesh.snp_devices(d, "cpu"))
    theirs = jax_sharded(g, pos, JaxLDConfig(**kw), snp_mesh(d))
    _hold(ours, theirs, g, pos, kw)
    if d > 1:
        one = ld_scores_sharded(g, pos, LDConfig(**kw),
                                mesh.snp_devices(1, "cpu"))
        _assert_bitwise(ours, one, f"at d={d} against d=1")


@pytest.mark.parametrize("case", ["clean", "missing", "no_symmetric"])
def test_sharded_matches_incore(rng, case):
    # the same engine in core: counters equal, scores within float32
    # summation order (the symmetric body sums per tile slot)
    g, pos, kw = _data(rng, case)
    ours = ld_scores_sharded(g, pos, LDConfig(**kw),
                             mesh.snp_devices(2, "cpu"))
    incore = pipeline.compute_ld_scores(g, pos, LDConfig(**kw),
                                        device="cpu")
    for k in FLOATS:
        np.testing.assert_allclose(ours[k], incore[k], rtol=1e-6, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    for k in COUNTERS:
        np.testing.assert_array_equal(ours[k], incore[k], err_msg=k)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_annot_matches_jax(rng, d):
    # --annot on the CPU: the full-band body, as the reference routes it
    g, pos, kw = _data(rng, "missing")
    annot = np.column_stack([np.ones(len(g)), rng.random(len(g)) < 0.3,
                             rng.random(len(g))]).astype(np.float64)
    ours = ld_scores_sharded(g, pos, LDConfig(**kw),
                             mesh.snp_devices(d, "cpu"), annot=annot)
    theirs = jax_sharded(g, pos, JaxLDConfig(**kw), snp_mesh(d), annot=annot)
    _hold(ours, theirs, g, pos, kw, FLOATS + ("l2_annot", "l2d_annot"))
    if d > 1:
        one = ld_scores_sharded(g, pos, LDConfig(**kw),
                                mesh.snp_devices(1, "cpu"), annot=annot)
        _assert_bitwise(ours, one, f"at d={d}")


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_packed_matches_jax(rng, tmp_path, d):
    # packed rows go to the shards as bytes and are unpacked there
    g, pos, kw = _data(rng, "missing")
    prefix = write_plink(tmp_path / "p", g, bp=pos.astype(np.int64))
    bed = PlinkDataset.parse(prefix).bed
    ours = ld_scores_sharded(bed.read_raw(), pos, LDConfig(**kw),
                             mesh.snp_devices(d, "cpu"))
    theirs = jax_sharded(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples).read_raw(), pos,
        JaxLDConfig(**kw), snp_mesh(d))
    _hold(ours, theirs, g, pos, kw)
    _assert_bitwise(ours, ld_scores_sharded(g, pos, LDConfig(**kw),
                                            mesh.snp_devices(d, "cpu")),
                    "packed against codes")


def test_symmetric_partials_fold_once_in_tile_order(rng, monkeypatch):
    # one sym_partials call per shard with the run's band, one fold over
    # the in-core run's tiles; every halo row's window emptied
    g, pos, kw = _data(rng, "multi_hop")
    calls, folds = [], []
    real, fold = ld_pallas_sym.sym_partials, ld_pallas_sym.fold_partials

    def spy(g_, m_, h_, scal, lo, hi, *a, **k):
        calls.append((g_.shape[0], k["band"], int((hi < 0).sum())))
        return real(g_, m_, h_, scal, lo, hi, *a, **k)

    def spy_fold(*parts):
        folds.append(parts[0].shape[:2])
        return fold(*parts)

    monkeypatch.setattr(ld_pallas_sym, "sym_partials", spy)
    monkeypatch.setattr(ld_pallas_sym, "fold_partials", spy_fold)
    cfg = LDConfig(**kw)
    geo = sharded.sharded_geometry(len(g), g.shape[1], pos, cfg, 4, "cpu",
                                   True)
    ld_scores_sharded(g, pos, cfg, mesh.snp_devices(4, "cpu"))
    assert geo.halo > geo.rows                  # wider than a shard
    assert [c[1] for c in calls] == [geo.band] * 4
    # each shard's rows and halo, up to the padded end
    assert [c[0] for c in calls] == [
        min(geo.rows + geo.halo, geo.m_pad - s * geo.rows) for s in range(4)]
    assert all(c[2] >= c[0] - geo.rows for c in calls)   # halo emptied
    assert folds == [(-(-len(g) // 16), geo.band)]


def test_exchanges_copy_even_on_one_device(rng):
    g, pos, kw = _data(rng, "clean")
    mesh.exchange_bytes = 0
    ld_scores_sharded(g, pos, LDConfig(**kw), mesh.snp_devices(1, "cpu"))
    assert mesh.exchange_bytes == 0              # one shard: nothing sent
    ld_scores_sharded(g, pos, LDConfig(**kw), mesh.snp_devices(2, "cpu"))
    assert mesh.exchange_bytes > 0
    x = torch.arange(6)
    y = mesh.send(x, torch.device("cpu"))
    assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()


def test_row_window_multi_hop_and_edges():
    parts = [torch.arange(4) + 4 * t for t in range(3)]        # rows 0..11
    w = sharded.row_window(parts, 0, -2, 10, torch.device("cpu"))
    assert w.tolist() == [0, 0] + list(range(10))
    w = sharded.row_window(parts, 2, 6, 14, torch.device("cpu"))
    assert w.tolist() == list(range(6, 12)) + [0, 0]
    own = sharded.row_window(parts, 1, 4, 8, torch.device("cpu"))
    assert own.data_ptr() == parts[1].data_ptr()        # its own rows: no copy
