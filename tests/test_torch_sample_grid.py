"""The sample axis and the 2-D grid of the port's multi-device route
(``nldsc_tpu_torch.parallel.sample_sharded`` and ``grid_sharded``) on
repeated CPU devices, against the JAX package's engines on as many of its
virtual CPU devices (``tests/conftest.py``).

Scores within ``tests/test_golden.py``'s tolerances, counters equal
(``tests/contract.py``); the port's results bitwise invariant in the
shard count and the grid's shape, and the sample axis bitwise equal to
the in-core full band (the products summed over the shards are exact)
with the per-SNP scalars in the form of the sample axis, whose valid
counts are summed at run time (``ld_int8.finish_preprocess_int8``).
"""

from functools import partial

import numpy as np
import pytest

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.parallel import snp_mesh
from nldsc_tpu.parallel.grid_sharded import grid_mesh
from nldsc_tpu.parallel.grid_sharded import (
    ld_scores_grid_sharded as jax_grid)
from nldsc_tpu.parallel.sample_sharded import (
    ld_scores_sample_sharded as jax_samples)
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core.errors import NLDSCParameterError
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import ld_int8, pipeline, preprocess
from nldsc_tpu_torch.parallel import (grid_devices, ld_scores_grid_sharded,
                                      ld_scores_sample_sharded, mesh,
                                      snp_devices)

from contract import assert_counters_equal
from utils import adversarial_genotypes, make_positions, random_genotypes

GOLDEN = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
FLOATS = ("l2", "l2d", "maf", "residuals_std")
KW = dict(ld_wind=6000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=16)


def _data(rng, rate, m=192, n=300):
    g = random_genotypes(rng, m, n, missing_rate=rate)
    g[20:25] = adversarial_genotypes(rng, n)[:5]
    pos = make_positions(m, spacing=800, jitter_rng=rng, skip_idx=(3,))
    return g, pos


def _hold(ours, theirs, g, pos, keys=FLOATS):
    for k in keys:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **GOLDEN)
    assert_counters_equal(ours, theirs)


def _assert_bitwise(a, b, what):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {what}")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("rate", [0.0, 0.03])
def test_sample_sharded_matches_jax_and_incore(rng, monkeypatch, rate, d):
    g, pos = _data(rng, rate)
    ours = ld_scores_sample_sharded(g, pos, LDConfig(**KW),
                                    snp_devices(d, "cpu"))
    _hold(ours, jax_samples(g, pos, JaxLDConfig(**KW), snp_mesh(d)), g, pos)
    # the in-core full band (ld_int8.ld_scores_int8), bit for bit, with its
    # valid counts taken at run time as the sample axis takes them (on
    # clean data the in-core preprocess, as the JAX package's, divides by
    # the constant n as a product by f32(1/n))
    monkeypatch.setattr(ld_int8, "preprocess_int8", partial(
        ld_int8.preprocess_int8, constant_n_valid=False))
    full = pipeline.compute_ld_scores(g, pos, LDConfig(**KW, symmetric=False),
                                      device="cpu")
    _assert_bitwise(ours, full, "against the in-core full band")
    _assert_bitwise(ours, ld_scores_sample_sharded(
        g, pos, LDConfig(**KW), snp_devices(1, "cpu")), f"at d={d}")


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_grid_sharded_matches_jax_and_is_layout_invariant(rng, shape):
    g, pos = _data(rng, 0.03)
    ours = ld_scores_grid_sharded(g, pos, LDConfig(**KW),
                                  grid_devices(*shape, "cpu"))
    _hold(ours, jax_grid(g, pos, JaxLDConfig(**KW), grid_mesh(*shape)), g,
          pos)
    _assert_bitwise(ours, ld_scores_grid_sharded(
        g, pos, LDConfig(**KW), grid_devices(1, 1, "cpu")), f"at {shape}")


def test_grid_annot_matches_jax(rng):
    g, pos = _data(rng, 0.03)
    annot = np.column_stack([np.ones(len(g)), rng.random(len(g))])
    ours = ld_scores_grid_sharded(g, pos, LDConfig(**KW),
                                  grid_devices(2, 2, "cpu"), annot=annot)
    theirs = jax_grid(g, pos, JaxLDConfig(**KW), grid_mesh(2, 2),
                      annot=annot)
    _hold(ours, theirs, g, pos, FLOATS + ("l2_annot", "l2d_annot"))


@pytest.mark.parametrize("d", [2, 4])
def test_sample_sharded_packed_and_annot(rng, tmp_path, d):
    # each shard receives its 32-byte lanes of the packed rows only and
    # unpacks them from its first sample (unpack_bed(col0=))
    g, pos = _data(rng, 0.03, n=301)
    prefix = write_plink(tmp_path / "s", g, bp=pos.astype(np.int64))
    bed = PlinkDataset.parse(prefix).bed
    annot = np.column_stack([np.ones(len(g)), rng.random(len(g)) < 0.4])
    mesh.exchange_bytes = 0
    ours = ld_scores_sample_sharded(bed.read_raw(), pos, LDConfig(**KW),
                                    snp_devices(d, "cpu"), annot=annot)
    assert mesh.exchange_bytes > 0
    theirs = jax_samples(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples).read_raw(), pos,
        JaxLDConfig(**KW), snp_mesh(d), annot=annot)
    _hold(ours, theirs, g, pos, FLOATS + ("l2_annot", "l2d_annot"))
    _assert_bitwise(ours, ld_scores_sample_sharded(
        g, pos, LDConfig(**KW), snp_devices(d, "cpu"), annot=annot),
        "packed against codes")


@pytest.mark.parametrize("col0", [0, 128, 256])
def test_unpack_bed_from_a_shards_first_sample(rng, col0):
    # a shard's bytes unpack to the columns of the whole rows from col0
    from nldsc_tpu_torch.io.plink import encode_bed_bytes
    import torch

    g = random_genotypes(rng, 7, 301, missing_rate=0.1)
    raw = np.full((7, 96), 0x55, np.uint8)
    raw[:, :76] = encode_bed_bytes(g)
    whole = preprocess.unpack_bed(torch.from_numpy(raw), 301, 384, -1)
    part = preprocess.unpack_bed(
        torch.from_numpy(np.ascontiguousarray(raw[:, col0 // 4:
                                                 col0 // 4 + 32])),
        301, 128, -1, col0=col0)
    assert torch.equal(part, whole[:, col0:col0 + 128])
    with pytest.raises(ValueError, match="does not fit"):
        preprocess.unpack_bed(torch.from_numpy(raw[:, :32].copy()), 301,
                              256, -1)


def test_f32_engine_is_refused_on_the_sample_and_grid_axes(rng, tmp_path):
    g, pos = _data(rng, 0.0, m=64, n=40)
    prefix = write_plink(tmp_path / "f", g, bp=pos.astype(np.int64))
    for axis in ("samples", "grid"):
        with pytest.raises(NLDSCParameterError, match="integer engine"):
            pipeline.estimate_lds(prefix, 6, "kbp", maf_thr=0.01,
                                  use_int8=False, n_devices=4,
                                  shard_samples=axis == "samples",
                                  shard_grid=axis == "grid", device="cpu")
