"""The dispatch rings of the port's streaming route
(``compute_ld_scores_streaming(devices=, sample_mesh=, grid=)``) on
repeated CPU devices, against the JAX package's rings on its virtual CPU
devices (``tests/conftest.py``), with one resume each.

The ``devices`` ring runs each chunk as the single-device route runs it,
so its results equal that route's bit for bit; the sample-sharded rings
sum exact products over the shards, so they are bitwise invariant in the
shard count and the grid's shape.
"""

import os

import numpy as np
import pytest

import jax

from nldsc_tpu.config import LDConfig as JaxLDConfig
from nldsc_tpu.io.plink import BedReader as JaxBedReader
from nldsc_tpu.ld import streaming as jax_streaming
from nldsc_tpu.parallel import snp_mesh
from nldsc_tpu.parallel.grid_sharded import grid_mesh
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
from nldsc_tpu_torch.ld import streaming
from nldsc_tpu_torch.parallel import grid_devices, snp_devices

from contract import assert_counters_equal
from test_ld_split import row_level_missing
from utils import make_positions, random_genotypes

GOLDEN = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
KW = dict(ld_wind=9000.0, wind_metric="bp", maf_thr=0.01, std_thr=1e-4,
          rsq_thr=1e-3, block_size=16)


def _bfile(tmp_path, rng, kind, m=320, n=150):
    g = (row_level_missing(rng, m, n, row_frac=0.1, entry_rate=0.3)
         if kind == "split" else
         random_genotypes(rng, m, n, missing_rate=0.03 if kind == "global"
                          else 0.0))
    pos = make_positions(m, spacing=800, jitter_rng=rng)
    prefix = write_plink(tmp_path / kind, g, bp=pos.astype(np.int64))
    return g, pos, PlinkDataset.parse(prefix).bed


def _stream(bed, pos, resume=None, **layout):
    return streaming.compute_ld_scores_streaming(
        bed, pos, LDConfig(**KW), chunk_rows=64, resume_path=resume,
        device="cpu", **layout)


def _jax_stream(bed, pos, **layout):
    return jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos,
        JaxLDConfig(**KW), chunk_rows=64, **layout)


def _hold(ours, theirs, g, pos):
    for k in ("l2", "l2d", "maf", "residuals_std"):
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **GOLDEN)
    assert_counters_equal(ours, theirs)


def _assert_bitwise(a, b, what):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {what}")


def _resume(bed, pos, ck, keep, **layout):
    """A checkpointed run, its shards from chunk ``keep`` on deleted, and
    the resumed run."""
    full = _stream(bed, pos, resume=str(ck), **layout)
    for f in sorted(os.listdir(ck)):
        if f.startswith("chunk_") and int(f[6:12]) >= keep:
            os.remove(ck / f)
    return full, _stream(bed, pos, resume=str(ck), **layout)


@pytest.mark.parametrize("kind", ["clean", "global", "split"])
def test_devices_ring_matches_jax_and_the_single_device_route(
        rng, tmp_path, kind):
    g, pos, bed = _bfile(tmp_path, rng, kind)
    ours = _stream(bed, pos, devices=snp_devices(3, "cpu"))
    _hold(ours, _jax_stream(bed, pos, devices=jax.devices()[:3]), g, pos)
    _assert_bitwise(ours, _stream(bed, pos), "ring against one device")
    full, resumed = _resume(bed, pos, tmp_path / "ck", 2,
                            devices=snp_devices(2, "cpu"))
    _assert_bitwise(resumed, full, "resumed")
    _assert_bitwise(full, ours, "checkpointed")


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("kind", ["clean", "global"])
def test_sample_mesh_matches_jax(rng, tmp_path, kind, d):
    g, pos, bed = _bfile(tmp_path, rng, kind)
    ours = _stream(bed, pos, sample_mesh=snp_devices(d, "cpu"))
    _hold(ours, _jax_stream(bed, pos, sample_mesh=snp_mesh(d)), g, pos)
    _assert_bitwise(ours, _stream(bed, pos,
                                  sample_mesh=snp_devices(1, "cpu")),
                    f"{d} sample shards against 1")
    if d == 2:
        full, resumed = _resume(bed, pos, tmp_path / "ck", 3,
                                sample_mesh=snp_devices(d, "cpu"))
        _assert_bitwise(resumed, ours, "resumed")


def test_sample_mesh_annot_matches_jax(rng, tmp_path):
    g, pos, bed = _bfile(tmp_path, rng, "global")
    annot = np.column_stack([np.ones(len(g)), rng.random(len(g))])
    ours = streaming.compute_ld_scores_streaming(
        bed, pos, LDConfig(**KW), chunk_rows=64, annot=annot, device="cpu",
        sample_mesh=snp_devices(2, "cpu"))
    theirs = jax_streaming.compute_ld_scores_streaming(
        JaxBedReader(bed.path, bed.n_snp, bed.n_samples), pos,
        JaxLDConfig(**KW), chunk_rows=64, annot=annot,
        sample_mesh=snp_mesh(2))
    _hold(ours, theirs, g, pos)
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **GOLDEN)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_grid_ring_matches_jax(rng, tmp_path, shape):
    g, pos, bed = _bfile(tmp_path, rng, "global")
    ours = _stream(bed, pos, grid=grid_devices(*shape, "cpu"))
    _hold(ours, _jax_stream(bed, pos, grid=grid_mesh(*shape)), g, pos)
    _assert_bitwise(ours, _stream(bed, pos,
                                  sample_mesh=snp_devices(1, "cpu")),
                    f"grid {shape} against one sample shard")
    if shape == (2, 2):
        full, resumed = _resume(bed, pos, tmp_path / "ck", 1,
                                grid=grid_devices(*shape, "cpu"))
        _assert_bitwise(resumed, ours, "resumed")


def test_ring_exclusions_and_engine(rng, tmp_path):
    # the reference's errors (streaming.py:486-518)
    _, pos, bed = _bfile(tmp_path, rng, "clean", m=64)
    cpu2 = snp_devices(2, "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _stream(bed, pos, grid=grid_devices(2, 1, "cpu"), devices=cpu2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _stream(bed, pos, sample_mesh=cpu2, devices=cpu2)
    for layout in ({"sample_mesh": cpu2},
                   {"grid": grid_devices(2, 1, "cpu")}):
        with pytest.raises(ValueError, match="symmetric integer engine"):
            streaming.compute_ld_scores_streaming(
                bed, pos, LDConfig(**KW, symmetric=False), chunk_rows=64,
                device="cpu", **layout)
