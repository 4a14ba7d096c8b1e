"""Device-side preprocessing of the PyTorch port against the JAX
package: the 2-bit unpack and the int8 engine inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nldsc_tpu.io.plink import encode_bed_bytes
from nldsc_tpu.ld import ld_int8 as jax_int8
from nldsc_tpu.ld import preprocess as jax_pre
from nldsc_tpu_torch.ld import ld_int8, preprocess

from utils import adversarial_genotypes, random_genotypes


@pytest.mark.parametrize("n", [1, 7, 203, 256, 301])
@pytest.mark.parametrize("pad_val", [0, -1])
def test_unpack_bed_matches_jax(rng, n, pad_val):
    g = random_genotypes(rng, 19, n, missing_rate=0.1 if pad_val else 0.0)
    raw = encode_bed_bytes(g)
    # garbage in the last byte's pad bitpairs must be ignored
    if n % 4:
        raw[:, -1] |= np.uint8(0xFF << (2 * (n % 4)) & 0xFF)
    n_pad = -(-n // 128) * 128
    ours = preprocess.unpack_bed(torch.from_numpy(raw), n, n_pad, pad_val)
    theirs = jax_pre.unpack_bed(jnp.asarray(raw), n_samples=n, n_pad=n_pad,
                                pad_val=pad_val)
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(ours.numpy()[:, :n], g)


def _inputs(rng, missing: bool, m=60, n=203):
    g = random_genotypes(rng, m, n, missing_rate=0.05 if missing else 0.0)
    adv = adversarial_genotypes(rng, n)
    if not missing:
        adv = adv[:-1]                 # drop the heavy-missing row
    g = np.concatenate([g, adv])
    if missing:
        g[7] = -1                      # an all-missing SNP
    m = g.shape[0]
    n_pad = -(-n // 128) * 128
    gp = np.full((m, n_pad), -1 if missing else 0, dtype=np.int8)
    gp[:, :n] = g
    pos_ok = np.ones(m, bool)
    pos_ok[[2, 11]] = False
    return gp, pos_ok, n


@pytest.mark.parametrize("missing", [False, True])
def test_preprocess_int8_matches_jax(rng, missing):
    gp, pos_ok, n = _inputs(rng, missing)
    ours = ld_int8.preprocess_int8(torch.from_numpy(gp),
                                   torch.from_numpy(pos_ok), 0.01, n,
                                   assume_no_missing=not missing)
    theirs = jax_int8.preprocess_int8(jnp.asarray(gp), jnp.asarray(pos_ok),
                                      jnp.float32(0.01), n_samples=n,
                                      assume_no_missing=not missing)
    assert bool(theirs["has_missing"]) == missing
    for k in ("g", "h", "usable", "add_sd_zero"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      err_msg=k)
    if missing:
        np.testing.assert_array_equal(ours["m"].numpy(),
                                      np.asarray(theirs["m"]))
    for k in ("gsum", "hsum", "cm"):                     # exact counts
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]),
                                      err_msg=k)
    for k in ("am", "inv_sd", "inv_rstd", "v0", "v1", "v2", "maf", "rstd"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6, atol=0, equal_nan=True,
                                   err_msg=k)
    np.testing.assert_array_equal(
        ld_int8.stack_scalars(ours).numpy(),
        np.stack([ours[k].numpy() for k in ld_int8.SCAL_FIELDS], axis=1))
