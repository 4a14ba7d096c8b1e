"""F4: the port's CPU square roots are correctly rounded, on every call and
at any thread count (``nldsc_tpu_torch/core/numerics.py``).

ATen's CPU ``torch.sqrt`` goes through MKL VML: within 1 ulp, not
correctly rounded, and on the process's first VML call from several
OpenMP threads one thread's share may come from VML's ~11-bit EP kernel.
The per-SNP scalars ``1/sd`` and ``1/rstd`` feed every correlation and
the threshold counters, so the port takes its square roots through
``sqrt_rn``.  (a) holds the scalars to a NumPy recomputation, (b) and (c)
run the F4 recipe in fresh processes against a 1-thread run, (d) holds
that shape to the JAX package.  Only (d) imports JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nldsc_tpu_torch.core.numerics import sqrt_rn
from nldsc_tpu_torch.ld import ld_int8, preprocess

from numerics_ref import (F4_CFG, F4_M, F4_N, FIELDS, f4_data,
                          reference_scalars, sqrt64)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def eight_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    yield
    torch.set_num_threads(before)


def f32_rows(g: np.ndarray, ref: dict):
    """``preprocess.preprocess_block``'s standardized rows from the
    reference scalars (clean codes)."""
    f = np.float32
    gf = g.astype(f)
    add = np.where(ref["usable"][:, None],
                   (gf - ref["am"][:, None]) * ref["inv_sd"][:, None], f(0))
    v0, v1, v2 = (v[:, None] for v in ref["v"])
    r_c = (v0 + np.where(gf == 1, v1 - v0, f(0))
           + np.where(gf == 2, v2 - v0, f(0)))
    res = np.where(ref["ok_d"][:, None], r_c * ref["inv_rstd"][:, None],
                   f(0))
    return add, res


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sqrt_rn_is_correctly_rounded(eight_threads, dtype):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(1e-3, 1.0, 24_576),
                        [0.0, 4.0, 1e-30]]).astype(dtype)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.numpy().dtype == dtype and got.shape == x.shape
    want = sqrt64(x) if dtype == np.float32 else np.sqrt(x)
    np.testing.assert_array_equal(got.numpy(), want)
    # a 0-d tensor and a strided view keep their shapes
    assert sqrt_rn(torch.tensor(9.0, dtype=got.dtype)).item() == 3.0
    view = torch.from_numpy(x)[::3]
    np.testing.assert_array_equal(sqrt_rn(view).numpy(), want[::3])


@pytest.mark.parametrize("engine", ["int8", "f32"])
def test_per_snp_scalars_are_correctly_rounded(eight_threads, engine):
    # (a) the steady fault: torch's CPU sqrt is 1 ulp off on ~0.5% of
    # these rows (114 of 24,576 in torch 2.13 on an AVX-512 CPU)
    g, _ = f4_data()
    ref = reference_scalars(g, F4_CFG["maf_thr"], F4_N)
    codes = torch.from_numpy(g)
    pos_ok = torch.ones(F4_M, dtype=torch.bool)
    if engine == "int8":
        pre = ld_int8.preprocess_int8(codes, pos_ok, F4_CFG["maf_thr"], F4_N,
                                      assume_no_missing=True)
        for k in ("inv_sd", "inv_rstd", "rstd"):
            np.testing.assert_array_equal(pre[k].numpy(), ref[k], err_msg=k)
    else:
        pre = preprocess.preprocess_block(codes, pos_ok, F4_CFG["maf_thr"],
                                          F4_N)
        add, res = f32_rows(g, ref)
        np.testing.assert_array_equal(pre["rstd"].numpy(), ref["rstd"])
        np.testing.assert_array_equal(pre["add"].numpy(), add)
        np.testing.assert_array_equal(pre["res"].numpy(), res)


_WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(int(sys.argv[1]))
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.ld import pipeline
d = np.load(sys.argv[2])
r = pipeline.compute_ld_scores(d["g"], d["pos"], LDConfig(**{cfg!r}),
                               device="cpu")
np.savez(sys.argv[3], **{{k: r[k] for k in {fields!r}}})
"""


def f4_stress(tmp_path, n_proc: int) -> list:
    """Run the F4 recipe once at 1 thread and ``n_proc`` times at 8, each
    in a fresh process (one at a time), and return the runs that differ
    from the 1-thread one: (run, {field: rows that differ})."""
    g, pos = f4_data()
    np.savez(tmp_path / "f4.npz", g=g, pos=pos)
    code = _WORKER.format(cfg=F4_CFG, fields=FIELDS)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(threads, name):
        out = tmp_path / f"{name}.npz"
        subprocess.run([sys.executable, "-c", code, str(threads),
                        str(tmp_path / "f4.npz"), str(out)],
                       env=env, cwd=ROOT, check=True, capture_output=True,
                       timeout=300)
        return np.load(out)

    one = run(1, "one")
    bad = []
    for i in range(n_proc):
        r = run(8, f"run{i}")
        diff = {k: int((r[k] != one[k]).sum()) for k in FIELDS}
        if any(diff.values()):
            bad.append((i, diff))
    return bad


def test_f4_fresh_processes_match_one_thread(tmp_path):
    # (b) the chunk fault, as many fresh processes as fit about 30 s
    assert f4_stress(tmp_path, 4) == []


@pytest.mark.slow
def test_f4_stress_forty_processes(tmp_path):
    # (c) the full stress: with ATen's sqrt, 5 of 40 processes differed
    # (torch 2.13 on an 8-core AVX-512 CPU)
    assert f4_stress(tmp_path, 40) == []


def test_f4_shape_matches_jax():
    # (d) counters equal, scores within the golden tolerances;
    # at N = 64 dividing by n is exact, so the per-SNP scalars are bitwise
    # the JAX package's
    import jax.numpy as jnp
    from contract import assert_counters_equal
    from nldsc_tpu.config import LDConfig as JaxLDConfig
    from nldsc_tpu.ld import ld_int8 as jax_int8
    from nldsc_tpu.ld import pipeline as jax_pipeline
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.ld import pipeline
    from test_golden import check

    g, pos = f4_data()
    pos_ok = np.ones(F4_M, bool)
    ours_pre = ld_int8.preprocess_int8(torch.from_numpy(g),
                                       torch.from_numpy(pos_ok), 0.01, F4_N,
                                       assume_no_missing=True)
    theirs_pre = jax_int8.preprocess_int8(
        jnp.asarray(g), jnp.asarray(pos_ok), jnp.float32(0.01),
        n_samples=F4_N, assume_no_missing=True)
    for k in (*ld_int8.SCAL_FIELDS, "rstd", "maf"):
        np.testing.assert_array_equal(ours_pre[k].numpy(),
                                      np.asarray(theirs_pre[k]), err_msg=k)
    cfg = LDConfig(**F4_CFG)
    ours = pipeline.compute_ld_scores(g, pos, cfg, device="cpu")
    theirs = jax_pipeline.compute_ld_scores(g, pos, JaxLDConfig(**F4_CFG))
    assert_counters_equal(ours, theirs)
    check(ours, theirs)


@pytest.mark.parametrize("scalars", ["port", "jax"])
@pytest.mark.parametrize("split", [True, False])
def test_f2_counters_equal_with_either_packages_scalars(monkeypatch, split,
                                                         scalars):
    # F2 (ROADMAP §3): the port's counters equal the JAX package's on F2's
    # draw, with its own per-SNP scalars or with the JAX package's
    # (jitted, as its pipeline runs them: XLA divides by n as x · f32(1/n))
    import jax
    import jax.numpy as jnp
    from contract import assert_counters_equal
    from nldsc_tpu.config import LDConfig as JaxLDConfig
    from nldsc_tpu.ld import ld_int8 as jax_int8
    from nldsc_tpu.ld import pipeline as jax_pipeline
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.ld import pipeline
    from test_torch_contract import KW, _f2_draw

    finish = jax.jit(jax_int8.finish_preprocess_int8,
                     static_argnames=("n_samples", "n_pad_cols"))

    def jax_scalars(n_valid_raw, c1, c2, cm, pos_ok, maf_thr, n_samples,
                    constant_n_valid=False):
        # F2's draw has missing genotypes: the valid counts are runtime
        # values in the JAX package too
        assert not constant_n_valid
        out = finish(*(jnp.asarray(t.numpy())
                       for t in (n_valid_raw, c1, c2, cm, pos_ok)),
                     jnp.float32(maf_thr), n_samples=n_samples, n_pad_cols=0)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    g, pos = _f2_draw()
    theirs = jax_pipeline.compute_ld_scores(
        g, pos, JaxLDConfig(**KW, split_missing=split))
    if scalars == "jax":
        monkeypatch.setattr(ld_int8, "finish_preprocess_int8", jax_scalars)
    ours = pipeline.compute_ld_scores(g, pos, LDConfig(**KW,
                                                       split_missing=split),
                                      device="cpu")
    assert_counters_equal(ours, theirs)
