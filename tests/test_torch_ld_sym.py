"""The symmetric int8 LD pass of the PyTorch port against the JAX package.

Both packages get identical engine inputs (the JAX ``preprocess_int8``
dict carried across by ``from_jax_inputs``).  The port's plain twin
``sym_scan_segment`` is held against JAX's ``sym_scan_segment`` and
against the Pallas kernel in interpret mode, over the cases of
``tests/test_ld_pallas_sym.py``: counters exactly equal, l2/l2d within
that file's 3e-6.  The CUDA kernel's tile geometry and fixed-order fold
are rehearsed on the CPU by an emulation that fills the kernel's
partial-sum layout with each branch's tile (128 rows clean, 64 with
missing genotypes); the kernel itself is held against the twin on the
card in ``tests/test_torch_kernel.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nldsc_tpu.ld import ld_int8 as jax_int8
from nldsc_tpu.ld import ld_pallas_sym as jax_pallas
from nldsc_tpu.ld import ld_xla as jax_xla
from nldsc_tpu.ld import windows as jax_windows
from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym
from nldsc_tpu_torch.ld.convert import from_jax_inputs
from nldsc_tpu_torch.ld.ld_xla import finalize_outputs

from utils import adversarial_genotypes, make_positions, random_genotypes

RSQ = 1e-3
TOL = dict(rtol=3e-6, atol=3e-6, equal_nan=True)

# (m, n, missing_rate, spacing, block size): clean, missing, right-edge
# clamp (window wider than the matrix), multi-chunk (N_pad = 384)
CASES = {
    "clean": (160, 200, 0.0, 800, 32),
    "missing": (160, 200, 0.05, 800, 32),
    "edge_clamp": (96, 150, 0.02, 100, 32),
    "multi_chunk": (64, 384, 0.02, 900, 32),
}


def _engine_inputs(g, pos, B, wind=6000.0):
    """JAX engine inputs (numpy) for padded (m_pad, n_pad) codes."""
    m, n = g.shape
    m_pad = -(-m // B) * B
    n_pad = -(-n // 128) * 128
    has_missing = bool((g < 0).any())
    gp = np.full((m_pad, n_pad), -1 if has_missing else 0, dtype=np.int8)
    gp[:m, :n] = g
    lo, hi, pos_ok = jax_windows.window_bounds(pos, wind)
    blk_lo, blk_hi, _ = jax_windows.band_blocks(lo, hi, B, m_pad // B)
    pos_ok_p = np.zeros(m_pad, bool)
    pos_ok_p[:m] = pos_ok
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    pre = jax_int8.preprocess_int8(
        jnp.asarray(gp), jnp.asarray(pos_ok_p), jnp.float32(0.01),
        n_samples=n, assume_no_missing=not has_missing)
    dom_ok = pre["usable"] & (pre["rstd"] > jnp.float32(1e-4))
    return dict(pre=pre, dom_ok=dom_ok, lo=lo_p, hi=hi_p, n=n,
                right_k=jax_windows.right_band_blocks(blk_hi, B),
                has_missing=has_missing)


def _case(rng, name):
    m, n, rate, spacing, B = CASES[name]
    g = random_genotypes(rng, m, n, missing_rate=rate)
    adv = adversarial_genotypes(rng, n)
    g[10:10 + 5] = adv[:5]
    if rate > 0:
        g[20] = adv[5]                 # heavy missing
        g[30] = -1                     # all missing: an additive poison
    pos = make_positions(m, spacing=spacing, jitter_rng=rng, skip_idx=(3,))
    return g, pos, B


def _port_args(e):
    inp = from_jax_inputs({k: np.asarray(v) for k, v in e["pre"].items()},
                          e["lo"], e["hi"], np.asarray(e["dom_ok"]))
    return inp, (inp["g"], inp["m"], inp["h"], inp["scal"], inp["lo"],
                 inp["hi"], inp["usable"], inp["dom_ok"], inp["add_sd_zero"])


def _finalized(credits, inp):
    l2, ws, poi, l2d, wsd, wse = credits
    return [x.numpy() for x in finalize_outputs(
        l2, l2d, ws, wsd, wse, poi, inp["usable"], inp["add_sd_zero"])]


def _assert_same(ours, theirs, m):
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a[:m], np.asarray(b)[:m], **TOL)
    for a, b in zip(ours[2:], theirs[2:]):
        np.testing.assert_array_equal(a[:m], np.asarray(b)[:m])


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_scan_and_pallas(rng, case):
    g, pos, B = _case(rng, case)
    e = _engine_inputs(g, pos, B)
    pre = e["pre"]
    m_pad = e["lo"].shape[0]
    jargs = (pre["g"], pre["m"], pre["h"], jax_int8.stack_scalars(pre),
             jnp.asarray(e["lo"]), jnp.asarray(e["hi"]), pre["usable"],
             e["dom_ok"], pre["add_sd_zero"])
    j_l2, j_ws, j_poi, j_l2d, j_wsd, j_wse = jax_int8.sym_scan_segment(
        *jargs, jnp.float32(RSQ), jnp.int32(0), block_size=B,
        right_k=e["right_k"], n_samples=e["n"], n_scan_blocks=m_pad // B,
        has_missing=e["has_missing"])
    jax_out = jax_xla.finalize_outputs(j_l2, j_l2d, j_ws, j_wsd, j_wse, j_poi,
                                       pre["usable"], pre["add_sd_zero"])
    pallas_out = jax_pallas.ld_scores_pallas_int8_sym(
        *jargs, rsq_thr=RSQ, block_size=B, right_k=e["right_k"],
        n_samples=e["n"], sample_chunk=128, interpret=True,
        has_missing=e["has_missing"])

    inp, args = _port_args(e)
    assert ld_int8.band_extent(inp["hi"], B)[1] == e["right_k"]
    twin = ld_int8.sym_scan_segment(
        *args, RSQ, 0, block_size=B, right_k=e["right_k"], n_samples=e["n"],
        n_scan_blocks=m_pad // B, has_missing=e["has_missing"])
    ours = _finalized(twin, inp)
    _assert_same(ours, jax_out, g.shape[0])
    _assert_same(ours, pallas_out, g.shape[0])


def _emulate_kernel(args, rsq, n_samples, has_missing):
    """The kernel's tiling on the CPU: per (pivot tile, band slot) row and
    column partials in the kernel's output layout, with the tile of the
    branch that runs, then its fold."""
    g, m, h, scal, lo, hi, usable, dom_ok, poison = args
    T = ld_pallas_sym.tile(has_missing)
    nt = g.shape[0] // T
    tile_hi, band = ld_int8.band_extent(hi, T)
    fpart = torch.zeros((nt, band, 2, 2, T))
    ipart = torch.zeros((nt, band, 2, 4, T), dtype=torch.int32)
    adj_c = ld_int8.adj_constant(n_samples)
    for b in range(nt):
        for k in range(band):
            t = b + k
            if t >= nt or t > int(tile_hi[b]):
                continue
            ri, rj = slice(b * T, b * T + T), slice(t * T, t * T + T)
            dots = {"sgg": ld_int8.idot(g[ri], g[rj]),
                    "sgh": ld_int8.idot(g[ri], h[rj]),
                    "shg": ld_int8.idot(h[ri], g[rj])}
            if has_missing:
                dots.update(sgm=ld_int8.idot(g[ri], m[rj]),
                            smg=ld_int8.idot(m[ri], g[rj]),
                            smm=ld_int8.idot(m[ri], m[rj]),
                            smh=ld_int8.idot(m[ri], h[rj]),
                            shm=ld_int8.idot(h[ri], m[rj]))
            r_add, r_da, r_db = ld_int8.corr_from_dots(
                dots, ld_int8.scal_views(scal[ri], "col"),
                ld_int8.scal_views(scal[rj], "row"), float(n_samples),
                float(g.shape[1]), has_missing, symmetric=True)
            adj_add, adj_da, adj_db = (ld_int8.adj_r2(r, adj_c)
                                       for r in (r_add, r_da, r_db))
            gi = torch.arange(b * T, b * T + T)[:, None]
            gj = torch.arange(t * T, t * T + T)[None, :]
            upair = ((gj >= lo[ri][:, None]) & (gj <= hi[ri][:, None])
                     & usable[ri][:, None] & usable[rj][None, :])
            row_base = upair & (gj != gi)
            col_base = upair & (t > b)
            dm_a = row_base & dom_ok[rj][None, :]
            dm_b = col_base & dom_ok[ri][:, None]
            fpart[b, k, 0, 0] = (adj_add * row_base).sum(1)
            fpart[b, k, 0, 1] = (adj_da * dm_a).sum(1)
            fpart[b, k, 1, 0] = (adj_add * col_base).sum(0)
            fpart[b, k, 1, 1] = (adj_db * dm_b).sum(0)
            ipart[b, k, 0] = torch.stack([
                row_base.sum(1), dm_a.sum(1), ((adj_da > rsq) & dm_a).sum(1),
                (upair & poison[rj][None, :]).sum(1)])
            ipart[b, k, 1] = torch.stack([
                col_base.sum(0), dm_b.sum(0), ((adj_db > rsq) & dm_b).sum(0),
                (col_base & poison[ri][:, None]).sum(0)])
    return ld_pallas_sym._fold(fpart, ipart)


# data case and window (bp) of the emulation: the clean cases run the
# 128-row tile, the others the 64-row tile; a window narrower than the
# SNP spacing gives a band of one tile, a window wider than the panel a
# band that spans every row
TILING_CASES = {
    "clean": ("clean", 9000.0),
    "missing": ("missing", 9000.0),
    "edge_clamp": ("edge_clamp", 9000.0),
    "clean_one_tile_band": ("clean", 100.0),
    "missing_one_tile_band": ("missing", 100.0),
    "clean_all_rows": ("clean", 1e9),
    "missing_all_rows": ("missing", 1e9),
}


@pytest.mark.parametrize("case", list(TILING_CASES))
def test_kernel_tiling_and_fold_match_twin(rng, case):
    data, wind = TILING_CASES[case]
    g, pos, _ = _case(rng, data)
    e = _engine_inputs(g, pos, ld_pallas_sym.ROW_ALIGN, wind=wind)
    inp, args = _port_args(e)
    T = ld_pallas_sym.tile(e["has_missing"])
    band = ld_int8.band_extent(inp["hi"], T)[1]
    if case.endswith("one_tile_band"):
        assert band == 1
    if case.endswith("all_rows"):                 # every tile of real rows
        assert band == -(-g.shape[0] // T) > 1
    emu = _emulate_kernel(args, ld_int8.f32(RSQ), e["n"], e["has_missing"])
    twin = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=e["n"],
                                     has_missing=e["has_missing"],
                                     block_size=T)
    for a, b in zip(_finalized(emu, inp)[2:], _finalized(twin, inp)[2:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_finalized(emu, inp)[:2], _finalized(twin, inp)[:2]):
        np.testing.assert_allclose(a, b, **TOL)


def test_cpu_wrapper_runs_twin_without_launch(rng):
    g, pos, B = _case(rng, "missing")
    e = _engine_inputs(g, pos, B)
    inp, args = _port_args(e)
    before = ld_pallas_sym.launches
    out = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=e["n"],
                                    has_missing=True, block_size=B)
    assert ld_pallas_sym.launches == before
    assert all(x.device.type == "cpu" for x in out)
