"""Kernel K2 (the split-missing corrections, products and fused δ
epilogue) against its plain PyTorch versions.

Needs a CUDA device (``gpu`` marker): every test skips without one.  The
file imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_split_kernel.py
"""

import zlib

import numpy as np
import pytest
import torch

from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split, pipeline
from nldsc_tpu_torch.ld import windows

from test_torch_kernel import seeded_annot
from test_torch_split_plan import kernel_reach, seg_fields, windows_case
from utils import adversarial_genotypes, make_positions, random_genotypes

RSQ = 1e-3
# the fused kernel and the twin round every pair's float32 operations
# alike; only the order of the row and column sums differs
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def row_level_missing(rng, m, n, row_frac, entry_rate):
    """Genotypes where only ``row_frac`` of the SNPs carry missing entries."""
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    for r in rng.choice(m, size=max(1, int(m * row_frac)), replace=False):
        g[r] = np.where(rng.random(n) < entry_rate, np.int8(-1), g[r])
    adv = adversarial_genotypes(rng, n)
    g[10:16] = adv
    g[30] = -1                              # all missing: a poison row
    return g


def split_inputs(rng, m, n, seg_rows, device, wind=20000.0):
    """Port engine inputs, plan and compact indicators on ``device``."""
    g = row_level_missing(rng, m, n, 0.05, 0.2)
    pos = make_positions(m, spacing=100, jitter_rng=rng, skip_idx=(3,))
    m_pad, n_pad = pipeline.padded_shape(m, n, "cuda",
                                         ld_pallas_sym.ROW_ALIGN)
    gp = np.full((m_pad, n_pad), -1, np.int8)
    gp[:m, :n] = g
    lo, hi, pos_ok = windows.window_bounds(pos, wind)
    ok = np.zeros(m_pad, bool)
    ok[:m] = pos_ok
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    raw = torch.from_numpy(gp).to(device)
    pre = ld_int8.preprocess_int8(raw, torch.from_numpy(ok).to(device), 0.01,
                                  n, materialize_m=False)
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    rowmiss = (pre["cm"] > float(n_pad - n)) & pre["usable"]
    plan = ld_split.plan_split_v2(rowmiss.cpu().numpy(), lo_p, hi_p,
                                  min(seg_rows, m_pad), m_pad)
    m_c = ld_split.compact_missing_rows(raw, plan["miss_idx"])
    args = (pre["g"], m_c, pre["h"], ld_int8.stack_scalars(pre),
            torch.from_numpy(lo_p).to(device),
            torch.from_numpy(hi_p).to(device), pre["usable"], dom_ok,
            rowmiss, RSQ, m_pad, plan)
    return args, n, g, pos


@pytest.mark.gpu
@pytest.mark.parametrize("rows_x, rows_cat, p2, n_pad", [
    (8, 24, 0, 128), (200, 72, 48, 384), (64, 64, 64, 256),
    (300, 130, 100, 256)])
def test_corr_products_are_exact(rng, cuda, rows_x, rows_cat, p2, n_pad):
    x = rng.integers(0, 3, (rows_x, n_pad), dtype=np.int8)
    cat = rng.integers(0, 3, (rows_cat, n_pad), dtype=np.int8)
    before = ld_split.corr_launches
    a, b = ld_split.corr_products(torch.from_numpy(x).to(cuda),
                                  torch.from_numpy(cat).to(cuda), p2)
    torch.cuda.synchronize()
    assert ld_split.corr_launches == before + 1
    xi, ci = x.astype(np.int64), cat.astype(np.int64)
    np.testing.assert_array_equal(a.cpu().numpy(), xi @ ci.T)
    if p2:
        np.testing.assert_array_equal(b.cpu().numpy(),
                                      2 * np.minimum(xi, 1) @ ci[:p2].T)
    else:
        assert b is None


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, seg_rows, wind", [
    (700, 389, 256, 20000.0),     # 3 segments, the last one clamped
    (300, 203, 4096, 20000.0),    # 1 segment, P below one column tile
    (300, 101, 64, 20000.0),      # segments shorter than a tile, N_pad 128
    (1500, 389, 512, 60000.0),    # P = 80: three column tiles, ragged
    (3000, 203, 2048, 5000.0),    # narrow windows: most tiles skip
    (256, 315_599, 4096, 5000.0),  # UK Biobank width: N_pad 315,648
])
def test_split_corrections_kernel_matches_twin(rng, cuda, m, n, seg_rows,
                                               wind):
    args, n, _, _ = split_inputs(rng, m, n, seg_rows, cuda, wind)
    before = (ld_split.corr_launches, ld_split.fused_launches)
    kern = ld_split.split_corrections(*args, n_samples=n)
    again = ld_split.split_corrections(*args, n_samples=n)
    torch.cuda.synchronize()
    assert ld_split.corr_launches == before[0] + 4       # d, fused; twice
    assert ld_split.fused_launches == before[1] + 2
    for a, b in zip(kern, again):
        assert torch.equal(a, b)                   # bitwise run to run
    cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    twin = ld_split.split_corrections(*cpu, n_samples=n)
    np.testing.assert_array_equal(kern[2].cpu().numpy(), twin[2].numpy())
    for a, b in zip(kern[:2], twin[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **TOL)
    assert twin[0].abs().max() > 0


@pytest.mark.gpu
# one chunk of 8; a ragged last chunk; the baseline model's 53; more
# chunks than two in either direction
@pytest.mark.parametrize("p", [1, 8, 37, 53, 130])
@pytest.mark.parametrize("m, n, seg_rows, wind, own", [
    (700, 389, 256, 20000.0, None),   # 3 segments, the last one clamped
    (300, 101, 64, 20000.0, None),    # segments shorter than a tile
    (1500, 389, 512, 60000.0, 1024),  # three column tiles; a band's own_hi
    (3000, 203, 2048, 5000.0, None),  # narrow windows: most tiles skip
])
def test_split_corrections_annot_kernel_matches_twin(rng, cuda, m, n,
                                                     seg_rows, wind, own, p):
    args, n, _, _ = split_inputs(rng, m, n, seg_rows, cuda, wind)
    if own is not None:
        args = args[:10] + (own,) + args[11:]
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda)
    plain = ld_split.split_corrections(*args, n_samples=n)
    before = (ld_split.corr_launches, ld_split.fused_launches,
              ld_split.annot_launches)
    kern = ld_split.split_corrections(*args, annot, n_samples=n)
    again = ld_split.split_corrections(*args, annot, n_samples=n)
    torch.cuda.synchronize()
    assert (ld_split.corr_launches, ld_split.fused_launches,
            ld_split.annot_launches) == (before[0] + 4, before[1] + 2,
                                         before[2] + 2)
    assert len(kern) == 5
    for a, b in zip(kern, again):
        assert torch.equal(a, b)                   # bitwise run to run
    for a, b in zip(kern[:3], plain):
        assert torch.equal(a, b)       # the plain δ of a plain launch
    cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)
    twin = ld_split.split_corrections(*cpu, annot.cpu(), n_samples=n)
    for a, b in zip(kern[3:], twin[3:]):
        assert tuple(a.shape) == (args[0].shape[0], p)
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **TOL)
    assert twin[3].abs().max() > 0 and twin[4].abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, seg_rows, wind, skips", [
    (700, 389, 256, 20000.0, False),   # 3 segments, the last one clamped
    (3000, 203, 2048, 5000.0, True),   # narrow windows: tiles skip
])
def test_annot_partials_are_sized_by_live_tiles(rng, cuda, m, n, seg_rows,
                                               wind, skips):
    args, n, _, _ = split_inputs(rng, m, n, seg_rows, cuda, wind)
    p = 7
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda)
    torch.cuda.synchronize()
    ld_split.split_corrections(*args, annot, n_samples=n)
    torch.cuda.synchronize()
    plan, m_pad = args[-1], args[0].shape[0]
    live = kernel_reach(plan, args[4].cpu().numpy(), args[5].cpu().numpy(),
                        m_pad)
    assert ld_split.annot_tiles == int(live.sum())
    if skips:
        assert ld_split.annot_tiles < live.size
    assert ld_split.annot_partial_bytes == (
        ld_split.annot_tiles * 2 * (ld_split.TILE_X + ld_split.TILE_C)
        * ld_split.annot_ld(p) * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clamped last segment", "band own_hi",
                                  "narrow windows"])
def test_annot_reach_and_fold_kernels_equal_plain(rng, cuda, case):
    m_pad, S, rowmiss, lo, hi = windows_case(rng, case)
    plan = ld_split.plan_split_v2(rowmiss, lo, hi, S, m_pad)
    seg = seg_fields(plan, m_pad)
    host = (torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(plan["miss_idx"]))
    live = ld_split.live_tiles(seg, *host, S, plan["p_band"])
    before = ld_split.reach_launches
    on_card = ld_split.live_tiles(seg.to(cuda), *(t.to(cuda) for t in host),
                                  S, plan["p_band"])
    assert ld_split.reach_launches == before + 1
    assert torch.equal(on_card.cpu(), live)          # the kernel's own rule
    slot = ld_split.tile_slots(live)
    n_live, p = int(live.sum()), 37
    pld = ld_split.annot_ld(p)
    rpa = torch.from_numpy(rng.standard_normal(
        (n_live, 2, ld_split.TILE_X, pld)).astype(np.float32))
    cpa = torch.from_numpy(rng.standard_normal(
        (n_live, ld_split.TILE_C, 2, pld)).astype(np.float32))
    cidx = torch.from_numpy(plan["miss_idx"][:plan["n_miss"]])
    args = (rpa, cpa, slot, seg, cidx, S, m_pad, p)
    before = ld_split.fold_launches
    kern = ld_split.fold_annot(*(a.to(cuda) if torch.is_tensor(a) else a
                                 for a in args))
    torch.cuda.synchronize()
    assert ld_split.fold_launches == before + 1
    plain = ld_split.fold_annot(*args)          # CPU: the plain version
    for a, b in zip(kern, plain):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_annot_split_route_equals_global_on_card(rng, cuda):
    _, _, g, pos = split_inputs(rng, 700, 389, 4096, "cpu")
    annot = seeded_annot(rng, 700, 700, 5, "cpu").double().numpy()
    kw = dict(ld_wind=20000, maf_thr=0.01, std_thr=1e-4, rsq_thr=RSQ)
    before = (ld_pallas_sym.annot_launches, ld_split.annot_launches)
    split = pipeline.compute_ld_scores(g, pos, LDConfig(**kw), annot=annot,
                                       device=cuda)
    assert (ld_pallas_sym.annot_launches, ld_split.annot_launches) == (
        before[0] + 1, before[1] + 1)
    glob = pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw, split_missing=False), annot=annot, device=cuda)
    full = pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw, symmetric=False), annot=annot, device=cuda)
    assert (ld_pallas_sym.annot_launches, ld_split.annot_launches) == (
        before[0] + 2, before[1] + 1)        # the full-band engine: none
    for other in (glob, full):
        # the full-band engine evaluates a pair from either member's row,
        # in other float32 expressions: its threshold count is not held
        for k in ("l2_ws", "l2d_ws") + (("l2d_wse",) if other is glob else ()):
            np.testing.assert_array_equal(split[k], other[k], err_msg=k)
        for k in ("l2", "l2d"):
            np.testing.assert_allclose(split[k], other[k], equal_nan=True,
                                       err_msg=k, **TOL)
        # tests/test_annot.py:181-191: the δ sums cancel the clean pass's
        for k in ("l2_annot", "l2d_annot"):
            np.testing.assert_allclose(split[k], other[k], rtol=5e-5,
                                       atol=5e-4, equal_nan=True, err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("m, n, seg_rows, wind", [
    (300, 101, 64, 20000.0), (1500, 389, 512, 60000.0)])
def test_segment_products_are_exact(rng, cuda, m, n, seg_rows, wind):
    args, n, _, _ = split_inputs(rng, m, n, seg_rows, cuda, wind)
    g, m_c, h, plan = args[0], args[1], args[2], args[-1]
    P = plan["p_band"]
    before = ld_split.corr_launches
    a, b, d = ld_split.segment_products(g, m_c, h, plan)
    torch.cuda.synchronize()
    assert ld_split.corr_launches == before + 2
    for s, *_, x, cat3, m_xc in ld_split.segments(g.cpu(), m_c.cpu(),
                                                   h.cpu(), plan):
        xi, ci, mi = (t.numpy().astype(np.int64) for t in (x, cat3, m_xc))
        np.testing.assert_array_equal(a[s].cpu().numpy(), xi @ ci.T)
        np.testing.assert_array_equal(b[s].cpu().numpy(),
                                      2 * np.minimum(xi, 1) @ ci[:2 * P].T)
        np.testing.assert_array_equal(d[s].cpu().numpy(), mi @ ci.T)


@pytest.mark.gpu
def test_split_route_equals_global_on_card(rng, cuda):
    _, _, g, pos = split_inputs(rng, 700, 389, 4096, "cpu")
    kw = dict(ld_wind=20000, maf_thr=0.01, std_thr=1e-4, rsq_thr=RSQ)
    before = (ld_pallas_sym.launches, ld_split.fused_launches)
    split = pipeline.compute_ld_scores(g, pos, LDConfig(**kw), device=cuda)
    assert ld_split.fused_launches == before[1] + 1
    glob = pipeline.compute_ld_scores(
        g, pos, LDConfig(**kw, split_missing=False), device=cuda)
    assert ld_pallas_sym.launches == before[0] + 2
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(split[k], glob[k], err_msg=k)
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(split[k], glob[k], equal_nan=True,
                                   err_msg=k, **TOL)


@pytest.mark.gpu
def test_corr_products_rejects_bad_inputs(cuda):
    x = torch.zeros((8, 200), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ld_split.corr_products(x, x)
    x = torch.zeros((8, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ld_split.corr_products(x, x.float())


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["corr_products", "split_corrections"])
def test_refused_tensor_map_raises(rng, cuda, monkeypatch, entry):
    # int8 operands one byte off the 16-byte alignment TMA needs, past the
    # wrapper's own checks: the launcher's tensor-map encoding refuses
    # them (the x rows, or the compact indicators that the first launch
    # reads), and no launch is counted
    args, n, _, _ = split_inputs(rng, 300, 203, 4096, cuda)

    def misaligned(t):
        flat = torch.zeros(t.numel() + 16, dtype=torch.int8, device=cuda)
        off = flat[1:1 + t.numel()].view(t.shape)
        off.copy_(t)
        assert off.data_ptr() % 16
        return off

    monkeypatch.setattr(ld_split, "_check_operand", lambda *a: None)
    before = (ld_split.corr_launches, ld_split.fused_launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        if entry == "corr_products":
            ld_split.corr_products(misaligned(args[0]), args[0][:24], 16)
        else:
            ld_split.split_corrections(args[0], misaligned(args[1]),
                                       *args[2:], n_samples=n)
    assert (ld_split.corr_launches, ld_split.fused_launches) == before


def bf16(args):
    """``split_inputs``' arguments with g, m_c and h as bf16 operands."""
    ops = dict(zip(("g", "m_c", "h"), args[:3]))
    ld_int8.to_operands(ops, "bf16")
    return (ops["g"], ops["m_c"], ops["h"], *args[3:])


@pytest.mark.gpu
@pytest.mark.parametrize("rows_x, rows_cat, p2, n_pad", [
    (8, 24, 0, 128), (200, 72, 48, 384), (300, 130, 100, 256)])
def test_bf16_products_equal_int8(rng, cuda, rows_x, rows_cat, p2, n_pad):
    x = torch.from_numpy(rng.integers(0, 3, (rows_x, n_pad),
                                      dtype=np.int8)).to(cuda)
    cat = torch.from_numpy(rng.integers(0, 3, (rows_cat, n_pad),
                                        dtype=np.int8)).to(cuda)
    before = ld_split.bf16_launches
    a, b = ld_split.corr_products(x.to(torch.bfloat16),
                                  cat.to(torch.bfloat16), p2)
    a8, b8 = ld_split.corr_products(x, cat, p2)
    torch.cuda.synchronize()
    assert ld_split.bf16_launches == before + 1
    assert torch.equal(a, a8) and a.dtype == torch.int32
    assert (b is None and b8 is None) or torch.equal(b, b8)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0, 37, 53])
@pytest.mark.parametrize("m, n, seg_rows, wind", [
    (700, 389, 256, 20000.0), (300, 101, 64, 20000.0),
    (1500, 389, 512, 60000.0)])
def test_bf16_split_corrections_equal_int8(rng, cuda, m, n, seg_rows, wind,
                                           p):
    args, n, g, _ = split_inputs(rng, m, n, seg_rows, cuda, wind)
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda) if p else None
    ref = ld_split.split_corrections(*args, annot, n_samples=n)
    before = ld_split.bf16_launches
    kern = ld_split.split_corrections(*bf16(args), annot, n_samples=n)
    prods = ld_split.segment_products(*bf16(args)[:3], args[-1])
    torch.cuda.synchronize()
    assert ld_split.bf16_launches == before + 4          # d, fused; d, a/b
    for a, b in zip(kern, ref):
        assert torch.equal(a, b)
    for a, b in zip(prods, ld_split.segment_products(*args[:3], args[-1])):
        assert torch.equal(a, b)
