"""The hand-written CUDA LD kernel against its plain PyTorch twin.

Needs a CUDA device (``gpu`` marker): every test skips without one.  The
file imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_kernel.py
"""

import zlib

import numpy as np
import pytest
import torch

from nldsc_tpu_torch.ld import (ld_int8, ld_pallas_sym, ld_split, preprocess,
                                windows)
from nldsc_tpu_torch.io.plink import encode_bed_bytes
from nldsc_tpu_torch.ld.ld_xla import finalize_outputs
from nldsc_tpu_torch.ld.pipeline import padded_shape

from utils import adversarial_genotypes, make_positions, random_genotypes

RSQ = 1e-3
# kernel and twin round every float32 operation alike: pair values are
# bitwise equal, only the row/column sums run in another order
TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=True)

# (m, n, missing_rate, spacing bp, window bp); the clean branch's ring
# holds 3 stages of 128 samples, the missing branch's 4
CASES = {
    "clean": (300, 203, 0.0, 800, 6000.0),
    "missing": (300, 203, 0.05, 800, 6000.0),
    "edge_clamp": (150, 150, 0.02, 100, 1e6),
    "multi_tile_band": (700, 389, 0.02, 100, 20000.0),
    "single_stage_clean": (200, 100, 0.0, 100, 5000.0),       # N_pad = 128
    "single_stage_missing": (200, 100, 0.02, 100, 5000.0),
    "ring_wrap_clean": (260, 600, 0.0, 100, 8000.0),   # 5 stages: 3 ∤ 5
    "ring_wrap_missing": (260, 600, 0.02, 100, 8000.0),        # 4 ∤ 5
    "clean_multi_tile_band": (700, 389, 0.0, 100, 30000.0),
    # 16 pivot blocks of 128 rows: the 16 segments of a pass with progress
    "segments_clean": (2048, 203, 0.0, 100, 30000.0),
    "segments_missing": (2048, 203, 0.02, 100, 30000.0),
    # UK Biobank width (N_pad 315,648): 2,466 ring stages of 128 samples
    "wide_clean": (256, 315_599, 0.0, 100, 5000.0),
    "wide_missing": (256, 315_599, 0.02, 100, 5000.0),
    # the narrowest rows that run in 2 x 2 clusters (N_pad 131,072 clean:
    # 1,024 ring stages; 32,768 with missing genotypes: 256): 5 clean
    # tiles (odd), 10 of 64 rows, bands of 3-5 tiles; and the 16 segments
    "cluster_clean": (600, 131_001, 0.0, 100, 30000.0),
    "cluster_missing": (600, 32_701, 0.05, 100, 20000.0),
    "cluster_segments_clean": (2048, 131_001, 0.0, 100, 30000.0),
    "cluster_segments_missing": (2048, 32_701, 0.02, 100, 30000.0),
}


@pytest.fixture()
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def engine_args(rng, case, device):
    """Unpacked, preprocessed engine inputs for one case, on ``device``."""
    m, n, rate, spacing, wind = CASES[case]
    g = random_genotypes(rng, m, n, missing_rate=rate)
    adv = adversarial_genotypes(rng, n)
    g[10:15] = adv[:5]
    if rate > 0:
        g[20] = adv[5]
        g[30] = -1
    pos = make_positions(m, spacing=spacing, jitter_rng=rng, skip_idx=(3,))
    m_pad, n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)
    lo, hi, pos_ok = windows.window_bounds(pos, wind)
    raw = np.full((m_pad, (n + 3) // 4), 0x55 if rate else 0, np.uint8)
    raw[:m] = encode_bed_bytes(g)
    gd = preprocess.unpack_bed(torch.from_numpy(raw).to(device), n, n_pad,
                               -1 if rate else 0)
    ok = np.zeros(m_pad, bool)
    ok[:m] = pos_ok
    pre = ld_int8.preprocess_int8(gd, torch.from_numpy(ok).to(device), 0.01,
                                  n, assume_no_missing=rate == 0)
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            torch.from_numpy(lo_p).to(device),
            torch.from_numpy(hi_p).to(device), pre["usable"], dom_ok,
            pre["add_sd_zero"])
    return args, n, rate > 0, m


def finalized(credits, args):
    l2, ws, poi, l2d, wsd, wse = credits
    return [x.cpu().numpy() for x in finalize_outputs(
        l2, l2d, ws, wsd, wse, poi, args[6], args[8])]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_twin(rng, cuda, case):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    before = ld_pallas_sym.launches
    kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                     has_missing=has_missing, block_size=T)
    again = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                      has_missing=has_missing, block_size=T)
    torch.cuda.synchronize()
    assert ld_pallas_sym.launches == before + 2
    for a, b in zip(kern, again):
        assert torch.equal(a, b)                 # bitwise run to run
    twin = ld_int8.sym_scan_segment(
        *args, RSQ, 0, block_size=T,
        right_k=ld_int8.band_extent(args[5], T)[1], n_samples=n,
        n_scan_blocks=args[0].shape[0] // T, has_missing=has_missing)
    ours, ref = finalized(kern, args), finalized(twin, args)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(ours[1][:m]).sum() > m // 2      # l2d of usable rows


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["segments_clean", "segments_missing",
                                  "cluster_segments_clean",
                                  "cluster_segments_missing"])
def test_segments_fold_once_to_one_launch(rng, cuda, case):
    # the pass with progress: K1 once per segment (its halo tiles' CTAs
    # exit at once), a fence and a tick after each, one fold over all the
    # segments' partials: bitwise one launch
    args, n, has_missing, m = engine_args(rng, case, cuda)
    kw = dict(n_samples=n, has_missing=has_missing)
    ticks = []
    before = ld_pallas_sym.launches
    seg = ld_pallas_sym.sym_credits_segmented(
        *args, RSQ, block_size=128, n_rows=m,
        progress=lambda done, total: ticks.append((done, total)), **kw)
    assert ld_pallas_sym.launches == before + 16
    assert ticks == [(128 * i, m) for i in range(17)]
    one = ld_pallas_sym.sym_credits(
        *args, RSQ, block_size=ld_pallas_sym.tile(has_missing), **kw)
    for a, b in zip(seg, one):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case, pivot_rows", [("clean", 128),
                                              ("missing", 192),
                                              ("multi_tile_band", 256),
                                              ("multi_tile_band", 320),
                                              ("clean_multi_tile_band", 384),
                                              ("cluster_clean", 256),
                                              ("cluster_clean", 384),
                                              ("cluster_missing", 192),
                                              ("cluster_missing", 256)])
def test_kernel_band_matches_twin_over_pivots(rng, cuda, case, pivot_rows):
    # a streaming band: pivots, then halo rows that are neighbours only
    # (their windows emptied, their tiles' CTAs exit at once)
    args, n, has_missing, _ = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    before = ld_pallas_sym.launches
    kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                     has_missing=has_missing, block_size=T,
                                     pivot_rows=pivot_rows)
    torch.cuda.synchronize()
    assert ld_pallas_sym.launches == before + 1
    twin = ld_int8.sym_scan_segment(
        *args, RSQ, 0, block_size=T,
        right_k=ld_int8.band_extent(args[5], T)[1], n_samples=n,
        n_scan_blocks=pivot_rows // T, has_missing=has_missing)
    ours, ref = finalized(kern, args), finalized(twin, args)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    assert int(kern[1][pivot_rows:].sum()) > 0   # the halo's column credits


# the kernel's 2 x 2 clusters: ranges of pivot tiles that start at odd
# tiles and hold odd counts (a cluster's second pivot tile past n_piv),
# put together into one set of partials, are bitwise one launch's
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clean", "missing", "multi_tile_band",
                                  "clean_multi_tile_band",
                                  "segments_missing", "cluster_clean",
                                  "cluster_missing",
                                  "cluster_segments_missing"])
def test_odd_ranges_equal_one_launch(rng, cuda, case):
    args, n, has_missing, _ = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    nt = args[0].shape[0] // T
    band = ld_int8.band_extent(args[5], T)[1]
    kw = dict(n_samples=n, has_missing=has_missing, band=band,
              block_size=T)
    one = ld_pallas_sym.sym_partials(*args, RSQ, **kw)
    cuts = sorted({0, *(x for x in (1, 2, 5, 8, 11) if x < nt), nt})
    parts = ld_pallas_sym.new_partials(nt, band, T, 0, cuda)
    for x0, x1 in zip(cuts, cuts[1:]):
        ld_pallas_sym.range_partials(*args, RSQ, x0, x1,
                                     out=tuple(None if x is None else
                                               x[x0:x1] for x in parts),
                                     **kw)
    torch.cuda.synchronize()
    assert nt % 2 or len(cuts) > 2
    for a, b in zip(parts[:2], one[:2]):
        assert torch.equal(a, b)


# pivot tiles whose bands end one or two tiles apart from their cluster
# pair's: tile x's rows reach the end of tile x + reach(x)
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clean_multi_tile_band",
                                  "multi_tile_band", "cluster_clean",
                                  "cluster_missing"])
@pytest.mark.parametrize("stagger", ["one_before", "two_before",
                                     "odd_short"])
def test_kernel_staggered_pair_bands_match_twin(rng, cuda, case, stagger):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    reach = {"one_before": lambda x: 1 + x % 2,
             "two_before": lambda x: 1 + 2 * (x % 2),
             "odd_short": lambda x: 2 - 2 * (x % 2)}[stagger]
    hi = args[5].cpu().numpy().copy()
    rows = np.arange(len(hi))
    ends = np.array([T * (r // T + 1 + reach(r // T)) - 1 for r in rows])
    hi[:m] = np.minimum(ends[:m], m - 1)
    args = args[:5] + (torch.from_numpy(hi).to(cuda),) + args[6:]
    tile_hi = ld_int8.block_hi(args[5], T).tolist()
    assert any(tile_hi[x] != tile_hi[x + 1] - 1
               for x in range(0, len(tile_hi) - 1, 2) if tile_hi[x + 1] >= 0)
    kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                     has_missing=has_missing, block_size=T)
    twin = ld_int8.sym_scan_segment(
        *args, RSQ, 0, block_size=T,
        right_k=ld_int8.band_extent(args[5], T)[1], n_samples=n,
        n_scan_blocks=args[0].shape[0] // T, has_missing=has_missing)
    ours, ref = finalized(kern, args), finalized(twin, args)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)


# a launch's unfolded partials, slot for slot in the layout the fold reads
# ([n_tiles][band][row, col][...][T]), against the twin's: the counters
# equal, the sums within TOL, and every slot the twin leaves zero (past a
# tile's band, the pivot tile's column credits) exactly zero
@pytest.mark.gpu
@pytest.mark.parametrize("p", [0, 5])
@pytest.mark.parametrize("case", ["clean", "missing", "edge_clamp",
                                  "multi_tile_band", "clean_multi_tile_band",
                                  "cluster_clean", "cluster_missing"])
def test_kernel_partials_equal_the_twins_slot_for_slot(rng, cuda, case, p):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    band = ld_int8.band_extent(args[5], T)[1] + 1    # one slot past all
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda) if p else None
    kern = ld_pallas_sym.sym_partials(
        *args, RSQ, n_samples=n, has_missing=has_missing, band=band,
        block_size=T, annot=annot)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        twin = ld_int8.sym_tile_partials(
            *args, RSQ, annot, tile=T, band=band, n_samples=n,
            has_missing=has_missing)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(kern[1], twin[1])
    for a, b in zip((kern[0], kern[2]), (twin[0], twin[2])):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape
        assert bool((a[b == 0] == 0).all()), "a slot the twin leaves zero"
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    assert bool((kern[1][:, -1] == 0).all()) and bool(
        (kern[0][:, -1] == 0).all())


def seeded_annot(rng, m_pad, m, p, device):
    """float32 (m_pad, p) annotations: all ones, binary, continuous; zero
    rows for the padding."""
    a = np.zeros((m_pad, p), np.float32)
    a[:m] = rng.random((m, p), dtype=np.float32)
    a[:m, 0] = 1.0
    a[:m, 1:2] = a[:m, 1:2] < 0.3
    return torch.from_numpy(a).to(device)


def twin_annot(args, n, has_missing, T, annot, scan_rows=None):
    rows = args[0].shape[0] if scan_rows is None else scan_rows
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return ld_int8.sym_scan_segment(
            *args, RSQ, 0, annot, block_size=T,
            right_k=ld_int8.band_extent(args[5], T)[1], n_samples=n,
            n_scan_blocks=rows // T, has_missing=has_missing)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# p = 37 spans two chunks of 32 annotations, 64 two whole ones, 97 four
# (the last 8 wide) and nearly all the row credits a clean launch keeps,
# 130 two clean launches a call (groups of annot_max annotations); the
# cases cover one and both staged halves and several band slots of both
# branches
@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 5, 37, 64, 97, 130])
@pytest.mark.parametrize("case", ["clean", "missing", "multi_tile_band",
                                  "clean_multi_tile_band", "edge_clamp",
                                  "ring_wrap_clean", "cluster_clean",
                                  "cluster_missing"])
def test_kernel_annot_matches_twin(rng, cuda, case, p):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda)
    kw = dict(n_samples=n, has_missing=has_missing, block_size=T)
    plain = ld_pallas_sym.sym_credits(*args, RSQ, **kw)
    before = (ld_pallas_sym.launches, ld_pallas_sym.annot_launches)
    kern = ld_pallas_sym.sym_credits(*args, RSQ, annot=annot, **kw)
    again = ld_pallas_sym.sym_credits(*args, RSQ, annot=annot, **kw)
    torch.cuda.synchronize()
    per_call = -(-p // ld_pallas_sym.annot_max(has_missing))
    assert (ld_pallas_sym.launches, ld_pallas_sym.annot_launches) == (
        before[0] + 2 * per_call, before[1] + 2 * per_call)
    assert len(kern) == 8
    for a, b in zip(kern, again):
        assert torch.equal(a, b)                 # bitwise run to run
    for a, b in zip(kern[:6], plain):
        assert torch.equal(a, b)     # the plain credits of a plain launch
    twin = twin_annot(args, n, has_missing, T, annot)
    for a, b in zip(kern[6:], twin[6:]):
        assert tuple(a.shape) == (args[0].shape[0], p)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    assert float(kern[6].abs().max()) > 0 and float(kern[7].abs().max()) > 0
    if p == 1:       # all ones: the plain score sums
        for a, b in zip((kern[6][:, 0], kern[7][:, 0]), (kern[0], kern[3])):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["segments_clean", "segments_missing"])
def test_segmented_annot_pass_allocates_one_partials_buffer(rng, cuda, case):
    # the 16 segments write into one set of whole-pass partials, zero-filled
    # once: no buffer per segment, no copy; bitwise one launch
    args, n, has_missing, m = engine_args(rng, case, cuda)
    p = 37
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda)
    kw = dict(n_samples=n, has_missing=has_missing, annot=annot)
    T = ld_pallas_sym.tile(has_missing)
    one = ld_pallas_sym.sym_credits(*args, RSQ, block_size=T, **kw)
    ticks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    before = (ld_pallas_sym.partials_allocs, ld_pallas_sym.launches)
    seg = ld_pallas_sym.sym_credits_segmented(
        *args, RSQ, block_size=128, n_rows=m,
        progress=lambda done, total: ticks.append((done, total)), **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - mem0
    assert (ld_pallas_sym.partials_allocs, ld_pallas_sym.launches) == (
        before[0] + 1, before[1] + 16)
    assert ticks == [(128 * i, m) for i in range(17)]
    for a, b in zip(seg, one):
        assert torch.equal(a, b)
    m_pad = args[0].shape[0]
    band = ld_int8.band_extent(args[5], T)[1]
    parts = (m_pad // T) * band * T * (2 * 2 + 2 * 4 + 2 * 2 * p) * 4
    # the whole pass's partials, the folded vectors and the fold's sums
    # per tile: less than one more segment's partials
    outs = m_pad * (6 + 2 * p) * 4
    assert peak <= parts + 3 * outs, (peak, parts, outs)


# new_partials leaves the annotation partials unfilled: a launch must write
# every slot of its pivot tiles (zeros past the windows and in the diagonal
# tile's column slots included) and nothing past them.  Annotation partials
# filled with NaN must come out bitwise as zero-filled ones; p = 130 is two
# clean launches, the ranges cover fewer pivot tiles than the launch's rows
@pytest.mark.gpu
@pytest.mark.parametrize("p", [5, 37, 130])
@pytest.mark.parametrize("case", ["clean", "missing", "multi_tile_band",
                                  "clean_multi_tile_band"])
def test_kernel_writes_every_annot_partial_slot(rng, cuda, case, p):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda)
    nt = args[0].shape[0] // T
    band = ld_int8.band_extent(args[5], T)[1]
    kw = dict(n_samples=n, has_missing=has_missing, band=band,
              block_size=T, annot=annot)

    def parts_with(fill):
        # the plain partials zero-filled, as new_partials gives them
        parts = ld_pallas_sym.new_partials(nt, band, T, p, cuda)
        parts[2].fill_(fill)
        return parts

    ref = ld_pallas_sym.sym_partials(*args, RSQ, out=parts_with(0.0), **kw)
    got = ld_pallas_sym.sym_partials(*args, RSQ,
                                     out=parts_with(float("nan")), **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(got[2]).any(), "annotation slots left unwritten"
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # pivot tiles [0, x1) into a whole pass's partials whose later tiles
    # hold sentinels, then [x1, nt)
    x1 = max(1, nt // 2)
    parts = parts_with(float("nan"))
    parts[0][x1:] = float("nan")
    parts[1][x1:] = -7
    ld_pallas_sym.range_partials(*args, RSQ, 0, x1, out=parts, **kw)
    torch.cuda.synchronize()
    assert torch.isnan(parts[0][x1:]).all(), "plain partials past n_piv"
    assert bool((parts[1][x1:] == -7).all()), "counters past n_piv"
    assert torch.isnan(parts[2][x1:]).all(), "annotation partials past n_piv"
    for a, b in zip(parts, ref):
        assert torch.equal(a[:x1], b[:x1])
    parts[0][x1:], parts[1][x1:] = 0.0, 0
    ld_pallas_sym.range_partials(*args, RSQ, x1, nt,
                                 out=tuple(x[x1:] for x in parts), **kw)
    for a, b in zip(parts, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case, pivot_rows", [("clean", 128),
                                              ("multi_tile_band", 256)])
def test_kernel_annot_band_matches_twin_over_pivots(rng, cuda, case,
                                                    pivot_rows):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    annot = seeded_annot(rng, args[0].shape[0], m, 5, cuda)
    kern = ld_pallas_sym.sym_credits(
        *args, RSQ, n_samples=n, has_missing=has_missing, block_size=T,
        pivot_rows=pivot_rows, annot=annot)
    torch.cuda.synchronize()
    lo, hi = args[4].clone(), args[5].clone()
    lo[pivot_rows:], hi[pivot_rows:] = args[0].shape[0], -1
    twin = twin_annot(args[:4] + (lo, hi) + args[6:], n, has_missing, T,
                      annot, scan_rows=pivot_rows)
    for a, b in zip(kern[6:], twin[6:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    # halo rows earn column credits, weighted by their pivots' annotations
    assert float(kern[6][pivot_rows:].abs().max()) > 0


@pytest.mark.gpu
def test_kernel_rejects_bad_annot(rng, cuda):
    args, n, _, m = engine_args(rng, "clean", cuda)
    annot = seeded_annot(rng, args[0].shape[0], m, 3, cuda)
    kw = dict(n_samples=n, has_missing=False, block_size=128)
    for bad in (annot.double(), annot[:-1], annot.t().contiguous().t(),
                annot.cpu(), annot[:, :0]):
        with pytest.raises(ValueError, match="annot"):
            ld_pallas_sym.sym_credits(*args, RSQ, annot=bad, **kw)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(rng, cuda):
    args, n, _, _ = engine_args(rng, "clean", cuda)
    bad = (args[0][:, :-64].contiguous(),) + args[1:]
    with pytest.raises(ValueError):
        ld_pallas_sym.sym_credits(*bad, RSQ, n_samples=n, has_missing=False,
                                  block_size=64)


@pytest.mark.gpu
@pytest.mark.parametrize("has_missing", [False, True])
def test_refused_launch_raises(rng, cuda, monkeypatch, has_missing):
    # operands one byte off the 16-byte alignment TMA needs, past the
    # wrapper's own checks: the launcher's tensor-map encoding refuses
    # them, and its error code reaches the caller as an exception
    args, n, _, _ = engine_args(rng, "missing", cuda)
    m_pad, n_pad = args[0].shape
    flat = torch.zeros(m_pad * n_pad + 16, dtype=torch.int8, device=cuda)
    off = flat[1:1 + m_pad * n_pad].view(m_pad, n_pad)
    assert off.data_ptr() % 16
    monkeypatch.setattr(ld_pallas_sym, "_check_inputs", lambda *a: None)
    before = ld_pallas_sym.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ld_pallas_sym.sym_credits(off, off, off, *args[3:], RSQ, n_samples=n,
                                  has_missing=has_missing, block_size=64)
    assert ld_pallas_sym.launches == before


def bf16_args(args):
    """``args`` with g, m, h as bf16 operands (aliases kept)."""
    ops = dict(zip("gmh", args[:3]))
    ld_int8.to_operands(ops, "bf16")
    return (ops["g"], ops["m"], ops["h"], *args[3:])


# K1's four bf16 instantiations (clean and 8-product, with and without the
# annotation epilogue) hold the int8 sums exactly: bitwise equal outputs
@pytest.mark.gpu
@pytest.mark.parametrize("p", [0, 37])
@pytest.mark.parametrize("case", ["clean", "missing", "ring_wrap_clean",
                                  "ring_wrap_missing", "single_stage_clean",
                                  "multi_tile_band", "cluster_clean",
                                  "cluster_missing"])
def test_bf16_instantiations_equal_int8(rng, cuda, case, p):
    args, n, has_missing, m = engine_args(rng, case, cuda)
    T = ld_pallas_sym.tile(has_missing)
    annot = seeded_annot(rng, args[0].shape[0], m, p, cuda) if p else None
    kw = dict(n_samples=n, has_missing=has_missing, block_size=T,
              annot=annot)
    ref = ld_pallas_sym.sym_credits(*args, RSQ, **kw)
    before = (ld_pallas_sym.launches, ld_pallas_sym.bf16_launches)
    kern = ld_pallas_sym.sym_credits(*bf16_args(args), RSQ, **kw)
    torch.cuda.synchronize()
    assert (ld_pallas_sym.launches, ld_pallas_sym.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    assert len(kern) == len(ref)
    for a, b in zip(kern, ref):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_launch_needs_bf16_operands(rng, cuda):
    args, n, _, _ = engine_args(rng, "clean", cuda)
    kw = dict(n_samples=n, has_missing=False, block_size=128)
    b = bf16_args(args)
    # g picks the instantiation; an h of another type is refused
    with pytest.raises(ValueError, match="bfloat16"):
        ld_pallas_sym.sym_credits(b[0], args[1], args[2], *args[3:], RSQ,
                                  **kw)
    with pytest.raises(ValueError, match="int8 or bf16"):
        ld_pallas_sym.sym_credits(*(x.half() for x in b[:3]), *args[3:],
                                  RSQ, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric, annot", [(True, False), (False, False),
                                              (None, True)])
def test_f32_engine_on_cuda_matches_cpu(rng, cuda, symmetric, annot):
    # float32 products in another order on the card: the golden
    # tolerances for the scores, the window counts equal
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores

    g = random_genotypes(rng, 700, 389, missing_rate=0.02)
    pos = make_positions(700, spacing=100, jitter_rng=rng)
    a = (np.column_stack([np.ones(700), rng.random(700)]) if annot
         else None)
    cfg = LDConfig(ld_wind=20000.0, maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=RSQ, block_size=64, use_int8=False,
                   symmetric=symmetric)
    ours = compute_ld_scores(g, pos, cfg, annot=a, device="cuda")
    ref = compute_ld_scores(g, pos, cfg, annot=a, device="cpu")
    for k in ("l2", "l2d") + (("l2_annot", "l2d_annot") if annot else ()):
        np.testing.assert_allclose(ours[k], ref[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)
    for k in ("l2_ws", "l2d_ws"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert (ours["l2d_wse"] != ref["l2d_wse"]).sum() <= 3


@pytest.mark.gpu
def test_launches_run_on_the_tensors_device(rng):
    # K1 and K2 on cuda:1 while cuda:0 is current give what the same
    # launches give on cuda:0: the wrappers make the tensors' device
    # current for the attribute call, the tensor maps and the launch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from test_torch_split_kernel import split_inputs

    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    state = rng.bit_generator.state
    runs = {}
    for dev in (d0, d1):
        rng.bit_generator.state = state
        args, n, has_missing, _ = engine_args(rng, "missing", dev)
        sargs, sn, _, _ = split_inputs(rng, 700, 389, 256, dev)
        with torch.cuda.device(d0):
            before = dict(ld_pallas_sym.device_launches)
            k1 = ld_pallas_sym.sym_credits(
                *args, RSQ, n_samples=n, has_missing=has_missing,
                block_size=ld_pallas_sym.tile(has_missing))
            k2 = ld_split.split_corrections(*sargs, n_samples=sn)
        torch.cuda.synchronize(dev)
        assert (ld_pallas_sym.device_launches[str(dev)]
                == before.get(str(dev), 0) + 1)
        runs[dev] = [x.cpu() for x in (*k1, *k2)]
    for a, b in zip(runs[d0], runs[d1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["clean", "missing", "multi_tile_band"])
def test_sharded_kernel_runs_equal_the_incore_run(rng, cuda, monkeypatch,
                                                  case):
    # K1 once per SNP shard (shards placed round-robin on the visible
    # devices), the partials folded once in tile order: bitwise the
    # in-core kernel run, on any shard count
    from functools import partial

    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores
    from nldsc_tpu_torch.parallel import ld_scores_sharded, snp_devices

    m, n, rate, spacing, wind = CASES[case]
    g = random_genotypes(rng, 2 * m, n, missing_rate=rate)
    pos = make_positions(2 * m, spacing=spacing, jitter_rng=rng)
    cfg = LDConfig(ld_wind=wind, maf_thr=0.01, std_thr=1e-4, rsq_thr=RSQ,
                   block_size=128, split_missing=False)
    # the in-core run with its valid counts taken at run time, as the SNP
    # shards take them (on clean data the in-core preprocess, as the JAX
    # package's, divides by the constant n as a product by f32(1/n))
    with monkeypatch.context() as mp:
        mp.setattr(ld_int8, "preprocess_int8", partial(
            ld_int8.preprocess_int8, constant_n_valid=False))
        incore = compute_ld_scores(g, pos, cfg, device="cuda")
    for d in (1, 2, 4):
        before = ld_pallas_sym.launches
        res = ld_scores_sharded(g, pos, cfg,
                                snp_devices(d, "cuda", share=True))
        assert ld_pallas_sym.launches == before + d
        for k, v in res.items():
            np.testing.assert_array_equal(v, incore[k], err_msg=f"{k}@{d}")


@pytest.mark.gpu
@pytest.mark.parametrize("split", [None, False])
def test_incore_peak_within_the_streaming_rule_at_width(rng, cuda, split):
    # at UK Biobank width (N = 315,599) the in-core split and global
    # routes peak within the bytes per padded genotype that the
    # auto-streaming rule assumes: the unpack and the class counts go in
    # steps of a fixed number of genotypes, not rows (ROADMAP F5: steps of
    # 8,192 and 4,096 rows peaked at 7.25 bytes a genotype at M = 8,192)
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PackedBed, _miss_bytes
    from nldsc_tpu_torch.ld.pipeline import (INCORE_BYTES_PER_GENOTYPE,
                                             compute_ld_scores)

    m, n = 4096, 315_599
    raw = rng.integers(0, 256, (m, (n + 3) // 4), dtype=np.uint8)
    clean = np.ones(m, bool)
    clean[::50] = False                      # 2% of the rows contaminated
    raw[clean] &= ~_miss_bytes(raw[clean], n)
    pos = np.arange(1, m + 1, dtype=np.float64) * 100
    cfg = LDConfig(ld_wind=20000.0, maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=RSQ, split_missing=split)
    m_pad, n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = compute_ld_scores(PackedBed(raw, m, n, True), pos, cfg,
                            device="cuda")
    torch.cuda.synchronize()
    per = (torch.cuda.max_memory_allocated() - base) / (m_pad * n_pad)
    assert np.isfinite(out["l2"]).all()
    assert per <= INCORE_BYTES_PER_GENOTYPE["int8"], per
