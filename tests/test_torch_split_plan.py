"""The split route's host-side tables: ``ld_split.segment_table`` (the
per-segment fields and x-row map that kernel K2 reads) and ``ld_split._fold``
(the fixed-order reduction of its partials), on the CPU.

The table is held against the per-segment quantities written out by hand:
the clamped first row, the plan's compact ranges, and the row of the
segment's compact indicators that holds each contaminated x row, built
with an explicit loop over segments.  No JAX is imported.
"""

import zlib

import numpy as np
import pytest
import torch

from nldsc_tpu_torch.ld import ld_split


@pytest.fixture()
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


def loop_drow(plan: dict, m_pad: int) -> np.ndarray:
    """Per segment, the row of ``m_c[x0:x0 + p_x]`` holding each x row."""
    S = plan["seg_rows"]
    drow = np.full((plan["n_segs"], S), -1, np.int32)
    for s in range(plan["n_segs"]):
        s0, x0, x_cnt = (min(s * S, m_pad - S), int(plan["xs"][s]),
                         int(plan["x_cnt"][s]))
        loc = plan["miss_idx"][x0:x0 + x_cnt] - s0
        ok = (loc >= 0) & (loc < S)
        drow[s, loc[ok]] = np.arange(x_cnt, dtype=np.int32)[ok]
    return drow


def make_plan(rng, m_pad: int, seg_rows: int, miss_rows, half_window=40):
    rowmiss = np.zeros(m_pad, bool)
    rowmiss[list(miss_rows)] = True
    rows = np.arange(m_pad)
    lo = np.maximum(rows - half_window - rng.integers(0, 5, m_pad), 0)
    hi = np.minimum(rows + half_window + rng.integers(0, 5, m_pad),
                    m_pad - 1)
    return ld_split.plan_split_v2(rowmiss, lo.astype(np.int32),
                                  hi.astype(np.int32), seg_rows, m_pad)


CASES = {
    # one segment over all rows
    "one segment": (256, 256, lambda r: r.choice(256, 20, replace=False)),
    # eight segments that tile the rows exactly
    "many segments": (1024, 128, lambda r: r.choice(1024, 90, replace=False)),
    # 640 rows in segments of 256: the last one starts at 384 (clamped),
    # overlapping the one before it, and owns rows 512 on
    "clamped last segment": (
        640, 256, lambda r: np.r_[r.choice(640, 40, replace=False), 400, 600]),
    # contaminated rows only in the first segment: the others own none
    "segments without contaminated rows": (
        512, 128, lambda r: r.choice(128, 12, replace=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_segment_table_matches_per_segment_loop(rng, case):
    m_pad, S, pick = CASES[case]
    plan = make_plan(rng, m_pad, S, np.unique(pick(rng)))
    tab = ld_split.segment_table(plan, m_pad)
    n_segs = plan["n_segs"]
    assert n_segs == -(-m_pad // S)
    for k in ("s0", "seg_lo", "c0", "c_cnt", "x0", "x_cnt", "drow"):
        assert tab[k].dtype == np.int32, k
    seg = np.arange(n_segs)
    np.testing.assert_array_equal(tab["seg_lo"], seg * S)
    np.testing.assert_array_equal(tab["s0"], np.minimum(seg * S, m_pad - S))
    for k, v in (("c0", "cs"), ("c_cnt", "c_cnt"), ("x0", "xs"),
                 ("x_cnt", "x_cnt")):
        np.testing.assert_array_equal(tab[k], plan[v], err_msg=k)
    np.testing.assert_array_equal(tab["drow"], loop_drow(plan, m_pad))

    # what the kernel relies on: each contaminated row a segment owns maps
    # to its own row of the segment's compact indicators, and nothing else
    miss = set(plan["miss_idx"][:plan["n_miss"]].tolist())
    for s in range(n_segs):
        s0, x0 = int(tab["s0"][s]), int(tab["x0"][s])
        for xl in range(S):
            gx, dr = s0 + xl, int(tab["drow"][s, xl])
            owned = gx >= tab["seg_lo"][s]
            if owned and gx in miss:
                assert 0 <= dr < plan["p_x"]
                assert plan["miss_idx"][x0 + dr] == gx
            else:
                assert dr == -1
    if case == "clamped last segment":
        assert tab["s0"][-1] < tab["seg_lo"][-1]
        # the overlap rows belong to the segment before: no entry here
        assert (tab["drow"][-1, :tab["seg_lo"][-1] - tab["s0"][-1]]
                == -1).all()
    if case == "segments without contaminated rows":
        assert (tab["x_cnt"][1:] == 0).all()
        assert (tab["drow"][1:] == -1).all()


def test_segment_table_refuses_segments_longer_than_rows(rng):
    plan = make_plan(rng, 128, 128, [3, 7])
    with pytest.raises(ValueError, match="segment rows"):
        ld_split.segment_table(plan, 64)


def test_fold_equals_per_segment_sums(rng):
    # integer-valued floats: every order of summation gives the same sum
    n_ct, n_segs, n_xt, P, m_pad, mm_pad = 3, 4, 2, 16, 96, 40
    rpf = torch.from_numpy(rng.integers(-50, 50, (n_ct, 2, m_pad))
                           .astype(np.float32))
    rpi = torch.from_numpy(rng.integers(-9, 9, (n_ct, m_pad)).astype(np.int32))
    cpf = torch.from_numpy(rng.integers(-50, 50, (n_segs, n_xt, 2, P))
                           .astype(np.float32))
    cpi = torch.from_numpy(rng.integers(-9, 9, (n_segs, n_xt, P))
                           .astype(np.int32))
    c0 = torch.tensor([0, 5, 5, mm_pad - P], dtype=torch.int32)  # overlaps
    (l2, l2d, wse), (l2_c, l2d_c, wse_c) = ld_split._fold(
        rpf, rpi, cpf, cpi, c0, mm_pad)
    np.testing.assert_array_equal(l2.numpy(), rpf[:, 0].sum(0).numpy())
    np.testing.assert_array_equal(l2d.numpy(), rpf[:, 1].sum(0).numpy())
    np.testing.assert_array_equal(wse.numpy(), rpi.sum(0).numpy())
    want = np.zeros((3, mm_pad), np.float64)
    for s in range(n_segs):
        cols = slice(int(c0[s]), int(c0[s]) + P)
        want[0, cols] += cpf[s, :, 0].sum(0).numpy()
        want[1, cols] += cpf[s, :, 1].sum(0).numpy()
        want[2, cols] += cpi[s].sum(0).numpy()
    for got, w in zip((l2_c, l2d_c, wse_c), want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert wse_c.dtype == torch.int32 and l2_c.dtype == torch.float32


def kernel_reach(plan: dict, lo, hi, m_pad: int) -> np.ndarray:
    """The fused launch's live tiles by brute force: ``split_corr.cu``'s
    ``reach`` evaluated for every thread of every CTA."""
    TM, TC = ld_split.TILE_X, ld_split.TILE_C
    S, P = plan["seg_rows"], plan["p_band"]
    tab = ld_split.segment_table(plan, m_pad)
    cidx = plan["miss_idx"]
    n_xt, n_ct = -(-S // TM), -(-P // TC)
    live = np.zeros((plan["n_segs"], n_xt, n_ct), bool)
    for s in range(plan["n_segs"]):
        a_row0, c0, c_cnt, seg_lo = (int(tab[k][s]) for k in (
            "s0", "c0", "c_cnt", "seg_lo"))
        for xt in range(n_xt):
            for ct in range(n_ct):
                cl0 = ct * TC
                c_end = min(cl0 + TC, c_cnt)
                for tid in range(TM):
                    xl = xt * TM + tid
                    gx = a_row0 + xl
                    if (cl0 < c_end and xl < S and gx >= seg_lo
                            and lo[gx] <= cidx[c0 + c_end - 1]
                            and hi[gx] >= cidx[c0 + cl0]):
                        live[s, xt, ct] = True
                        break
    return live


def windows_case(rng, case: str):
    """(m_pad, S, rowmiss, lo, hi) of one of the fused launch's layouts."""
    m_pad, S, half, own_hi = {
        # 640 rows in segments of 256: the last one clamped
        "clamped last segment": (640, 256, 60, None),
        # a band: rows past its pivots carry emptied windows (lo > hi)
        "band own_hi": (1024, 512, 90, 768),
        # narrow windows: most tiles no window reaches
        "narrow windows": (2048, 1024, 6, None),
    }[case]
    rows = np.arange(m_pad)
    rowmiss = rng.random(m_pad) < 0.3        # P spans several column tiles
    lo = np.maximum(rows - half - rng.integers(0, 5, m_pad), 0)
    hi = np.minimum(rows + half + rng.integers(0, 5, m_pad), m_pad - 1)
    if own_hi is not None:
        lo[own_hi:], hi[own_hi:] = m_pad, -1
    empty = rng.choice(m_pad, 8, replace=False)   # unusable rows
    lo[empty], hi[empty] = m_pad, -1
    return m_pad, S, rowmiss, lo.astype(np.int32), hi.astype(np.int32)


def seg_fields(plan: dict, m_pad: int) -> torch.Tensor:
    """The kernel's per-segment fields, as ``ld_split._operands`` makes
    them."""
    tab = ld_split.segment_table(plan, m_pad)
    return torch.from_numpy(np.stack(
        [tab["s0"], tab["c0"], tab["c_cnt"], tab["seg_lo"]], axis=1))


@pytest.mark.parametrize("case", ["clamped last segment", "band own_hi",
                                  "narrow windows"])
def test_live_tiles_match_the_kernels_rule(rng, case):
    m_pad, S, rowmiss, lo, hi = windows_case(rng, case)
    plan = ld_split.plan_split_v2(rowmiss, lo, hi, S, m_pad)
    live = ld_split.live_tiles(
        seg_fields(plan, m_pad), torch.from_numpy(lo), torch.from_numpy(hi),
        torch.from_numpy(plan["miss_idx"]), S, plan["p_band"])
    want = kernel_reach(plan, lo, hi, m_pad)
    assert want.shape[2] >= 3                    # several column tiles
    np.testing.assert_array_equal(live.numpy(), want)
    assert 0 < want.sum() < want.size            # some tiles skip
    slot = ld_split.tile_slots(live)
    assert slot.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(slot[live].numpy()),
                                  np.arange(int(want.sum())))
    assert (slot[~live] == -1).all()


@pytest.mark.parametrize("case", ["clamped last segment", "narrow windows"])
def test_fold_annot_matches_float64_sums(rng, case):
    m_pad, S, rowmiss, lo, hi = windows_case(rng, case)
    plan = ld_split.plan_split_v2(rowmiss, lo, hi, S, m_pad)
    seg = seg_fields(plan, m_pad)
    live = ld_split.live_tiles(seg, torch.from_numpy(lo),
                               torch.from_numpy(hi),
                               torch.from_numpy(plan["miss_idx"]), S,
                               plan["p_band"])
    slot = ld_split.tile_slots(live)
    TM, TC, p = ld_split.TILE_X, ld_split.TILE_C, 5
    n_live = int(live.sum())
    # rows of annot_ld(p) = 8 floats: the 3 past p are not summed
    pld = ld_split.annot_ld(p)
    rpa = torch.from_numpy(rng.standard_normal((n_live, 2, TM, pld))
                           .astype(np.float32))
    cpa = torch.from_numpy(rng.standard_normal((n_live, TC, 2, pld))
                           .astype(np.float32))
    n_miss = plan["n_miss"]
    cidx = torch.from_numpy(plan["miss_idx"][:n_miss])
    full = ld_split.fold_annot(rpa, cpa, slot, seg, cidx, S, m_pad, p)
    again = ld_split.fold_annot(rpa, cpa, slot, seg, cidx, S, m_pad, p)
    for a, b in zip(full, again):
        assert torch.equal(a, b)                       # a fixed order
    # float64: each owned row from its x tile's live slots, each
    # contaminated row also from every live tile whose real columns hold
    # its compact row
    tab = ld_split.segment_table(plan, m_pad)
    r64, c64 = (t[..., :p].double().numpy() for t in (rpa, cpa))
    want_f = np.zeros((2, m_pad, p))
    want_c = np.zeros((2, n_miss, p))
    for s, xt, ct in zip(*np.nonzero(live.numpy())):
        k = int(slot[s, xt, ct])
        for r in range(TM):
            gx = int(tab["s0"][s]) + xt * TM + r
            if gx >= tab["seg_lo"][s] and xt * TM + r < S:
                want_f[:, gx] += r64[k, :, r]
        for j in range(TC):
            if ct * TC + j < tab["c_cnt"][s]:
                want_c[:, tab["c0"][s] + ct * TC + j] += c64[k, j]
    want_f[:, plan["miss_idx"][:n_miss]] += want_c
    for got, want in zip(full, want_f):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.abs(want_c).max() > 0
