"""The LD kernel's cluster grid, as the wrapper counts it, against brute
force.

``csrc/ld_sym.cu`` runs clusters of two pivot tiles by two neighbour tiles
on wide rows and a plain launch (clusters of one CTA) on narrow ones.  The
grid is enumerated here CTA by CTA as the kernel lays it out: every slot
(pivot tile b < n_piv, k in [0, band)) must have exactly one owner CTA,
the live CTAs must be exactly the in-band (b, t) pairs that
``ld_int8.band_extent`` gives, and ``ld_pallas_sym.cluster_tile_ctas``,
the CTAs the wrapper hands ``wave_bounds``, must count those of the
clusters that run, dead members included.  No JAX and no card.
"""

import zlib

import numpy as np
import pytest
import torch

from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym
from nldsc_tpu_torch.ld.pipeline import padded_shape

from test_torch_kernel import CASES as KERNEL_CASES

# (tiles, tile rows, real rows, half window in rows, pivot rows or None,
# ragged window ends)
CASES = {
    "even_tiles": (16, 64, 1024, 150, None, False),
    "odd_tiles": (15, 64, 950, 150, None, False),
    "ragged_ends": (13, 64, 832, 200, None, True),
    "ragged_wide": (17, 64, 1088, 500, None, True),
    "halo_emptied": (12, 64, 768, 100, 7 * 64, False),
    "halo_odd_pivots": (11, 128, 1408, 300, 5 * 128, True),
    "halo_one_pivot": (6, 128, 768, 300, 128, False),
    "band_one": (9, 64, 576, 0, None, False),
    "band_one_ragged": (8, 64, 450, 0, None, True),
    "one_tile": (1, 128, 100, 50, None, False),
    "padding_rows": (10, 64, 500, 80, None, True),
    "wide_band": (20, 64, 1280, 700, None, False),
}
SHAPES = [ld_pallas_sym.CLUSTER, (1, 1)]


def case_geometry(rng, name):
    """``(tile_hi list, n_piv, n_tiles, band)`` of one case, from window
    ends through ``ld_int8.band_extent`` as the wrapper gets them."""
    nt, T, m, w, pivot_rows, ragged = CASES[name]
    rows = np.arange(nt * T)
    reach = rng.integers(0, w + 1, nt * T) if ragged else np.full(nt * T, w)
    hi = np.where(rows < m, np.minimum(rows + reach, m - 1), -1)
    if pivot_rows is not None:
        hi[pivot_rows:] = -1                 # the halo's windows emptied
    tile_hi, band = ld_int8.band_extent(
        torch.from_numpy(hi.astype(np.int32)), T)
    n_piv = nt if pivot_rows is None else -(-pivot_rows // T)
    return tile_hi.tolist(), n_piv, nt, band


def kernel_grid(tile_hi, n_piv, nt, band, shape):
    """The clusters of ``ld_sym.cu``'s grid, each a list of its CTAs
    ``(b, t, owns a slot, live)``, enumerated as the kernel lays them out
    (x: CN x NJ neighbour tiles, y: CP x ceil(n_piv / CP) pivot tiles)."""
    cp, cn = shape
    groups = max(1, -(-n_piv // cp))
    nj = -(-(band + cp - 1) // cn)
    clusters = []
    for y0 in range(0, cp * groups, cp):
        for x0 in range(0, cn * nj, cn):
            ctas = []
            for b in range(y0, y0 + cp):
                for j in range(x0, x0 + cn):
                    t = y0 + j
                    owns = b < n_piv and 0 <= t - b < band
                    live = owns and t < nt and t <= tile_hi[b]
                    ctas.append((b, t, owns, live))
            clusters.append(ctas)
    return clusters


@pytest.fixture()
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.nodeid.encode()))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CASES))
def test_grid_covers_every_slot_once(rng, name, shape):
    tile_hi, n_piv, nt, band = case_geometry(rng, name)
    ctas = [c for cl in kernel_grid(tile_hi, n_piv, nt, band, shape)
            for c in cl]
    # every slot of every pivot tile below n_piv: exactly one owner
    owners = {}
    for b, t, owns, _ in ctas:
        if owns:
            owners[b, t - b] = owners.get((b, t - b), 0) + 1
    assert owners == {(b, k): 1 for b in range(n_piv) for k in range(band)}
    # the live CTAs: exactly the in-band pairs, brute force
    in_band = {(b, t) for b in range(n_piv)
               for t in range(b, min(tile_hi[b], nt - 1) + 1)}
    assert {(b, t) for b, t, _, live in ctas if live} == in_band
    assert sum(live for *_, live in ctas) == len(in_band)
    assert all(t - b < band for b, t in in_band)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(CASES))
def test_tile_ctas_count_the_running_clusters(rng, name, shape):
    tile_hi, n_piv, nt, band = case_geometry(rng, name)
    clusters = kernel_grid(tile_hi, n_piv, nt, band, shape)
    # dead members of a running cluster count; clusters with no live
    # member exit at once and do not
    want = [sum(b == x for cl in clusters if any(c[3] for c in cl)
                for b, *_ in cl) for x in range(n_piv)]
    got = ld_pallas_sym.cluster_tile_ctas(tile_hi, n_piv, nt, band, shape)
    assert got == want
    if shape == (1, 1):                       # one CTA per live slot
        assert got == [max(0, min(x_hi, nt - 1) - x + 1)
                       for x, x_hi in enumerate(tile_hi[:n_piv])]


def test_wave_bounds_prefer_whole_clusters():
    # 512 pivot tiles of 10 cluster CTAs, 128 CTAs a wave (32 clusters of
    # 4): the cuts fall on even tiles, each launch within its share of
    # the waves; a launch's last wave leaves up to a pair of tiles' CTAs
    # idle, so the 16 launches take at most two waves more than one
    ctas = [10] * 512
    b = ld_pallas_sym.wave_bounds(ctas, 16, 128, align=2)
    assert len(b) == 17 and b[0] == 0 and b[-1] == 512
    assert all(x % 2 == 0 for x in b)
    waves = [-(-sum(ctas[x0:x1]) // 128) for x0, x1 in zip(b, b[1:])]
    assert max(waves[:-1]) <= -(-40 // 16) and waves[-1] <= 4
    assert sum(waves) <= -(-sum(ctas) // 128) + 2
    # as many launches as tiles: one tile each, whatever the alignment
    assert ld_pallas_sym.wave_bounds([4] * 16, 16, 128,
                                     align=2) == list(range(17))


def test_cluster_shape_follows_the_ring_stages():
    # clusters from CLUSTER_MIN_STAGES ring stages of a row: 128 int8
    # samples a stage, 64 bf16; UK Biobank widths always cluster
    for has_missing in (False, True):
        k = ld_pallas_sym.CLUSTER_MIN_STAGES[has_missing]
        for bf16, per in ((False, 128), (True, 64)):
            shape = ld_pallas_sym.cluster_shape
            assert shape(k * per, has_missing, bf16) == ld_pallas_sym.CLUSTER
            assert shape((k - 1) * per, has_missing, bf16) == (1, 1)
            assert shape(315_648, has_missing, bf16) == ld_pallas_sym.CLUSTER


@pytest.mark.parametrize("case", [c for c in KERNEL_CASES
                                  if c.startswith("cluster_")])
def test_card_cases_run_in_clusters(case):
    # the card tests' cluster_* cases take the clustered launch on int8
    # and bf16 operands (the rest of those tests the plain one)
    m, n, rate = KERNEL_CASES[case][:3]
    n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)[1]
    for bf16 in (False, True):
        assert ld_pallas_sym.cluster_shape(n_pad, rate > 0,
                                           bf16) == ld_pallas_sym.CLUSTER
