"""The plain reference against a brute-force float64 loop on a tiny
seeded chromosome, and its bfloat16 control against the cells' limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.check import readings, verdict
from benchmark.gen import chromosome
from benchmark.reference import ld as reference

from .conftest import CELLS, tiny_cell

M, N, WIND = 160, 97, 7.0
MAF_THR, STD_THR, RSQ = 0.02, 1e-5, 0.01


def tiny_codes(seed: int) -> np.ndarray:
    """Seeded codes with local LD, 3% missing, and the rows that take the
    reference's other branches: a monomorphic row (MAF-dropped), an
    all-het row (additive sd 0: it poisons its neighbours' l2), a rare
    row below ``MAF_THR`` and a row with one genotype."""
    rng = np.random.default_rng(seed)
    g = np.empty((M, N), np.int8)
    g[0] = rng.binomial(2, 0.3, N)
    for i in range(1, M):
        keep = rng.random(N) < 0.7
        g[i] = np.where(keep, g[i - 1], rng.binomial(2, rng.uniform(0.05, .5),
                                                     N))
    g[rng.random((M, N)) < 0.03] = -1
    g[20] = 0
    g[50] = 1
    g[80] = 0
    g[80, 3] = 1
    g[120] = -1
    g[120, 5] = 2
    return g


def brute(g: np.ndarray, pos: np.ndarray, annot) -> dict:
    """LD scores pair by pair in float64: the semantics the reference's
    docstring states, written as plainly as they read."""
    m, n = g.shape
    a_std, r_std = np.zeros((m, n)), np.zeros((m, n))
    maf, rsd = np.full(m, np.nan), np.full(m, np.nan)
    usable, sd0 = np.zeros(m, bool), np.zeros(m, bool)
    for i in range(m):
        miss = g[i] < 0
        x = g[i].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            ma = np.where(miss, 0, x).sum() / (~miss).sum()
            md = np.where(miss, 0, np.minimum(x, 1) * 2).sum() / (~miss).sum()
        f = ma / 2
        maf[i] = f if f < 0.5 else 1 - f
        if maf[i] <= MAF_THR:
            continue
        a = np.where(miss, ma, x)
        d = np.where(miss, md, np.minimum(x, 1) * 2)
        den = (a @ a) / n - a.mean() ** 2
        slope = ((a @ d) / n - a.mean() * d.mean()) / den if den else np.nan
        r = d - slope * a
        sa = np.sqrt(((a - a.mean()) ** 2).sum() / n)
        sr = np.sqrt(((r - r.mean()) ** 2).sum() / n)
        usable[i], rsd[i] = True, sr
        if sa == 0 or not np.isfinite(sa):
            sd0[i] = True
        else:
            a_std[i] = (a - a.mean()) / sa
        if sr > 0 and np.isfinite(sr):
            r_std[i] = (r - r.mean()) / sr
    c = (n - 1) / (n - 2)
    out = {k: np.full(m, np.nan) for k in ("l2", "l2d")}
    out.update({k: np.full(m, -1) for k in ("l2_ws", "l2d_ws", "l2d_wse")})
    if annot is not None:
        out["l2_annot"] = np.full(annot.shape, np.nan)
        out["l2d_annot"] = np.full(annot.shape, np.nan)
    for i in range(m):
        if not usable[i]:
            continue
        l2, l2d, ws, wsd, wse = 1.0, 0.0, 0, 0, 0
        la = None if annot is None else annot[i].copy()
        lda = None if annot is None else np.zeros(annot.shape[1])
        poison = sd0[i]
        for j in range(m):
            if j == i or not usable[j] or abs(pos[j] - pos[i]) > WIND:
                continue
            ws += 1
            poison |= sd0[j]
            adj = 1 - (1 - (a_std[i] @ a_std[j] / n) ** 2) * c
            l2 += adj
            if la is not None:
                la += adj * annot[j]
            if rsd[j] > STD_THR:
                wsd += 1
                dadj = 1 - (1 - (a_std[i] @ r_std[j] / n) ** 2) * c
                l2d += dadj
                wse += dadj > RSQ
                if lda is not None:
                    lda += dadj * annot[j]
        out["l2_ws"][i], out["l2d_ws"][i] = ws, wsd
        out["l2"][i] = np.nan if poison else l2
        out["l2d"][i] = (np.nan if wsd else 0.0) if sd0[i] else l2d
        out["l2d_wse"][i] = 0 if sd0[i] else wse
        if annot is not None:
            out["l2_annot"][i] = np.nan if poison else la
            out["l2d_annot"][i] = (np.nan if wsd else 0.0) if sd0[i] else lda
    out["maf"], out["residuals_std"] = maf, rsd
    return out


@pytest.mark.parametrize("blocks", [[(0, M)], [(0, 40), (40, 41), (90, 160)]],
                         ids=["whole", "blocks"])
@pytest.mark.parametrize("with_annot", [False, True])
def test_reference_equals_brute_force(blocks, with_annot):
    g = tiny_codes(5)
    pos = np.cumsum(np.random.default_rng(6).uniform(0.2, 1.8, M))
    annot = (np.random.default_rng(7).random((M, 3)) if with_annot
             else None)
    raw = chromosome.pack_codes(torch.from_numpy(g)).numpy()
    got = reference.ld_rows(raw, N, pos, WIND, MAF_THR, STD_THR, RSQ, blocks,
                            annot)
    want = brute(g, pos, annot)
    rows = np.concatenate([np.arange(a, b) for a, b in blocks])
    for k in reference.FIELDS + (reference.ANNOT_FIELDS if with_annot
                                 else ()):
        np.testing.assert_allclose(got[k], want[k][rows], rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    # the branches the tiny chromosome is there for
    assert np.isnan(want["l2"][20]) and want["l2_ws"][20] == -1
    assert np.isnan(want["l2"][51]) and not np.isnan(want["l2d"][51])


def test_unpack_inverts_pack():
    g = tiny_codes(9)
    raw = chromosome.pack_codes(torch.from_numpy(g))
    assert torch.equal(reference.unpack(raw, N), torch.from_numpy(g))


def test_copy_chain_equals_loop():
    """The vectorised copy chain against the row-by-row loop it replaces."""
    gen = torch.Generator().manual_seed(3)
    fresh = torch.randint(0, 3, (40, 33), generator=gen, dtype=torch.int8)
    keep = torch.rand((40, 33), generator=gen) < 0.8
    for prev in (None, torch.randint(0, 3, (33,), generator=gen,
                                     dtype=torch.int8)):
        want, last = torch.empty_like(fresh), prev
        for i in range(40):
            want[i] = (fresh[i] if last is None
                       else torch.where(keep[i], last, fresh[i]))
            last = want[i]
        assert torch.equal(chromosome.copy_chain(fresh, keep, prev), want)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cell(name):
    """The reference with its epilogue in bfloat16, put in the program's
    place at a size a test holds, breaks the cell's limits."""
    from benchmark import harness

    _, config, workload = tiny_cell(name)
    inputs = harness.setup(config, workload, 77, "cpu")
    blocks = harness.checked_blocks(config["n_snps"], workload["check"], 77)
    ref = harness.reference_rows(inputs, blocks, "cpu")
    ctl = harness.reference_rows(inputs, blocks, "cpu", torch.bfloat16)
    ok, table = verdict(readings([ctl], ref), workload["limits"])
    assert not ok, table
