"""The frozen roofline arithmetic against pairs and bytes counted by hand
on a window of three tiles."""

from __future__ import annotations

import pytest
import torch

from benchmark.work import roofline

N = 256


def hi_of(m: int, reach: int) -> torch.Tensor:
    return torch.tensor([min(i + reach, m - 1) for i in range(m)],
                        dtype=torch.int32)


@pytest.mark.parametrize("missing", [False, True])
def test_k1_three_tiles(missing):
    # 12 rows in 3 tiles of 4, each row's window reaching 2 rows on: rows
    # 0-9 count 3 pairs i <= j each, row 10 two, row 11 one
    w = roofline.k1_work(hi_of(12, 2), N, missing)
    assert w["pairs"] == 33
    nprod = 8 if missing else 3
    assert w["ops"] == 2.0 * nprod * N * 33
    assert w["bytes"] == ((3 if missing else 2) * 12 * N
                          + 12 * (36 + 8 + 3) + 24 * 12)
    assert w["bound_ms"] == pytest.approx(1e3 * max(
        w["ops"] / roofline.INT8_OPS, w["bytes"] / roofline.HBM_BYTES))


def test_annot_bound_three_tiles():
    w = roofline.k1_work(hi_of(12, 2), N, False)
    a = roofline.k1_annot_work(w, 12, p=2)
    assert a["annot_f32_ops"] == 4 * 2 * 2 * 33
    assert a["bytes"] == w["bytes"] + 3 * 4 * 12 * 2
    t_ops = (w["ops"] / roofline.INT8_OPS
             + 3 * a["annot_f32_ops"] / roofline.TF32_OPS)
    assert a["bound_ms"] == pytest.approx(1e3 * max(
        t_ops, a["bytes"] / roofline.HBM_BYTES))


@pytest.mark.parametrize("cont, pairs, d_pairs, rows", [
    ((2, 7), 8, 0, 10),     # windows [0, 4] and [5, 9]: apart
    ((2, 3), 8, 2, 6),      # windows [0, 4] and [1, 5]: each in the other's
])
def test_k2_three_tiles(cont, pairs, d_pairs, rows):
    m = 12
    lo = torch.tensor([max(i - 2, 0) for i in range(m)], dtype=torch.int32)
    hi = torch.tensor([min(i + 2, m - 1) for i in range(m)],
                      dtype=torch.int32)
    usable = torch.ones(m, dtype=torch.bool)
    rowmiss = torch.zeros(m, dtype=torch.bool)
    rowmiss[list(cont)] = True
    w = roofline.k2_work(lo, hi, usable, rowmiss, N)
    assert (w["pairs"], w["d_pairs"], w["rows"], w["columns"]) == (
        pairs, d_pairs, rows, 2)
    assert w["int8_ops"] == 2.0 * N * (5 * pairs + 3 * d_pairs)
    assert w["bytes"] == ((rows + 6) * N + rows * 51 + 2 * 42 + 12 * m)
