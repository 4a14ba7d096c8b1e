"""Host-side window geometry.

The reference evaluates the window predicate ``|pos_j - pos_i| <= ld_wind``
pairwise in double precision (``tools.h:41-49``).  On TPU we avoid f64 (and
f32 boundary-rounding hazards) entirely: since positions are sorted, window
membership is an index *interval* — so we precompute, in exact float64 on
host, inclusive bounds ``lo[i]``/``hi[i]`` per SNP, and the device mask is a
pure integer-range test.  This makes the device path bitwise-independent of
position precision.

Negative positions are the reference's skip sentinel (``tools.h:15-23``);
those rows are masked out downstream, but their entries must not break the
sorted order needed by ``searchsorted`` — we fill them from neighbors.
"""

from __future__ import annotations

import numpy as np

from ..core.errors import NLDSCDataError


def fill_skipped_positions(positions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Replace sentinel (< 0) positions with the nearest usable value.

    Returns (filled_positions, pos_ok_mask).  Filled values keep the array
    sorted as long as the usable subsequence is sorted; the filled rows are
    masked out of every result anyway.
    """
    positions = np.asarray(positions, dtype=np.float64)
    pos_ok = positions >= 0
    if pos_ok.all():
        return positions, pos_ok
    if not pos_ok.any():
        return np.zeros_like(positions), pos_ok
    filled = positions.copy()
    idx = np.where(pos_ok, np.arange(len(positions)), -1)
    np.maximum.accumulate(idx, out=idx)          # forward fill index
    first_ok = np.flatnonzero(pos_ok)[0]
    idx[idx < 0] = first_ok                      # backfill the head
    filled = filled[idx]
    return filled, pos_ok


def window_bounds(positions: np.ndarray, ld_wind: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Inclusive index bounds of each SNP's window.

    Returns (lo, hi, pos_ok): int32 arrays with
    ``lo[i] = min{j : pos_j >= pos_i - w}``, ``hi[i] = max{j : pos_j <= pos_i + w}``
    (both inclusive; `<=` at the boundary, matching tools.h:45-46), and the
    position-sentinel mask.
    """
    filled, pos_ok = fill_skipped_positions(positions)
    usable_pos = filled[pos_ok]
    if usable_pos.size and np.any(np.diff(usable_pos) < 0):
        raise NLDSCDataError(
            "positions must be sorted (non-decreasing) for windowed LD; "
            "sort the .bim by the window metric column first"
        )
    lo = np.searchsorted(filled, filled - ld_wind, side="left").astype(np.int32)
    hi = (np.searchsorted(filled, filled + ld_wind, side="right") - 1).astype(np.int32)
    return lo, hi, pos_ok


def band_blocks(lo: np.ndarray, hi: np.ndarray, block_size: int,
                n_blocks: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Per pivot-block neighbor-block range and the static band depth K.

    Returns (blk_lo, blk_hi) int32 arrays of length ``n_blocks`` and
    ``K = max(blk_hi - blk_lo) + 1`` — the static loop bound of the banded
    device kernel.
    """
    m = len(lo)
    blk_lo = np.empty(n_blocks, dtype=np.int32)
    blk_hi = np.empty(n_blocks, dtype=np.int32)
    for b in range(n_blocks):
        r0, r1 = b * block_size, min((b + 1) * block_size, m)
        if r0 >= m:
            blk_lo[b], blk_hi[b] = b, b  # padding block: degenerate band
            continue
        blk_lo[b] = lo[r0:r1].min() // block_size
        blk_hi[b] = hi[r0:r1].max() // block_size
    k = int((blk_hi - blk_lo).max()) + 1 if n_blocks else 1
    return blk_lo, blk_hi, k


def right_band_blocks(blk_hi: np.ndarray, block_size: int) -> int:
    """Static right-half-band depth: max blocks from a pivot block to its
    rightmost neighbor block, inclusive (symmetric engine)."""
    nb = len(blk_hi)
    if nb == 0:
        return 1
    return max(int((blk_hi - np.arange(nb, dtype=np.int64)).max()) + 1, 1)


def max_halo_rows(lo: np.ndarray, hi: np.ndarray) -> int:
    """Maximum one-sided window span in rows (sharding halo width)."""
    if len(lo) == 0:
        return 0
    idx = np.arange(len(lo), dtype=np.int64)
    return int(max((idx - lo).max(), (hi - idx).max(), 0))


def window_pairs(hi: np.ndarray, m: int) -> int:
    """The pairs (i, j), i <= j <= hi[i], of the first ``m`` rows: the
    pairs of the rows' windows, each of which the symmetric pass credits
    once."""
    reach = hi[:m].astype(np.int64) - np.arange(m) + 1
    return int(reach.clip(min=0).sum())
