"""``k1_tile_fill_pct``: the share of the row pairs in K1's computed
tiles that lie in a window: the program's counters ``k1.window_pairs``
(pairs i <= j <= hi[i] of the real rows) over ``k1.tile_pairs`` (T² per
pivot and neighbour tile its launches cover), over the traced calls."""

from .program_spans import counter_ratio_pct


def read(ctx: dict) -> float | None:
    return counter_ratio_pct(ctx, "k1.window_pairs", "k1.tile_pairs")
