"""``k2_live_tile_pct``: the share of the tiles of K2's fused launch that
compute, by the kernel's own rule: the program's counters
``k2.live_tiles`` over ``k2.tiles``, over the traced calls."""

from .program_spans import counter_ratio_pct


def read(ctx: dict) -> float | None:
    return counter_ratio_pct(ctx, "k2.live_tiles", "k2.tiles")
