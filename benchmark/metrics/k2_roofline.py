"""``k2_roofline``: K2's share of its roofline, the bound of
``work/roofline.k2_work`` on the cell's inputs over the device time per
call of K2's launches and its reach and fold kernels.  Nothing where the
inputs need no K2 or the trace has none of its kernels."""

from . import K2_KERNELS, device_ms


def read(ctx: dict) -> float | None:
    ms = device_ms(ctx, K2_KERNELS)
    if ms is None or ctx["work"].get("k2") is None:
        return None
    return 100.0 * ctx["work"]["k2"]["bound_ms"] / ms
