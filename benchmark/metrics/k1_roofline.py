"""``k1_roofline``: K1's share of its roofline, the bound of
``work/roofline.k1_work`` (with ``k1_annot_work`` where annotated) on the
cell's own windows, for the branch that ran (clean or 8-product), over
K1's device time per call, summed over its launches (one a progress
segment)."""

from . import K1_KERNELS, device_ms


def read(ctx: dict) -> float | None:
    ms = device_ms(ctx, K1_KERNELS)
    if ms is None or ctx["work"].get("k1") is None:
        return None
    return 100.0 * ctx["work"]["k1"]["bound_ms"] / ms
