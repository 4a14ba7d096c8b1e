"""Per-layer metrics: ``<name>.py`` holds the reader of the metric
``<name>`` of ``BENCHMARK.json``, ``read(ctx) -> float | None``.

``ctx`` holds ``calls`` (per call of the traced window: ``host_s``, the
benchmark's clock around the call, and the program's ``transfer_s`` and
``device_s`` spans), ``trace`` (``trace.summarize`` of the window's
profile) and ``work`` (``k1`` and ``k2``: the bounds of
``work/roofline.py`` on the cell's inputs, None for a kernel that the
trace shows did not run).  A reader that finds nothing to read returns None, and the
metric is left out of the result.
"""

#: kernel names (substrings of the trace's names) of the port's kernels
K1_KERNELS = ("ld_sym_kernel",)
K2_KERNELS = ("split_corr_kernel", "tile_reach_kernel", "annot_fold_kernel")


def device_ms(ctx: dict, names: tuple) -> float | None:
    """Milliseconds per traced call of the kernels whose names hold one of
    ``names``, or None where the trace has none."""
    tr = ctx["trace"]
    ns = [e - s for n, s, e, kind in tr.get("device", ())
          if kind == "kernel" and any(k in n for k in names)]
    if not ns or not tr.get("calls"):
        return None
    return sum(ns) / 1e6 / tr["calls"]
