"""``prep_device_ms``: device time per call of every kernel that is
neither K1's nor K2's (unpack, preprocess, folds, finalize), copies and
fills left out, from the trace."""

from . import K1_KERNELS, K2_KERNELS


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    ns = [e - s for n, s, e, kind in tr.get("device", ())
          if kind == "kernel" and not any(k in n for k in K1_KERNELS
                                          + K2_KERNELS)]
    if not ns or not tr.get("calls"):
        return None
    return sum(ns) / 1e6 / tr["calls"]
