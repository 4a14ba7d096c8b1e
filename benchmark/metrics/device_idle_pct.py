"""``device_idle_pct``: the share of the traced window (the first call's
start to the last call's end) in which no kernel, copy or fill ran on the
card: the complement of the union of their intervals."""


def read(ctx: dict) -> float | None:
    tr = ctx["trace"]
    if not tr.get("calls") or not tr.get("device"):
        return None
    t0, t1 = tr["window_ns"]
    return 100.0 * (1.0 - tr["busy_ns"] / (t1 - t0))
