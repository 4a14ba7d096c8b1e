"""``host_ms``: the driver's time with the card idle, per call of
``compute_ld_scores``: the idle time inside each traced call up to the
end of its last kernel (window bounds, padding, the annotations' float32
conversion, the split plan, waits on the host between launches), mean
over the traced calls.  What follows the last kernel is ``convert_ms``'s."""


def read(ctx: dict) -> float | None:
    idle = ctx["trace"].get("call_idle")
    if not idle:
        return None
    return sum(b for b, _ in idle) / 1e6 / len(idle)
