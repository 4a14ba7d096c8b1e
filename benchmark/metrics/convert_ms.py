"""``convert_ms``: the result's conversion on the host, per call of
``compute_ld_scores``: the idle time inside each traced call after the
end of its last kernel, when only the fetch remains (``to_host_result``
and the annotation scores' ``.cpu().numpy().astype(float64)``; the
copies themselves are device operations), mean over the traced calls."""


def read(ctx: dict) -> float | None:
    idle = ctx["trace"].get("call_idle")
    if not idle:
        return None
    return sum(a for _, a in idle) / 1e6 / len(idle)
