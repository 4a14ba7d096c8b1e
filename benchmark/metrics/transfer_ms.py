"""``transfer_ms``: the program's host-to-device copy of a call
(``STAGE_TIMES["transfer_s"]``: the packed rows and the annotations, each
closed by a synchronise), mean over the traced calls."""


def read(ctx: dict) -> float | None:
    calls = ctx["calls"]
    if not calls:
        return None
    return 1e3 * sum(c["transfer_s"] for c in calls) / len(calls)
