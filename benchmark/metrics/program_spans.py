"""What the program's own tracing says of the traced window's calls.

While a torch profiler runs, ``nldsc_tpu_torch.core.timing`` records each
call of ``compute_ld_scores`` as a tree of spans (each opening the range
``nldsc.<span>`` in the trace) with the call's counters, and
``timing.calls()`` returns them.  A program without that tracing gives
nothing here, and the readers leave their metric out.
"""

from __future__ import annotations


def traced_calls(ctx: dict) -> list:
    """The program's records of the traced calls (``timing.calls()``),
    [] where the window held no call or the program records none."""
    if not ctx["trace"].get("calls"):
        return []
    try:
        from nldsc_tpu_torch.core.timing import calls
    except ImportError:
        return []
    return calls()


def span_device_ms(ctx: dict, name: str) -> float | None:
    """Mean over the traced calls that hold the span ``name`` of its
    ``device_ms`` (summed over its occurrences in a call), or None."""
    per_call = [sum(s["device_ms"] for s in c["spans"] if s["name"] == name)
                for c in traced_calls(ctx)
                if any(s["name"] == name for s in c["spans"])]
    return sum(per_call) / len(per_call) if per_call else None


def counter_ratio_pct(ctx: dict, part: str, whole: str) -> float | None:
    """100 times the sum of the counter ``part`` over the sum of
    ``whole``, over the traced calls that count both, or None."""
    got = [c["counters"] for c in traced_calls(ctx)
           if part in c["counters"] and c["counters"].get(whole)]
    if not got:
        return None
    return 100.0 * sum(c[part] for c in got) / sum(c[whole] for c in got)


def host_range_ms(ctx: dict, name: str) -> float | None:
    """The wall time of the trace's ``nldsc.<name>`` host ranges per
    traced call, or None where it has none."""
    tr = ctx["trace"]
    ns = [e - s for n, s, e in tr.get("host", ()) if n == "nldsc." + name]
    if not ns or not tr.get("calls"):
        return None
    return sum(ns) / 1e6 / tr["calls"]
