"""What a ``torch.profiler`` trace of the window says: the device's
operations on one timeline, their union, and what the host was doing in
the gaps.

The window is the span of the benchmark's ``bench.ld_call`` ranges, from
the first call's start to the last call's end.  Device operations are the
trace's CUDA events (kernels, copies, fills), clipped to the window.
"""

from __future__ import annotations

import numpy as np

CALL = "bench.ld_call"
#: longest gaps attributed one by one to the host's innermost range
GAPS_NAMED = 4000
#: a breakdown list's entries
TOP = 10
#: the trace's kinds of device operations (kineto's activity types); its
#: ``gpu_user_annotation`` ranges mirror host ranges and are no work
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def kind_of(event) -> str:
    """The kineto activity type of ``event``; on a torch whose events do
    not expose it, worked out from the device, the user-range flag and
    the name (kineto names copies ``Memcpy ...`` and fills ``Memset
    ...``)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind()
    if not str(event.device_type()).endswith("CUDA"):
        return "cpu"
    user = getattr(event, "is_user_annotation", None)
    name = event.name()
    if (user is not None and user()) or name == CALL:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def summarize(events) -> dict:
    """``window_ns`` (start, end), ``calls``, ``device`` (a list of
    ``(name, start_ns, end_ns, kind)``), ``busy_ns`` (their union within the
    window) and ``gaps`` (the idle intervals), from the events of a
    finished profile (``prof.profiler.kineto_results.events()``)."""
    calls, dev, host, kinds = [], [], [], {}
    for e in events:
        span = (e.start_ns(), e.end_ns())
        kind = kind_of(e)
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind in DEVICE_KINDS:
            dev.append((e.name(), *span, kind))
        elif str(e.device_type()).endswith("CUDA"):
            continue
        elif e.name() == CALL:
            calls.append(span)
        else:
            host.append((e.name(), *span))
    if not calls:
        return {"calls": 0, "kinds": kinds}
    t0, t1 = min(s for s, _ in calls), max(e for _, e in calls)
    dev = [(n, max(s, t0), min(e, t1), k) for n, s, e, k in dev
           if e > t0 and s < t1]
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for _, s, e, _ in sorted(dev, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is None:
        gaps.append((t0, t1))
    else:
        busy += cur_e - cur_s
        gaps.append((cur_e, t1))
    gaps = [(s, e) for s, e in gaps if e > s]
    return {"window_ns": (t0, t1), "calls": len(calls), "device": dev,
            "busy_ns": busy, "gaps": gaps, "host": host, "call_spans": calls,
            "call_idle": call_idle(sorted(calls), dev, gaps), "kinds": kinds}


def call_idle(calls: list, dev: list, gaps: list) -> list:
    """Per call ``(s, e)``, the card's idle nanoseconds inside it before
    and after the end of its last kernel (a kernel that starts inside the
    call): the host's work while the card waits, split at the point from
    which only the fetch of the results and their conversion remain.
    None where the trace holds no kernel."""
    gs = np.array([s for s, _ in gaps], dtype=np.int64)
    ge = np.array([e for _, e in gaps], dtype=np.int64)
    ks = np.array([s for _, s, _, k in dev if k == "kernel"], dtype=np.int64)
    ke = np.array([e for _, _, e, k in dev if k == "kernel"], dtype=np.int64)
    if not ks.size:
        return None

    def idle(a, b):
        return int((np.minimum(ge, b) - np.maximum(gs, a)).clip(min=0).sum())

    out = []
    for s, e in calls:
        inside = (ks >= s) & (ks < e)
        k_end = min(int(ke[inside].max()), e) if inside.any() else s
        out.append((idle(s, k_end), idle(k_end, e)))
    return out


def breakdown(summary: dict) -> dict:
    """The device operations that took most time and the idle time by
    the host's innermost range over each gap (``bench.ld_call`` where no
    other range was open), each a list of ``[name, seconds]``."""
    ops: dict[str, int] = {}
    for name, s, e, _ in summary["device"]:
        ops[name] = ops.get(name, 0) + (e - s)
    device_ops = sorted(ops.items(), key=lambda x: -x[1])[:TOP]
    host = summary["host"]
    names = np.array([n for n, _, _ in host] + [CALL] * len(
        summary["call_spans"]), dtype=object)
    starts = np.array([s for _, s, _ in host]
                      + [s for s, _ in summary["call_spans"]], dtype=np.int64)
    ends = np.array([e for _, _, e in host]
                    + [e for _, e in summary["call_spans"]], dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    names, starts, ends = names[order], starts[order], ends[order]
    idle: dict[str, int] = {}
    gaps = sorted(summary["gaps"], key=lambda g: g[0] - g[1])
    for k, (s, e) in enumerate(gaps):
        name = "(shorter gaps)"
        if k < GAPS_NAMED:
            mid = (s + e) // 2
            hit = np.flatnonzero((starts[:np.searchsorted(starts, mid,
                                                          "right")] <= mid)
                                 & (ends[:np.searchsorted(starts, mid,
                                                          "right")] >= mid))
            name = "(no host range)"
            if hit.size:
                name = names[hit[np.argmin(ends[hit] - starts[hit])]]
        idle[name] = idle.get(name, 0) + (e - s)
    idle_gaps = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return {"device_ops": [[n[:160], v / 1e9] for n, v in device_ops],
            "idle_gaps": [[n[:160], v / 1e9] for n, v in idle_gaps]}
