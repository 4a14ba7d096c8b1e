"""Run-time measurement: the stage clocks of ``estimate_lds``
(:data:`STAGE_TIMES`), the elapsed-time log decorator, and the spans and
counters of a traced call.

Tracing is on exactly while a ``torch.profiler`` runs (the benchmark's
``--trace 1``, the CLI's ``--profile-dir``).  Then :func:`span` opens a
``record_function("nldsc.<name>")`` range, on the profiler's clock beside
the device's operations, and keeps a record of the span in memory;
:func:`defer` leaves a count of the traced call until :func:`calls`
returns the records, after the call.  Off, a span costs one check of the
profiler's state and returns a shared null context: no clock read, no
range, no CUDA event.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from datetime import timedelta
from functools import wraps

import torch

from .logging import log

#: stage decomposition of the LAST ``estimate_lds`` call (seconds):
#: ``disk_s`` (.bim/.fam parse and .bed read), ``transfer_s`` (host to
#: device copy of the packed bytes), ``device_s`` (unpack, preprocess,
#: LD pass and the fetch of the results), ``write_s`` (.L2 and sidecars).
STAGE_TIMES: dict[str, float] = {}


def stage_add(key: str, t0: float) -> None:
    STAGE_TIMES[key] = STAGE_TIMES.get(key, 0.0) + (time.time() - t0)


def elapsed_time(func):
    """Wall-clock logging decorator."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        log.info("Elapsed time: %s", timedelta(seconds=time.time() - start))
        return result

    return wrapper


#: the prefix of the spans' ``record_function`` names
PREFIX = "nldsc."
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
#: the records of the traced calls, oldest first (:func:`calls`), and
#: their ids (``next`` is atomic: threads' calls get distinct ids)
_CALLS: list[dict] = []
_ids = itertools.count()


def tracing() -> bool:
    """Whether a torch profiler runs: spans and counters record."""
    return _profiler_enabled()


class _Open(threading.local):
    """The spans open in this thread, innermost last."""

    def __init__(self):
        self.spans: list[_Span] = []


_open = _Open()


def launch_counts() -> dict:
    """The process's totals of kernel launches: K1 (``ld_sym``, and of
    its 8-product, annotation and bf16 instantiations), K2 (``split_*``:
    either mode, fused, annotated, the reach and fold kernels, bf16), and
    both per device."""
    from ..ld import ld_pallas_sym, ld_split  # noqa: PLC0415 (ld imports this)

    return {"ld_sym": ld_pallas_sym.launches,
            "ld_sym_8prod": ld_pallas_sym.missing_launches,
            "ld_sym_annot": ld_pallas_sym.annot_launches,
            "ld_sym_bf16": ld_pallas_sym.bf16_launches,
            "split_corr": ld_split.corr_launches,
            "split_fused": ld_split.fused_launches,
            "split_annot": ld_split.annot_launches,
            "split_reach": ld_split.reach_launches,
            "split_fold": ld_split.fold_launches,
            "split_bf16": ld_split.bf16_launches,
            "ld_sym_by_device": dict(ld_pallas_sym.device_launches),
            "split_by_device": dict(ld_split.device_launches)}


def _launch_delta(before: dict, after: dict) -> dict:
    """``launches.<key>`` counters of the launches between two
    :func:`launch_counts`, the per-device ones as
    ``launches.<key>.<device>``; those that did not change left out."""
    out = {}
    for key, now in after.items():
        if isinstance(now, dict):
            for dev, n in now.items():
                d = n - before[key].get(dev, 0)
                if d:
                    out[f"launches.{key}.{dev}"] = d
        elif now != before[key]:
            out[f"launches.{key}"] = now - before[key]
    return out


class _Span:
    """An open span: its ``record_function`` range and, inside a traced
    call, its record (the host clock, and CUDA events on the call's
    device)."""

    __slots__ = ("name", "root", "device", "call", "rec", "range", "launches")

    def __init__(self, name: str, root: bool, device):
        self.name, self.root, self.device = name, root, device
        self.call = self.rec = self.launches = None

    def __enter__(self):
        spans = _open.spans
        parent = spans[-1] if spans else None
        self.call = None if parent is None else parent.call
        if self.call is None and self.root:
            dev = torch.device("cpu" if self.device is None else self.device)
            self.call = {"id": next(_ids), "device": dev, "spans": [],
                         "counters": {}, "later": [], "open": True}
            _CALLS.append(self.call)
            self.launches = launch_counts()
        else:
            self.root = False
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        if self.call is not None:
            self.rec = {"name": self.name,
                        "parent": None if parent is None else parent.name,
                        "t0": time.perf_counter_ns(), "t1": None,
                        "events": None, "device_ms": None}
            dev = self.call["device"]
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(dev))
                self.rec["events"] = (start, None)
            self.call["spans"].append(self.rec)
        spans.append(self)
        return self

    def __exit__(self, *exc):
        _open.spans.pop()
        rec = self.rec
        if rec is not None:
            if rec["events"] is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.call["device"]))
                rec["events"] = (rec["events"][0], end)
            rec["t1"] = time.perf_counter_ns()
        if self.root:
            self.call["counters"].update(_launch_delta(self.launches,
                                                       launch_counts()))
            self.call["open"] = False
        self.range.__exit__(*exc)
        return False


def span(name: str, *, root: bool = False, device=None):
    """A context that times ``name`` while tracing (:func:`tracing`), and
    does nothing otherwise.  ``root``: the span opens a traced call (when
    none is open in this thread), whose spans share its id, on ``device``
    (CUDA events time its spans on that device's current stream); it also
    stores the call's kernel launches (:func:`launch_counts`).  A span
    opened outside any traced call only opens its profiler range."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, root, device)


def defer(counters) -> None:
    """Have :func:`calls` add the counters that ``counters()`` returns (a
    dict of name to value) to the traced call open in this thread: a
    count that would hold the call up, run after it, off its path.
    ``counters`` must only read what the call leaves unchanged.  Nothing
    when tracing is off or no call is open."""
    if not _profiler_enabled() or not _open.spans:
        return
    call = _open.spans[-1].call
    if call is not None:
        call["later"].append(counters)


def calls() -> list[dict]:
    """One record per finished traced call, oldest first: ``id``,
    ``spans`` (in the order they opened, each ``name``, ``parent`` (the
    enclosing span's name, None for the root), ``host_ms`` and
    ``device_ms``) and ``counters``.  ``device_ms`` is the span's length
    on the device's stream, idle time included, from its CUDA events
    (resolved here, waiting for them if the caller has not synchronised);
    on the CPU, whose work is synchronous, the host duration.  The
    counts left by :func:`defer` run here, once."""
    out = []
    for call in _CALLS:
        if call["open"]:
            continue
        for counters in call["later"]:
            for name, value in counters().items():
                call["counters"][name] = call["counters"].get(name, 0) + value
        call["later"].clear()
        spans = []
        for rec in call["spans"]:
            host_ms = (rec["t1"] - rec["t0"]) / 1e6
            if rec["events"] is not None:
                start, end = rec["events"]
                end.synchronize()
                rec["device_ms"] = start.elapsed_time(end)
                rec["events"] = None
            spans.append({"name": rec["name"], "parent": rec["parent"],
                          "host_ms": host_ms,
                          "device_ms": host_ms if rec["device_ms"] is None
                          else rec["device_ms"]})
        out.append({"id": call["id"], "spans": spans,
                    "counters": dict(call["counters"])})
    return out


def reset() -> None:
    """Forget the traced calls recorded so far; ids start again at 0."""
    global _ids
    _CALLS.clear()
    _ids = itertools.count()


def call_line(call: dict) -> str:
    """One line of a :func:`calls` record: each span's ``device_ms``
    (summed over its occurrences) and the call's counters."""
    ms: dict[str, float] = {}
    for s in call["spans"]:
        ms[s["name"]] = ms.get(s["name"], 0.0) + s["device_ms"]
    spans = ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
    counters = ", ".join(f"{k} {v}" for k, v in call["counters"].items())
    return f"call {call['id']}: device_ms {spans}; counters {counters}"
