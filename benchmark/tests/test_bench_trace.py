"""The trace's timeline on a synthetic profile: the window, the union of
device operations, the gaps and the readers that use them."""

from __future__ import annotations

import pytest

from benchmark import harness, trace
from benchmark.metrics import (convert_ms, device_idle_pct, host_ms,
                               k1_roofline, k2_roofline, prep_device_ms)


class Event:
    """A kineto event as the profiler's results give it."""

    def __init__(self, name, start, end, device="CPU", kind=None):
        self._n, self._s, self._e, self._d, self._k = (name, start, end,
                                                       device, kind)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return f"DeviceType.{self._d}"


class KindedEvent(Event):
    def activity_type(self):
        return self._k


def events(kinded: bool):
    cls = KindedEvent if kinded else Event
    cpu = [cls(trace.CALL, 0, 100, kind="user_annotation"),
           cls(trace.CALL, 120, 200, kind="user_annotation"),
           cls("aten::copy_", 40, 70, kind="cpu_op"),
           cls("aten::copy_", 45, 55, kind="cpu_op")]
    dev = [cls(trace.CALL, 0, 100, "CUDA", "gpu_user_annotation"),
           cls("void ld_sym_kernel<false>(Params)", 10, 30, "CUDA",
               "kernel"),
           cls("unpack", 20, 40, "CUDA", "kernel"),
           cls("Memcpy HtoD (Pageable -> Device)", 50, 60, "CUDA",
               "gpu_memcpy"),
           cls("void split_corr_kernel<true>(Params)", 130, 150, "CUDA",
               "kernel"),
           cls("late", 190, 260, "CUDA", "kernel")]
    return cpu + dev


@pytest.mark.parametrize("kinded", [True, False],
                         ids=["activity_type", "from_name"])
def test_timeline(kinded):
    s = trace.summarize(events(kinded))
    assert s["window_ns"] == (0, 200) and s["calls"] == 2
    # [10, 40] + [50, 60] + [130, 150] + [190, 200]
    assert s["busy_ns"] == 70
    assert s["gaps"] == [(0, 10), (40, 50), (60, 130), (150, 190)]
    ctx = {"trace": s, "calls": [],
           "work": {"k1": {"bound_ms": 1e-5}, "k2": {"bound_ms": 5e-6}}}
    assert device_idle_pct.read(ctx) == pytest.approx(65.0)
    # 20 ns of K1 over 2 calls: 1e-5 ms each
    assert k1_roofline.read(ctx) == pytest.approx(100.0)
    assert k2_roofline.read(ctx) == pytest.approx(50.0)
    # unpack 20 ns and late 10 ns (clipped), over 2 calls
    assert prep_device_ms.read(ctx) == pytest.approx(15e-6)
    # call 1's last kernel ends at 40: idle 10 before, 10 + 40 after; call
    # 2's (clipped) at 200: idle 10 + 40 before, none after
    assert s["call_idle"] == [(10, 50), (50, 0)]
    assert host_ms.read(ctx) == pytest.approx(30e-6)
    assert convert_ms.read(ctx) == pytest.approx(25e-6)
    b = trace.breakdown(s)
    assert dict(b["device_ops"]) == pytest.approx({
        "void ld_sym_kernel<false>(Params)": 20e-9, "unpack": 20e-9,
        "Memcpy HtoD (Pageable -> Device)": 10e-9,
        "void split_corr_kernel<true>(Params)": 20e-9, "late": 10e-9})
    # the 70 ns gap from 60 to 130: the host was in the first call's end
    # and between calls; the 10 ns gap at 45 lies in the inner copy
    idle = dict(b["idle_gaps"])
    assert idle["aten::copy_"] == pytest.approx(10e-9)
    assert sum(idle.values()) == pytest.approx(130e-9)


@pytest.mark.parametrize("name, missing", [
    ("void ld_sym_kernel<true, false, false, true>("
     "(anonymous namespace)::Params)", True),
    ("void ld_sym_kernel<false, true, false, false>("
     "(anonymous namespace)::Params)", False),
    ("void ld_sym_kernel<1, 0, 0, 0>(Params)", True),
])
def test_k1_branch_from_the_kernel_name(name, missing):
    assert bool(harness.K1_MISSING.search(name)) == missing
