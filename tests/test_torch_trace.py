"""The port's spans and counters (``nldsc_tpu_torch.core.timing``):
nothing recorded without a profiler, one tree of spans per traced call of
``compute_ld_scores``, outputs bitwise equal traced or not, the counters
against plain recounts, and the benchmark's readers of them.  On the CPU,
and the ``gpu``-marked case on a CUDA device (it skips without one); the
file imports no JAX, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py
"""

import numpy as np
import pytest
import torch

from benchmark.metrics import (annot_prep_ms, finalize_ms, k1_tile_fill_pct,
                               k2_live_tile_pct, operands_ms, preprocess_ms,
                               to_float64_ms, unpack_ms)
from benchmark.trace import CALL, summarize
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.core import timing
from nldsc_tpu_torch.io.plink import PackedBed, encode_bed_bytes
from nldsc_tpu_torch.ld import (ld_int8, ld_pallas_sym, ld_split, pipeline,
                                windows)

from utils import make_positions, random_genotypes

M, N, B = 300, 150, 64
ROUTES = ("clean", "split", "global")
HOST = {"ld.call", "ld.windows", "ld.transfer", "ld.unpack", "ld.preprocess",
        "ld.operands", "ld.fetch", "ld.to_float64"}
READERS = (unpack_ms, preprocess_ms, operands_ms, finalize_ms,
           annot_prep_ms, to_float64_ms, k1_tile_fill_pct, k2_live_tile_pct)


def _row_missing(rng, m: int, n: int, row_frac: float):
    """Genotypes with missing entries (a tenth) in ``row_frac`` of the
    rows only: the split route's input."""
    g = random_genotypes(rng, m, n, missing_rate=0.0)
    for r in rng.choice(m, size=max(1, int(m * row_frac)), replace=False):
        g[r] = np.where(rng.random(n) < 0.1, np.int8(-1), g[r])
    return g


def _inputs(route: str, annotated: bool, seed: int = 7):
    """Packed rows, positions, config and annotations that take ``route``
    on the CPU, in 5 progress segments of ``B`` rows."""
    rng = np.random.default_rng(seed)
    if route == "clean":
        g = random_genotypes(rng, M, N, missing_rate=0.0)
    elif route == "split":
        g = _row_missing(rng, M, N, row_frac=0.04)
    else:
        g = random_genotypes(rng, M, N, missing_rate=0.05)
    packed = PackedBed(encode_bed_bytes(g), M, N, bool((g < 0).any()))
    cfg = LDConfig(ld_wind=5000, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, block_size=B,
                   split_missing=route == "split" if route != "clean"
                   else None).resolve_rsq(M)
    annot = rng.random((M, 3)) if annotated else None
    return packed, make_positions(M, spacing=500, jitter_rng=rng), cfg, annot


def _run(inputs, traced: bool, calls: int = 1, device: str = "cpu"):
    packed, pos, cfg, annot = inputs
    outs = []

    def go():
        for _ in range(calls):
            with torch.profiler.record_function(CALL):
                outs.append(pipeline.compute_ld_scores(
                    packed, pos, cfg, annot=annot, device=device,
                    progress=lambda done, total: None))

    if not traced:
        go()
        return outs, None
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU] + (
            [act.CUDA] if device == "cuda" else [])) as prof:
        go()
        if device == "cuda":
            torch.cuda.synchronize()
    return outs, prof


@pytest.fixture(autouse=True)
def _fresh():
    timing.reset()
    yield
    timing.reset()


def test_off_records_nothing(monkeypatch):
    """Without a profiler a call enters no range, reads no event and
    records nothing; deferred counts are dropped."""
    def boom(*args, **kwargs):
        raise AssertionError("entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert not timing.tracing()
    packed, pos, cfg, annot = _inputs("split", True)
    pipeline.compute_ld_scores(packed, pos, cfg, annot=annot, device="cpu",
                               progress=lambda done, total: None)
    timing.defer(boom)
    assert timing.calls() == []
    assert timing.span("ld.call", root=True) is timing.span("ld.k1")


def _expected(route: str, annotated: bool) -> set:
    names = set(HOST)
    if route != "clean":
        names.add("ld.route")
    if annotated:
        names.add("ld.annot_prep")
    # the CPU runs clean partitioned scores full band, as the reference
    if route == "clean" and annotated:
        return names | {"ld.pass"}
    names |= {"ld.k1", "ld.finalize"}
    if route == "split":
        names.add("ld.k2")
    return names


@pytest.mark.parametrize("annotated", [False, True], ids=["plain", "annot"])
@pytest.mark.parametrize("route", ROUTES)
def test_traced_call_tree(route, annotated):
    """Each traced call is one ``ld.call`` tree under its own id; every
    span is the root's child, and the trace holds the ``nldsc.ld.*``
    ranges."""
    _, prof = _run(_inputs(route, annotated), True, calls=2)
    got = timing.calls()
    assert [c["id"] for c in got] == [0, 1]
    for call in got:
        spans = call["spans"]
        assert spans[0]["name"] == "ld.call" and spans[0]["parent"] is None
        assert all(s["parent"] == "ld.call" for s in spans[1:])
        assert {s["name"] for s in spans} == _expected(route, annotated)
        transfers = sum(s["name"] == "ld.transfer" for s in spans)
        assert transfers == 1 + annotated
        assert all(s["device_ms"] == s["host_ms"] >= 0 for s in spans)
        assert not any(k.startswith("launches.") for k in call["counters"])
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {timing.PREFIX + n
            for n in _expected(route, annotated)} <= names


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=True), k


@pytest.mark.parametrize("annotated", [False, True], ids=["plain", "annot"])
@pytest.mark.parametrize("route", ROUTES)
def test_outputs_equal_traced(route, annotated):
    inputs = _inputs(route, annotated)
    (off,), _ = _run(inputs, False)
    (on,), _ = _run(inputs, True)
    _equal(off, on)
    assert on["l2"].dtype == np.float64 and on["l2_ws"].dtype == np.int64


@pytest.mark.parametrize("route", ROUTES)
def test_k1_counters_recount(route):
    """``k1.window_pairs`` by a loop over ``hi``; ``k1.tile_pairs`` by a
    loop over the tile bounds K1's launcher takes (``ld_int8.block_hi``)."""
    inputs = _inputs(route, False)
    _run(inputs, True)
    (call,) = timing.calls()
    _, pos, cfg, _ = inputs
    _, hi, _ = windows.window_bounds(pos, cfg.ld_wind)
    assert call["counters"]["k1.window_pairs"] == sum(
        max(int(hi[i]) - i + 1, 0) for i in range(M))
    m_pad = -(-M // B) * B
    hi_pad = np.concatenate([hi, np.full(m_pad - M, -1, np.int32)])
    tile_hi = ld_int8.block_hi(torch.from_numpy(hi_pad), B).tolist()
    assert call["counters"]["k1.tile_pairs"] == B * B * sum(
        max(last - x + 1, 0) for x, last in enumerate(tile_hi))
    assert 0 < call["counters"]["k1.window_pairs"] <= call["counters"][
        "k1.tile_pairs"]


def test_counts_run_after_the_call(monkeypatch):
    """The costlier counts (K2's live tiles, K1's tile pairs) hold no
    call up: they run when ``calls()`` reads the records, once."""
    seen = []
    orig = ld_split.tile_counts
    monkeypatch.setattr(ld_split, "tile_counts",
                        lambda *a: seen.append(1) or orig(*a))
    _run(_inputs("split", False), True)
    assert seen == []
    (call,) = timing.calls()
    assert seen == [1] and call["counters"]["k2.live_tiles"] > 0
    assert call["counters"]["k1.tile_pairs"] > 0
    assert timing.calls()[0]["counters"] == call["counters"] and seen == [1]


def test_k2_counters_recount(monkeypatch):
    """``k2.live_tiles`` equals ``live_tiles`` (on the CPU its plain
    version) summed over the tensors the call builds for K2."""
    seen = {}
    orig = ld_split.split_corrections

    def spy(g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss, rsq_thr,
            own_hi, plan, annot=None, **kw):
        ops = ld_split._operands(g, m_c, h, plan)
        live = ld_split.live_tiles(ops["seg_x"], lo, hi, ops["cidx"],
                                   plan["seg_rows"], plan["p_band"])
        seen.update(live=int(live.sum()), tiles=live.numel(), plan=plan)
        return orig(g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss,
                    rsq_thr, own_hi, plan, annot, **kw)

    monkeypatch.setattr(ld_split, "split_corrections", spy)
    _run(_inputs("split", True), True)
    (call,) = timing.calls()
    c = call["counters"]
    assert c["k2.live_tiles"] == seen["live"] > 0
    assert c["k2.tiles"] == seen["tiles"]
    assert c["k2.contaminated_rows"] == seen["plan"]["n_miss"] > 0
    assert c["k2.compact_cols"] == len(seen["plan"]["miss_idx"])


def test_launches_per_call(monkeypatch):
    """The root span stores the change of the launch totals in its call;
    ``chip_smoke`` reads the same totals."""
    import chip_smoke

    assert chip_smoke.launch_counts is timing.launch_counts
    monkeypatch.setattr(ld_pallas_sym, "device_launches",
                        ld_pallas_sym.device_launches.copy())
    monkeypatch.setattr(ld_pallas_sym, "launches", ld_pallas_sym.launches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span("ld.call", root=True):
            with timing.span("ld.k1"):
                ld_pallas_sym.launches += 2
                ld_pallas_sym.device_launches["cuda:1"] += 2
                timing.defer(lambda: {"k1.tile_pairs": 5})
        timing.defer(lambda: {"k1.tile_pairs": 7})    # no call open
        with timing.span("ld.fetch"):              # outside any call
            pass
    (call,) = timing.calls()
    assert call["counters"] == {"k1.tile_pairs": 5, "launches.ld_sym": 2,
                                "launches.ld_sym_by_device.cuda:1": 2}
    assert [s["parent"] for s in call["spans"]] == [None, "ld.call"]
    assert "k1.tile_pairs 5" in timing.call_line(call)


def test_profiled_logs_each_call(tmp_path, monkeypatch):
    lines = []
    monkeypatch.setattr(pipeline.log, "info",
                        lambda msg, *a: lines.append(msg % a))
    packed, pos, cfg, _ = _inputs("clean", False)
    with pipeline.profiled(str(tmp_path), torch.device("cpu")):
        pipeline.compute_ld_scores(packed, pos, cfg, device="cpu")
    assert (tmp_path / pipeline.TRACE_FILE).exists()
    (line,) = [x for x in lines if x.startswith("Traced call")]
    assert "ld.unpack" in line and "k1.window_pairs" in line


@pytest.mark.parametrize("route", ROUTES)
def test_readers(route):
    """The benchmark's readers of the spans and counters on a traced
    window of two calls; each finds nothing in a window without calls."""
    annotated = route == "clean"
    _, prof = _run(_inputs(route, annotated), True, calls=2)
    ctx = {"calls": [], "trace": summarize(
        prof.profiler.kineto_results.events()), "work": {}}
    got = timing.calls()
    for reader, span in ((unpack_ms, "ld.unpack"),
                         (preprocess_ms, "ld.preprocess"),
                         (operands_ms, "ld.operands")):
        want = np.mean([s["device_ms"] for c in got for s in c["spans"]
                        if s["name"] == span])
        assert reader.read(ctx) == pytest.approx(want)
    assert (finalize_ms.read(ctx) is None) == annotated
    assert to_float64_ms.read(ctx) > 0
    assert (annot_prep_ms.read(ctx) is None) != annotated
    if annotated:          # full band on the CPU: no K1 counters
        assert k1_tile_fill_pct.read(ctx) is None
    else:
        assert 0 < k1_tile_fill_pct.read(ctx) <= 100
    assert (k2_live_tile_pct.read(ctx) is None) == (route != "split")
    for reader in READERS:
        assert reader.read({"calls": [], "trace": {"calls": 0},
                            "work": {}}) is None


@pytest.mark.gpu
@pytest.mark.parametrize("annotated", [False, True], ids=["plain", "annot"])
@pytest.mark.parametrize("route", ROUTES)
def test_cuda_traced_call(route, annotated):
    """On the card: outputs bitwise equal traced or not, one call tree
    whose spans the CUDA events time, K1's and K2's counters, and the
    launches of the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    inputs = _inputs(route, annotated)
    _run(inputs, False, device="cuda")                  # builds the kernels
    (off,), _ = _run(inputs, False, device="cuda")
    (on,), prof = _run(inputs, True, device="cuda")
    _equal(off, on)
    (call,) = timing.calls()
    names = {s["name"] for s in call["spans"]}
    assert {"ld.k1", "ld.finalize", "ld.unpack", "ld.preprocess",
            "ld.operands", "ld.fetch", "ld.to_float64"} <= names
    assert ("ld.k2" in names) == (route == "split")
    assert all(s["device_ms"] >= 0 for s in call["spans"])
    c = call["counters"]
    assert 0 < c["k1.window_pairs"] <= c["k1.tile_pairs"]
    assert c["launches.ld_sym"] >= 1
    if route == "split":
        assert 0 < c["k2.live_tiles"] <= c["k2.tiles"]
        assert c["launches.split_fused"] == 1
    kernels = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {timing.PREFIX + n for n in names} <= kernels
