"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

The window calls ``nldsc_tpu_torch.ld.pipeline.compute_ld_scores`` as the
port's ``estimate_lds`` calls it after ``ds.bed.read_raw()``: a
``PackedBed`` of the chromosome's ``.bed`` rows in pageable host memory,
its window coordinates, ``LDConfig(...).resolve_rsq(M)`` with the cell's
settings, the annotations as ``read_annot`` returns them (float64), the
device, and a progress callable (``estimate_lds`` passes one at M >=
20,000, so that K1 runs in its progress segments).  Calls run back to back
until the window's seconds have passed; every call computes one whole
chromosome.
"""

from __future__ import annotations

import importlib
import json
import re
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .check import readings, verdict
from .gen import chromosome
from .metrics import K1_KERNELS, K2_KERNELS
from .reference import ld as reference
from .trace import breakdown, summarize
from .work import roofline

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: K1's 8-product instantiation (``ld_sym_kernel<MISSING, ...>`` with
#: MISSING true), as the trace names it
K1_MISSING = re.compile(r"ld_sym_kernel<\s*(true|1)\b")


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """``(bench, config, workload)`` of the cell ``name``: the entries of
    ``BENCHMARK.json`` and the files they name."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / entry["file"]).read_text())
    workload = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
    return bench, config, workload


def checked_blocks(m: int, spec: dict, seed: int) -> list:
    """The ``(first, end)`` row ranges whose outputs are checked: the
    chromosome's first and last ``rows`` rows and ``blocks - 2`` more
    ranges at seeded places, none overlapping."""
    rows, count = spec["rows"], spec["blocks"]
    slots = m // rows
    rng = np.random.default_rng(chromosome.seed_of(seed, 3))
    inner = rng.choice(np.arange(1, slots - 1), size=min(count - 2,
                                                         slots - 2),
                       replace=False)
    starts = sorted({0, slots - 1, *inner.tolist()})
    return [(s * rows, min((s + 1) * rows, m)) for s in starts]


def setup(config: dict, workload: dict, seed: int, device) -> dict:
    """The inputs of every call, made from ``seed``: the packed rows
    (drawn on ``device``, fetched once), the window coordinates, the
    annotations and the program's ``LDConfig``."""
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PackedBed
    from nldsc_tpu_torch.ld.pipeline import wants_streaming

    m, n = config["n_snps"], config["n_samples"]
    device = torch.device(device)
    if device.type == "cuda" and wants_streaming(m, n, device):
        raise SystemExit(f"{m} x {n} streams on this card: estimate_lds "
                         "would not call compute_ld_scores in core")
    raw, has_missing = chromosome.packed_chromosome(config, workload, seed,
                                                    device)
    ld = config["ld"]
    return {
        "packed": PackedBed(raw, m, n, has_missing),
        "positions": chromosome.positions(config),
        "annot": chromosome.annotations(workload, m, seed, device),
        "config": LDConfig(**ld).resolve_rsq(m),
    }


def _no_progress(done: int, total: int) -> None:
    """The progress callable of the calls: the benchmark shows nothing."""


def call(inputs: dict, device) -> tuple[dict, dict]:
    """One call of ``compute_ld_scores``: its outputs, and the
    benchmark's clock around it (``host_s``) beside the program's
    ``transfer_s`` and ``device_s`` spans."""
    from nldsc_tpu_torch.core.timing import STAGE_TIMES
    from nldsc_tpu_torch.ld import pipeline

    STAGE_TIMES.clear()
    t0 = time.perf_counter()
    out = pipeline.compute_ld_scores(
        inputs["packed"], inputs["positions"], inputs["config"],
        annot=inputs["annot"], device=torch.device(device),
        progress=_no_progress)
    host_s = time.perf_counter() - t0
    return out, {"host_s": host_s,
                 "transfer_s": STAGE_TIMES.get("transfer_s", 0.0),
                 "device_s": STAGE_TIMES.get("device_s", 0.0)}


def window(inputs: dict, seconds: float, rows: np.ndarray, device) -> dict:
    """Calls back to back until ``seconds`` have passed since the first
    started; per call its outputs at ``rows`` and its times.  A call that
    raises ends the window."""
    from torch.profiler import record_function

    kept, times, failed, error = [], [], 0, None
    t0 = time.perf_counter()
    t_end = t0
    while time.perf_counter() - t0 < seconds:
        try:
            with record_function("bench.ld_call"):
                out, t = call(inputs, device)
        except Exception:  # noqa: BLE001 - reported as a failed call
            failed += 1
            error = traceback.format_exc()
            break
        t_end = time.perf_counter()
        kept.append({k: v[rows] for k, v in out.items()})
        times.append(t)
        del out
    return {"kept": kept, "times": times, "attempted": len(times) + failed,
            "failed": failed, "error": error, "start": t0, "end": t_end}


def cell_work(inputs: dict, summary: dict, device) -> dict:
    """The bounds of K1 and K2 on the cell's inputs, from
    ``work/roofline.py``: K1's for the branch that the trace shows ran
    (its 8-product instantiation or the clean one), K2's where its kernel
    ran; None for a kernel the trace does not hold."""
    names = {n for n, *_ in summary.get("device", ())}
    packed, cfg = inputs["packed"], inputs["config"]
    m, n = packed.shape
    lo, hi = reference.window_bounds(inputs["positions"], cfg.ld_wind)
    hi_t = torch.from_numpy(hi.astype(np.int32)).to(device)
    k1 = k2 = None
    if any(k in name for name in names for k in K1_KERNELS):
        missing = any(K1_MISSING.search(name) for name in names)
        k1 = roofline.k1_work(hi_t, n, missing, cfg.int8_dot_dtype)
        if inputs["annot"] is not None:
            k1 = roofline.k1_annot_work(k1, m, inputs["annot"].shape[1],
                                        cfg.int8_dot_dtype)
    if any(K2_KERNELS[0] in name for name in names):
        usable, rowmiss = reference.row_flags(packed.raw, n, cfg.maf_thr,
                                              device)
        k2 = roofline.k2_work(
            torch.from_numpy(lo).to(device), hi_t,
            torch.from_numpy(usable).to(device),
            torch.from_numpy(rowmiss).to(device), n, cfg.int8_dot_dtype)
    return {"k1": k1, "k2": k2}


def host_pages(arr: np.ndarray) -> dict:
    """The resident and the transparent-huge-page kB of the host mappings
    that hold ``arr``'s buffer (``/proc/self/smaps``); {} where that file
    cannot be read."""
    a0 = arr.ctypes.data
    a1 = a0 + arr.nbytes
    out, hit = {"rss_kb": 0, "anon_huge_kb": 0}, False
    keys = {"Rss:": "rss_kb", "AnonHugePages:": "anon_huge_kb"}
    try:
        with open("/proc/self/smaps") as f:
            for line in f:
                head = line.split(None, 1)[0]
                if "-" in head and not head.endswith(":"):
                    lo, hi = (int(x, 16) for x in head.split("-"))
                    hit = lo < a1 and hi > a0
                elif hit and head in keys:
                    out[keys[head]] += int(line.split()[1])
    except (OSError, ValueError):
        return {}
    return out


def reference_rows(inputs: dict, blocks: list, device,
                   epilogue=torch.float64) -> dict:
    """The plain reference at the checked rows (``epilogue`` bfloat16:
    the lower-precision control)."""
    cfg, packed = inputs["config"], inputs["packed"]
    return reference.ld_rows(
        packed.raw, packed.n_samples, inputs["positions"], cfg.ld_wind,
        cfg.maf_thr, cfg.std_thr, cfg.rsq_thr, blocks, inputs["annot"],
        device, epilogue)


def per_layer(bench: dict, name: str, ctx: dict) -> dict:
    """The cell's per-layer metrics, each read by ``metrics/<metric>.py``;
    a reader that finds nothing leaves its metric out."""
    out = {}
    for spec in bench["per_layer"]:
        if name not in spec.get("workloads", [name]):
            continue
        mod = importlib.import_module(f"benchmark.metrics.{spec['name']}")
        value = mod.read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def run(bench: dict, name: str, config: dict, workload: dict, seed: int,
        seconds: float, trace: bool, device, t_process: float) -> dict:
    """One run of the cell ``name``: its result's fields, and ``checks``
    (each number compared beside its limit), ``build_s`` (the nvcc builds
    of this process) and ``error``."""
    dev = torch.device(device)
    t0 = time.time()
    inputs = setup(config, workload, seed, dev)
    blocks = checked_blocks(config["n_snps"], workload["check"], seed)
    rows = np.concatenate([np.arange(a, b) for a, b in blocks])
    t1 = time.time()
    call(inputs, dev)                                      # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    pages = {"start": host_pages(inputs["packed"].raw)}
    prof = None
    if trace:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CPU] + (
            [act.CUDA] if dev.type == "cuda" else []))
        prof.start()
    t_window = time.time()
    parts = {"before_s": t0 - t_process, "inputs_s": t1 - t0,
             "warmup_s": t_window - t1}
    got = window(inputs, seconds, rows, dev)
    if prof is not None:
        prof.stop()
    pages["end"] = host_pages(inputs["packed"].raw)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_rows(inputs, blocks, dev)
    read = readings(got["kept"], ref) if got["kept"] else {}
    ok, table = verdict(read, workload["limits"])
    m = config["n_snps"]
    if trace:
        summary = summarize(prof.profiler.kineto_results.events())
        ctx = {"calls": got["times"], "trace": summary,
               "work": cell_work(inputs, summary, dev)}
        metrics = per_layer(bench, name, ctx)
        extra = {"busy_s": summary.get("busy_ns", 0) / 1e9,
                 "window_s": (summary["window_ns"][1]
                              - summary["window_ns"][0]) / 1e9
                 if summary.get("calls") else 0.0}
    else:
        elapsed = got["end"] - got["start"]
        metrics = {
            "ld_snps_per_s": {"value": m * len(got["times"]) / elapsed
                              if got["times"] else 0.0, "unit": "SNP/s"},
            "ld_peak_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": t_window - t_process, "unit": "s"},
        }
        extra, summary = {}, None
    from nldsc_tpu_torch import _build

    result = {
        "correct": bool(ok and got["failed"] == 0 and got["kept"]),
        "attempted": got["attempted"], "failed": got["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **extra},
    }
    if summary is not None and summary.get("calls"):
        result["breakdown"] = breakdown(summary)
    if summary is not None:
        result["trace_kinds"] = summary["kinds"]
    result["setup_parts"] = parts
    result["call_s"] = [round(t["host_s"], 4) for t in got["times"]]
    result["transfer_s"] = [round(t["transfer_s"], 4) for t in got["times"]]
    result["host_pages"] = pages
    result["build_s"] = sum(v.get("seconds", 0.0)
                            for v in _build.BUILD_INFO.values())
    result["checks"] = {k: {q: (v if v is None or np.isfinite(v) else 1e300)
                            for q, v in row.items()}
                        for k, row in table.items()}
    result["error"] = got["error"]
    return result
