"""Every configuration, workload and metric of ``BENCHMARK.json`` loads
by its name, and the file keeps to the benchmark's contract."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    config = json.loads((REPO / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    for key in ("n_snps", "n_samples", "map", "ld", "maf", "copy_rate",
                "rate_span"):
        assert key in config, key
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_loads(cell):
    from benchmark import harness

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and len(cell["why"]) <= 200
    _, config, workload = harness.load_cell(cell["name"])
    assert workload["config"] == cell["config"] == config["name"]
    assert workload["traffic"] == cell["traffic"]
    assert set(workload["limits"]) >= {"l2", "l2d", "maf", "rstd",
                                       "counters"}
    reported = [m for m in BENCH["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert reported, "every cell reports a per-layer metric"


@pytest.mark.parametrize("spec", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(spec):
    assert NAME.match(spec["name"])
    assert spec["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(spec.get("workloads", cells)) <= cells
    if "bound" in spec:
        assert spec["source"] in ("host_clock", "device_trace")
        assert 0.01 <= spec["bound"] <= 0.25
    else:
        assert spec["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        mod = importlib.import_module(f"benchmark.metrics.{spec['name']}")
        assert callable(mod.read)
        assert mod.read({"calls": [], "trace": {"calls": 0},
                         "work": {"k1": None, "k2": None}}) is None
