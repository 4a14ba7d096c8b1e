"""Shared helpers of the benchmark's tests: the repository on the path,
cells shrunk to a size a test run holds, and the card fixture."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread a test process: the driver's runs start several
# workers, and the CPU twins' small ops slow down tenfold oversubscribed
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = ("ukb_hm3.split", "kg_eur.bld97", "ukb_hm3.global")


def tiny_cell(name: str, m: int = 1024, n: int = 203) -> tuple:
    """``(bench, config, workload)`` of the cell ``name`` at ``m`` SNPs by
    ``n`` samples: the cell's files with the sizes cut, windows of about
    +-100 SNPs, and 4 checked blocks of 64 rows."""
    from benchmark import harness

    bench, config, workload = harness.load_cell(name)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config["n_snps"], config["n_samples"] = m, n
    if config["map"]["metric"] == "bp":
        config["ld"]["ld_wind"] = 100.0 * config["map"]["spacing"]
    else:
        config["map"]["total"] = m / 100.0
        config["ld"]["ld_wind"] = 1.0
    if workload.get("annotations"):
        workload["annotations"] = dict(workload["annotations"], p=9, binary=5)
    workload["check"] = {"blocks": 4, "rows": 64}
    return bench, config, workload


@pytest.fixture
def cuda():
    """The card, or a skip without one (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
