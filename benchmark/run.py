#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on this machine's CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The inputs are drawn on the card from
``--seed``; one warm-up call builds the kernels (nvcc, into the
checkout's ``build/``) and counts as set-up; then ``compute_ld_scores``
runs back to back for ``--seconds``.  Once the window has closed, the
outputs at seeded rows of every call are held against the plain reference
(``benchmark/reference/``).  The last lines of standard error are the
numbers compared beside their limits; the last line of standard output is
the result: ``--trace 0`` the cell's end-to-end metrics, ``--trace 1``
(the window under ``torch.profiler``) its per-layer metrics.  Exits 2,
printing no result, without a CUDA card; 3 if the process holds JAX or
the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
#: top-level module names the run must not hold (the JAX package's name is
#: a prefix of the port's, so names are compared whole)
FORBIDDEN = {"jax", "jaxlib", "flax", "nldsc_tpu"}


def process_start() -> float:
    """The epoch seconds at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T_IMPORT = time.time()


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port builds its kernels into the checkout's build/ itself; any
    # build cache of torch's own goes to a fixed place beside it
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_ext")
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import harness

    bench, config, workload = harness.load_cell(args.workload)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(bench, args.workload, config, workload, args.seed,
                         args.seconds, bool(args.trace), "cuda", t_process)
    held = forbidden_modules()
    if held:
        print(f"the run holds {held}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    error = result.pop("error")
    if error:
        print(error, file=sys.stderr)
    print(f"build_s {result['build_s']:.3f} (nvcc in this process, within "
          "setup_s)", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
