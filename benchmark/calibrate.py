#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on one CUDA card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 3] [--seconds 2] [--out FILE]

Per seed, in one process: the cell's set-up, a short window of calls
through the timed path at the cell's own size, and the numbers of
``check.py`` for the program against the plain reference at the rows a
run checks (the lower readings); for the first ``--control`` seeds also
the lower-precision control (the reference with its epilogue in bfloat16,
``reference/ld.py``) in the program's place (the upper readings).  One
JSON line per seed, then one with the largest program reading and the
smallest control reading of each number.  The benchmark's runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    from benchmark import harness
    from benchmark.check import readings

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _, config, workload = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    lower, upper, lines = {}, {}, []
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        inputs = harness.setup(config, workload, seed, dev)
        blocks = harness.checked_blocks(config["n_snps"], workload["check"],
                                        seed)
        rows = np.concatenate([np.arange(a, b) for a, b in blocks])
        harness.call(inputs, dev)                          # warm-up
        got = harness.window(inputs, args.seconds, rows, dev)
        if got["failed"]:
            print(got["error"], file=sys.stderr)
            return 1
        torch.cuda.empty_cache()
        ref = harness.reference_rows(inputs, blocks, dev)
        line = {"seed": seed, "calls": len(got["kept"]),
                "program": readings(got["kept"], ref)}
        for q, v in line["program"].items():
            lower[q] = max(lower.get(q, v), v)
        if k < args.control:
            ctl = harness.reference_rows(inputs, blocks, dev, torch.bfloat16)
            line["control"] = readings([ctl], ref)
            for q, v in line["control"].items():
                upper[q] = min(upper.get(q, v), v)
        lines.append(line)
        print(json.dumps(line), flush=True)
        del inputs, got, ref
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "lower": lower, "upper": upper,
               "card": torch.cuda.get_device_name(dev)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
