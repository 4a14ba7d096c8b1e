#!/usr/bin/env python3
"""Run two checkouts of the port on one GPU and compare what they write.

    python3 scripts/compare_checkouts_cuda.py OTHER [--m 65536] [--n 16384]
                                              [--device cuda]

OTHER is the root of another checkout (for example a parent commit
unpacked with ``git archive`` into ``build/``); this script's own checkout
is the second.  Seeded bfiles like ``chip_smoke.py``'s phases 5, 6 and 9
(clean; 2% missing genotypes in every row of the first M/4 SNPs; 2%
missing in 5% of the rows) and phase 11's ``h2`` inputs are written once.
Then, each in its own process with its checkout first on ``sys.path``:

* ``ld -kb 100 -maf 0.01 --extra`` on the card on each bfile, and
  ``--engine f32`` on the clean one, once per checkout;
* ``h2`` on the card on phase 11's inputs, once per checkout;
* in turns (other, this, this, other): the per-SNP scalars of
  ``ld_int8.preprocess_int8`` on the card for the clean codes, a hash of
  ``preprocess.preprocess_block``'s standardized rows (the f32 engine) for
  their first 8,192 rows, and on the host ``finish_preprocess_int8`` from
  their class counts, timed (median of 20 calls, 8 threads).

Every file, scalar and hash must be byte-identical between the two
checkouts on the card; the host scalars are compared and the rows that
differ counted.  The last line is one JSON object of the numbers.
``--device cpu --m 2048 --n 256`` rehearses the script without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FILES = (".L2", ".M", ".M_5_50")


def worker(checkout: str, codes_path: str, out_path: str,
           device: str) -> int:
    """The scalars of one checkout (``--worker CHECKOUT CODES OUT DEV``)."""
    sys.path.insert(0, checkout)
    import torch

    from nldsc_tpu_torch.ld import ld_int8, preprocess

    torch.set_num_threads(8)
    g = np.load(codes_path)
    n = g.shape[1]
    codes = torch.from_numpy(g).to(device)
    ok = torch.ones(len(g), dtype=torch.bool, device=device)
    pre = ld_int8.preprocess_int8(codes, ok, 0.01, n, assume_no_missing=True)
    keys = (*ld_int8.SCAL_FIELDS, "rstd", "maf")
    out = {f"card_{k}": pre[k].cpu().numpy() for k in keys}
    blk = preprocess.preprocess_block(codes[:8192], ok[:8192], 0.01, n)
    out["f32_sha256"] = hashlib.sha256(b"".join(
        blk[k].cpu().numpy().tobytes() for k in ("add", "res", "rstd"))
    ).hexdigest()
    del codes, pre, blk
    counts = [torch.from_numpy(x) for x in (
        (g >= 0).sum(1, dtype=np.float32), (g == 1).sum(1, dtype=np.float32),
        (g == 2).sum(1, dtype=np.float32))]
    host_ok = torch.ones(len(g), dtype=torch.bool)

    def finish():
        return ld_int8.finish_preprocess_int8(
            *counts, float(n) - counts[0], host_ok, 0.01, n)

    finish()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        host = finish()
        times.append(time.perf_counter() - t0)
    out.update({f"host_{k}": host[k].numpy() for k in keys})
    out["host_ms"] = 1e3 * float(np.median(times))
    np.savez(out_path, **out)
    return 0


def run(checkout: Path, args: list, timeout: int = 900) -> float:
    """One command of the port from ``checkout``; its wall seconds."""
    env = dict(os.environ, PYTHONPATH=str(checkout))
    t0 = time.time()
    subprocess.run([sys.executable, *args], cwd=checkout, env=env, check=True,
                   timeout=timeout, stdout=subprocess.DEVNULL)
    return time.time() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--m", type=int, default=65_536)
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from nldsc_tpu_torch.io.plink import write_plink

    card = "the host's CPU (no card)"
    if a.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    (ROOT / "build").mkdir(exist_ok=True)
    trees = {"other": Path(a.other).resolve(), "this": ROOT}
    report = {"card": card, "walls": {}, "host_ms": {}}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        rng = np.random.default_rng(2026)
        t0 = time.time()
        g = chip_smoke.synthetic_genotypes(rng, a.m, a.n, copy_rate=np.repeat(
            rng.uniform(0.3, 0.97, a.m // 512), 512))
        bp = np.arange(1, a.m + 1, dtype=np.int64) * 100
        bfiles = {"clean": write_plink(os.path.join(tmp, "clean"), g, bp=bp)}
        np.save(os.path.join(tmp, "codes.npy"), g)
        m6 = a.m // 4
        g6 = chip_smoke.synthetic_genotypes(rng, m6, a.n, missing_rate=0.02)
        bfiles["global"] = write_plink(os.path.join(tmp, "global"), g6,
                                       bp=bp[:m6])
        del g6
        chip_smoke.inject_row_missing(rng, g, 0.05, 0.02)
        bfiles["split"] = write_plink(os.path.join(tmp, "split"), g, bp=bp)
        del g
        print(f"bfiles written in {time.time() - t0:.1f} s", flush=True)
        ld = ["-m", "nldsc_tpu_torch", "ld", "-kb", "100", "-maf", "0.01",
              "--extra", "--device", a.device]
        cases = {name: ld + ["--bfile", prefix] for name, prefix in
                 bfiles.items()}
        cases["f32"] = cases["clean"] + ["--engine", "f32"]
        for tree, root in trees.items():
            for name, argv in cases.items():
                out = os.path.join(tmp, f"{tree}_{name}.L2")
                report["walls"][f"{tree} ld {name}"] = run(
                    root, argv + ["-o", out])
        h2in = None
        for tree, root in trees.items():
            if h2in is None:
                h2in = chip_smoke.write_h2_inputs(
                    os.path.join(tmp, "this_clean.L2"),
                    os.path.join(tmp, "h2"), rng)
            report["walls"][f"{tree} h2"] = run(root, [
                "-m", "nldsc_tpu_torch", "h2", "--sumstats", h2in["ss"],
                "--ref-ld", h2in["ld"], "--w-ld", h2in["ld"], "--device",
                a.device, "-s", os.path.join(tmp, f"{tree}_h2.json")])
        same = {}
        for name in cases:
            same[f"ld {name}"] = all(
                Path(tmp, f"other_{name}{s}").read_bytes()
                == Path(tmp, f"this_{name}{s}").read_bytes() for s in FILES)
        same["h2"] = (Path(tmp, "other_h2.json").read_bytes()
                      == Path(tmp, "this_h2.json").read_bytes())
        scal = {}
        for i, tree in enumerate(("other", "this", "this", "other")):
            out = os.path.join(tmp, f"scal{i}.npz")
            run(ROOT, [str(Path(__file__).resolve()), "--worker",
                       str(trees[tree]), os.path.join(tmp, "codes.npy"),
                       out, a.device])
            scal.setdefault(tree, dict(np.load(out)))
            report["host_ms"].setdefault(tree, []).append(
                float(np.load(out)["host_ms"]))
    o, t = scal["other"], scal["this"]
    card_keys = [k for k in o if k.startswith("card_")]
    same["card scalars"] = all(np.array_equal(o[k], t[k], equal_nan=True)
                               for k in card_keys)
    same["f32 rows"] = str(o["f32_sha256"]) == str(t["f32_sha256"])
    report["host_rows_differing"] = {
        k[5:]: int((~((o[k] == t[k]) | (np.isnan(o[k]) & np.isnan(t[k]))))
                   .sum()) for k in o if k.startswith("host_")
        and k != "host_ms"}
    report["same"] = same
    for k, v in same.items():
        print(f"{k}: {'byte-identical' if v else 'DIFFERS'}")
    print(f"host finish_preprocess_int8 at M={a.m}: "
          f"{report['host_ms']} ms (median of 20; other, this, this, other); "
          f"host scalar rows that differ: {report['host_rows_differing']}; "
          f"walls {report['walls']}; on {card}")
    print(json.dumps(report))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(*sys.argv[2:6]))
    sys.exit(main())
