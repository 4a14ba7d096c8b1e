#!/usr/bin/env python3
"""Run two checkouts of the port on one GPU and compare what they write.

    python3 scripts/compare_checkouts_cuda.py OTHER [--m 65536] [--n 16384]
                                              [--device cuda]
    python3 scripts/compare_checkouts_cuda.py OTHER --k1 [--also DIR ...]
                                              [--reps 5] [--library]
                                              [--k1-shapes n16384,MxN,...]

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

With ``--k1`` the script compares kernel K1 (``csrc/ld_sym.cu``) alone,
each checkout building its own: in turns (other, this, the ``--also``
checkouts, then back in reverse: other, this, this, other without them),
one process each, seeded random codes made on the card (MAF 0.05-0.5, 2%
missing for the 8-product branch, windows of +-1000 SNPs) at three
shapes: M = 65,536 x N = 16,384 (``chip_smoke.py`` phase 7's shape; also
53 seeded annotations and bf16 operands; there also K1's device time
over the 16 progress segments, the host time of a pass with progress
before its first launch and of one launch), M = 8,192 x N = 315,599
(phase 32's; also annotated and bf16) and M = 32,768 x N = 300,032
(``scripts/ukb_width_cuda.py`` run f's).  Each process hashes every
output of every instantiation it runs (``sym_partials``'s fpart, ipart
and apart, the folded credits, and at every shape the pass in 16
progress segments, ``sym_credits_segmented``, and the pass as one
launch per wave of resident CTAs, ``range_partials``) and times
``sym_credits``, the segmented pass and the wave launches with CUDA
events after a warm-up (the mean of ``--reps``).  Every hash must
be equal across the checkouts and runs; the times are printed per run
beside the card's name and power limit, with each checkout's cluster
shape and resident clusters where it has them.  ``--library`` also times
``torch._int_mm`` on exactly K1's products at the two wide shapes
(``chip_smoke.k1_products_library_ms``), in this checkout's first run.
``--k1-shapes`` picks the shapes: the names above, or ``MxN`` for more
widths, whose codes run plain on int8 and bf16 operands.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
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


#: K1's shapes: name -> (M, N, half window in SNPs)
K1_SHAPES = {"n16384": (65_536, 16_384, 1000),
             "phase32": (8_192, 315_599, 1000),
             "width": (32_768, 300_032, 1000)}
K1_P = 53        # the baseline model's annotations


def k1_inputs(torch, ld_int8, pad, m: int, n: int, half: int,
              missing_rate: float, seed: int, dev):
    """K1's arguments for seeded random codes made on ``dev`` (as
    ``scripts/time_ld_sym_cuda.py`` makes them), preprocessed by the
    checkout's ``ld_int8``; ``pad`` its ``padded_shape``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m_pad, n_pad = pad(m, n)
    has_missing = missing_rate > 0
    codes = torch.full((m_pad, n_pad), -1 if has_missing else 0,
                       dtype=torch.int8, device=dev)
    for r in range(0, m, 4096):
        c = min(4096, m - r)
        p = torch.rand((c, 1), generator=gen, device=dev) * 0.45 + 0.05
        x = sum((torch.rand((c, n), generator=gen, device=dev) < p)
                .to(torch.int8) for _ in range(2))
        if has_missing:
            x[torch.rand((c, n), generator=gen, device=dev)
              < missing_rate] = -1
        codes[r:r + c, :n] = x
    ok = torch.zeros(m_pad, dtype=torch.bool, device=dev)
    ok[:m] = True
    pre = ld_int8.preprocess_int8(codes, ok, 0.01, n,
                                  assume_no_missing=not has_missing)
    del codes
    rows = torch.arange(m_pad, device=dev, dtype=torch.int32)
    lo = torch.where(rows < m, (rows - half).clamp(min=0),
                     torch.full_like(rows, m_pad))
    hi = torch.where(rows < m, (rows + half).clamp(max=m - 1),
                     torch.full_like(rows, -1))
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    return (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            lo.contiguous(), hi.contiguous(), pre["usable"], dom_ok,
            pre["add_sd_zero"])


def k1_worker(checkout: str, out_path: str, reps: int, library: bool,
              shapes: list) -> int:
    """K1's hashes and times in one checkout (``--k1-worker CHECKOUT OUT
    REPS LIBRARY SHAPES``)."""
    sys.path.insert(0, checkout)
    import torch

    from nldsc_tpu_torch import _build
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym
    from nldsc_tpu_torch.ld.pipeline import padded_shape

    dev = torch.device("cuda")
    rsq = 1e-3
    _build.build("ld_sym")
    log = _build.BUILD_INFO["ld_sym"]["log"]
    out = {"checkout": checkout, "hashes": {}, "ms": {}, "shapes": {},
           "cluster": getattr(ld_pallas_sym, "CLUSTER", None),
           "registers": sorted({int(x) for x in re.findall(
               r"Used (\d+) registers", log)}),
           "spill_bytes": sum(int(x) for x in re.findall(
               r"(\d+) bytes spill", log))}
    if hasattr(ld_pallas_sym, "max_active_clusters"):
        out["max_clusters"] = ld_pallas_sym.max_active_clusters(
            dev, False, False, False)
        out["max_ctas_unclustered"] = ld_pallas_sym.max_active_clusters(
            dev, False, False, False, False)

    def digest(*xs) -> str:
        h = hashlib.sha256()
        for x in xs:
            if x is not None:
                h.update(x.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_ms(fn) -> float:
        """K1's device milliseconds a call of ``fn`` (profiler)."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if "ld_sym_kernel" in e.key) / 1e3 / reps

    def plan_ms(seg) -> float:
        """Host milliseconds of a pass with progress before its first
        launch (its band, its waves, its partials): the median of
        ``reps``, the device idle at the call."""
        times = []
        for _ in range(reps):
            marks = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seg(tick=lambda done, total: marks.append(time.perf_counter()))
            times.append(1e3 * (marks[0] - t0))
        return float(np.median(times))

    def launch_host_ms(x, band, T, kw) -> float:
        """Host milliseconds a ``range_partials`` launch takes to enqueue:
        16 launches over equal ranges of the tiles, the device idle at
        the first; the median of ``reps``."""
        nt = x[0].shape[0] // T
        cuts = [nt * i // 16 for i in range(17)]
        parts = ld_pallas_sym.new_partials(nt, band, T, 0, dev)
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x0, x1 in zip(cuts, cuts[1:]):
                ld_pallas_sym.range_partials(
                    *x, rsq, x0, x1, band=band, block_size=T,
                    out=tuple(None if p is None else p[x0:x1]
                              for p in parts), **kw)
            times.append(1e3 * (time.perf_counter() - t0) / 16)
            torch.cuda.synchronize()
        return float(np.median(times[1:]))

    def wave_launches(x, band, T, kw, has_missing):
        """The pass as one ``range_partials`` launch per wave of the
        checkout's grid (its CTAs per tile and resident CTAs, whole
        cluster pairs where it clusters) into one set of partials, one
        fold: (the credits' hash, milliseconds, launches)."""
        nt = x[0].shape[0] // T
        tile_hi = ld_int8.block_hi(x[5], T).tolist()
        if hasattr(ld_pallas_sym, "cluster_tile_ctas"):
            shape = ld_pallas_sym.cluster_shape(
                x[0].shape[1], has_missing, x[0].dtype == torch.bfloat16)
            wave = shape[0] * shape[1] * ld_pallas_sym.max_active_clusters(
                dev, has_missing, False, x[0].dtype == torch.bfloat16,
                shape != (1, 1))
            ctas = ld_pallas_sym.cluster_tile_ctas(tile_hi, nt, nt, band,
                                                   shape)
            bounds = ld_pallas_sym.wave_bounds(
                ctas, min(nt, -(-sum(ctas) // wave)), wave, shape[0])
        else:
            wave = torch.cuda.get_device_properties(
                dev).multi_processor_count
            ctas = [max(0, min(h, nt - 1) - i + 1)
                    for i, h in enumerate(tile_hi)]
            bounds = ld_pallas_sym.wave_bounds(
                ctas, min(nt, -(-sum(ctas) // wave)), wave)

        def run():
            parts = ld_pallas_sym.new_partials(nt, band, T, 0, dev)
            for x0, x1 in zip(bounds, bounds[1:]):
                ld_pallas_sym.range_partials(
                    *x, rsq, x0, x1, band=band, block_size=T,
                    out=tuple(None if p is None else p[x0:x1]
                              for p in parts), **kw)
            return ld_pallas_sym.fold_partials(*parts)

        return digest(*run()), cuda_ms(run), len(bounds) - 1

    def pad(m, n):
        return padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)

    for shape in shapes:
        m, n, half = K1_SHAPES.get(shape) or (*map(int, shape.split("x")),
                                              1000)
        for has_missing in (False, True):
            branch = "8prod" if has_missing else "clean"
            args = k1_inputs(torch, ld_int8, pad, m, n, half,
                             0.02 if has_missing else 0.0, 2026, dev)
            T = ld_pallas_sym.tile(has_missing)
            band = ld_int8.band_extent(args[5], T)[1]
            out["hashes"][f"{shape} {branch} inputs"] = digest(
                *args[3:], args[0][:, :4096], args[2][:, -4096:])
            if hasattr(ld_pallas_sym, "cluster_shape"):
                for bf16 in (False, True):
                    out["shapes"][f"{shape} {branch}{' bf16' * bf16}"] = \
                        ld_pallas_sym.cluster_shape(args[0].shape[1],
                                                    has_missing, bf16)
            runs = [("", None, False)]
            if shape not in K1_SHAPES:
                runs.append((" bf16", None, True))
            if shape in ("n16384", "phase32"):
                gen = torch.Generator(device=dev)
                gen.manual_seed(7)
                a = torch.rand((args[0].shape[0], K1_P), generator=gen,
                               device=dev)
                a[:, 0] = 1.0
                a[m:] = 0.0
                runs += [(" annot", a, False), (" bf16", None, True),
                         (" bf16 annot", a, True)]
            for tag, annot, bf16 in runs:
                x = args
                if bf16:        # one .to a code matrix, aliases kept
                    ops = {"g": args[0], "m": args[1], "h": args[2]}
                    ld_int8.to_operands(ops, "bf16")
                    x = (ops["g"], ops["m"], ops["h"], *args[3:])
                kw = dict(n_samples=n, has_missing=has_missing)
                parts = ld_pallas_sym.sym_partials(
                    *x, rsq, band=band, block_size=T, annot=annot, **kw)
                key = f"{shape} {branch}{tag}"
                out["hashes"][key + " partials"] = digest(*parts)
                out["hashes"][key + " credits"] = digest(
                    *ld_pallas_sym.fold_partials(*parts))
                del parts
                out["ms"][key] = cuda_ms(lambda: ld_pallas_sym.sym_credits(
                    *x, rsq, block_size=T, annot=annot, **kw))
                if not tag:
                    def seg(x=x, kw=kw, tick=lambda done, total: None):
                        return ld_pallas_sym.sym_credits_segmented(
                            *x, rsq, block_size=128, n_rows=m,
                            progress=tick, **kw)

                    out["hashes"][key + " segments"] = digest(*seg())
                    out["ms"][key + " segments"] = cuda_ms(seg)
                    h, ms, n_l = wave_launches(x, band, T, kw, has_missing)
                    out["hashes"][key + " wave launches"] = h
                    out["ms"][f"{key} in {n_l} wave launches"] = ms
                    if h != out["hashes"][key + " credits"] or out["hashes"][
                            key + " segments"] != h:
                        raise SystemExit(f"{checkout}: {key}: the segments "
                                         "or wave launches differ from one "
                                         "launch")
                if shape == "n16384" and not tag:
                    out["ms"][key + " segments K1 device"] = kernel_ms(seg)
                    out["ms"][key + " segments host plan"] = plan_ms(seg)
                    out["ms"][key + " host a launch"] = launch_host_ms(
                        x, band, T, kw)
                del x
            if library and shape in ("phase32", "width"):
                import chip_smoke

                lib = chip_smoke.k1_products_library_ms(
                    torch, args, has_missing, T, reps)
                out["ms"][f"{shape} {branch} torch._int_mm products"] = \
                    lib["ms"]
                out["ms"][f"{shape} {branch} torch._int_mm stacked "
                          f"({lib['stacked_ops'] / lib['ops']:.2f}x)"] = \
                    lib["stacked_ms"]
            del args
            torch.cuda.empty_cache()
            print(f"{checkout}: {shape} {branch} done", flush=True)
    Path(out_path).write_text(json.dumps(out))
    return 0


def k1_main(trees: dict, reps: int, library: bool, card: str,
            shapes: list) -> int:
    """K1 in turns over ``trees`` (label -> root): hashes equal, times
    per run."""
    labels = list(trees)
    order = labels + labels[::-1] if len(labels) > 2 else [
        "other", "this", "this", "other"]
    runs = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i, label in enumerate(order):
            out = os.path.join(tmp, f"k1_{i}.json")
            lib = library and label == "this" and "this" not in order[:i]
            t0 = time.time()
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--k1-worker", str(trees[label]), out, str(reps),
                            str(int(lib)), ",".join(shapes)], cwd=ROOT,
                           check=True, timeout=1800)
            r = json.loads(Path(out).read_text())
            r["label"], r["wall_s"] = label, time.time() - t0
            runs.append(r)
            print(f"[{i}] {label}: cluster {r['cluster']}, resident "
                  f"{r.get('max_clusters')}, registers {r['registers']}, "
                  f"spill bytes {r['spill_bytes']}; " + "; ".join(
                      f"{k} {v:.3f} ms" for k, v in r["ms"].items())
                  + f"; on {card}", flush=True)
    ref = runs[0]["hashes"]
    differ = sorted({k for r in runs for k, v in r["hashes"].items()
                     if v != ref.get(k)})
    print(f"K1 outputs: {len(ref)} hashes, "
          + ("byte-identical in every run and checkout" if not differ
             else f"DIFFER: {differ}"))
    print(json.dumps({"card": card, "k1_runs": [
        {k: r[k] for k in ("label", "cluster", "max_clusters",
                           "max_ctas_unclustered", "registers",
                           "spill_bytes", "shapes", "ms", "wall_s")
         if k in r}
        for r in runs], "differ": differ}))
    return 1 if differ else 0


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
    ap.add_argument("--k1", action="store_true",
                    help="compare and time kernel K1 alone, in turns")
    ap.add_argument("--also", nargs="*", default=[],
                    help="more checkouts timed in the K1 turns")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--library", action="store_true",
                    help="time torch._int_mm on K1's products (--k1)")
    ap.add_argument("--k1-shapes", default=",".join(K1_SHAPES),
                    help="K1's shapes: names of K1_SHAPES or MxN")
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
    if a.k1:
        trees.update({Path(d).name: Path(d).resolve() for d in a.also})
        return k1_main(trees, a.reps, a.library, card,
                       a.k1_shapes.split(","))
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
    if sys.argv[1:2] == ["--k1-worker"]:
        sys.exit(k1_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                           sys.argv[5] == "1", sys.argv[6].split(",")))
    sys.exit(main())
