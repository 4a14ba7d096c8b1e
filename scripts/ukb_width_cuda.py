#!/usr/bin/env python3
"""``ld`` at UK Biobank width on one NVIDIA GPU: the PyTorch port
(``nldsc_tpu_torch``) on a chromosome of M = 65,536 SNPs x N = 300,032
samples, through its CLI and API.

    python3 scripts/ukb_width_cuda.py [--out-dir DIR]

The bfile is drawn on the card from seed 2026 by
``chip_smoke.write_chromosome`` (``chip_smoke.py``'s local-LD model: MAF U(0.05, 0.5), each SNP copying its predecessor at a
rate drawn from U(0.3, 0.97) per 512 SNPs; 5% of the genotypes missing in
every 50th SNP, 2% of the rows), packed into .bed bytes on the card and
written in blocks of rows, so host memory stays bounded.  SNPs are 100 bp
apart and every run uses ``-kb 100`` (+-1000 SNPs).  Then:

  a. ``ld --bfile`` with no route flag: the route ``wants_streaming``
     picks, run to its end;
  b. ``ld --streaming --chunk-rows 8192 --resume CK`` (the split route:
     K1 clean per band, K2 per contaminated band): every .L2 row finite;
     the row-missing scan timed apart;
  c. b's checkpoint with shards 3-7 deleted, rerun: the .L2
     byte-identical to b's, and the cached row-missing flags read;
  d. ``ld --annot --streaming`` with 53 seeded annotations;
  e. in core on the first 32,768 SNPs (``compute_ld_scores``):
     the split, global and clean routes (the clean one on a copy of the
     rows with every missing genotype set to 0), each route's peak device
     bytes per padded genotype beside ``INCORE_BYTES_PER_GENOTYPE``, split
     and global counters equal, and the same rows streamed: counters
     equal, l2/l2d within tests/test_golden.py's tolerances;
  f. K1 clean, K1 8-product (m = 0 on the clean rows) and K2
     (``split_corrections``) alone on e's inputs, CUDA events after a
     warm-up, with their bounds (``chip_smoke.k1_work``/``k2_work``), K1's
     cluster shape and resident clusters, ``torch._int_mm`` on exactly
     K1's products (``chip_smoke.k1_products_library_ms``) and
     each checked against its twin on a 512-row window at full N
     (counters equal, sums within ``chip_smoke.KERNEL_TOL``).

Every run prints its wall, ``STAGE_TIMES``, peak device memory, route and
kernel launches, beside the card's name and power limit; any failed check
raises, and the script exits non-zero, as it does without a CUDA device.
No JAX: the card has none.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

M, N = 65_536, 300_032
#: run e's rows, in core
INCORE_M = 32_768
SEED = 2026
CHUNK_ROWS = 8192
DEV = torch.device("cuda")


def reset() -> int:
    """Reset the card's peak counter; the bytes allocated now."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak(base: int) -> int:
    """Peak bytes allocated above ``base`` since :func:`reset`."""
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def host_peak_gib() -> float:
    """This process's peak resident host memory (GiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def ld_run(argv: list) -> dict:
    """``ld`` through the port's CLI (``chip_smoke.run_ld``), with the
    seconds spent in ``format_table``."""
    from nldsc_tpu_torch.io import ldscores

    fmt = {"s": 0.0}
    inner = ldscores.format_table

    def timed(*a, **kw):
        t0 = time.time()
        try:
            return inner(*a, **kw)
        finally:
            fmt["s"] += time.time() - t0

    ldscores.format_table = timed
    try:
        r = cs.run_ld(torch, argv)
    finally:
        ldscores.format_table = inner
    r["format_s"] = fmt["s"]
    r["route"] = [ln for ln in r["log"].lines if ln.startswith("LD route")]
    return r


def report(tag: str, r: dict, m: int, card: str) -> None:
    c = {k: v for k, v in r["launches"].items() if v and "by_device" not in k}
    cs.say(tag, f"{'; '.join(r['route'])}; {r['wall']:.2f} s wall "
           f"({m / r['wall']:.0f} SNPs/s); stages {r['stages']}; format_table "
           f"{r['format_s']:.2f} s; peak device memory {r['peak']:.3f} GiB; "
           f"launches {c}; host peak {host_peak_gib():.2f} GiB; on {card}")


def streamed_runs(card: str, prefix: str, tmp: str) -> None:
    """Runs a-d, streamed at ``CHUNK_ROWS`` rows."""
    from nldsc_tpu_torch.io.plink import BedReader, scan_rowmiss
    from nldsc_tpu_torch.ld.pipeline import wants_streaming

    base = ["--bfile", prefix, "-kb", "100", "-maf", "0.01", "--extra"]
    free = torch.cuda.mem_get_info()[0]
    cs.say("a rule", f"free device memory {free / 1e9:.1f} GB; "
           f"wants_streaming: {wants_streaming(M, N, DEV)}")
    out_a = os.path.join(tmp, "a.L2")
    r = ld_run(base + ["-o", out_a])
    report("a ld", r, M, card)
    cs.check_outputs(out_a, M)

    ck = os.path.join(tmp, "ck")
    out_b = os.path.join(tmp, "b.L2")
    stream = ["--streaming", "--chunk-rows", str(CHUNK_ROWS), "--resume", ck]
    r = ld_run(base + stream + ["-o", out_b])
    report("b ld --streaming", r, M, card)
    cs.check_outputs(out_b, M)
    scan = [ln for ln in r["log"].lines if ln.startswith("rowmiss")]
    t0 = time.time()
    flags = scan_rowmiss(BedReader(prefix + ".bed", M, N))
    cs.say("b rowmiss", f"the run's log: {scan}; scan_rowmiss alone "
           f"{time.time() - t0:.2f} s over "
           f"{os.path.getsize(prefix + '.bed') / 1e9:.2f} GB, "
           f"{int(flags.sum())} contaminated rows; host peak "
           f"{host_peak_gib():.2f} GiB")

    shards = sorted(Path(ck).glob("chunk_*.npz"))
    for s in shards[3:]:
        s.unlink()
    out_c = os.path.join(tmp, "c.L2")
    r = ld_run(base + stream + ["-o", out_c])
    report("c resume", r, M, card)
    same = Path(out_b).read_bytes() == Path(out_c).read_bytes()
    cached = r["log"].has("rowmiss: read the cached bitmap")
    cs.say("c resume", f"{len(shards)} shards, {len(shards) - 3} deleted: "
           f".L2 byte-identical {same}; cached rowmiss read {cached}; "
           f"{[ln for ln in r['log'].lines if ln.startswith('Resuming')]}")
    if not (same and cached):
        raise RuntimeError("the resumed run is not b's .L2, or it scanned")

    p = 53
    names = ["base"] + [f"a{i}" for i in range(1, p)]
    snps = [f"rs{i + 1}" for i in range(M)]
    annot = np.round(cs.annot_values(np.random.default_rng(19), M, p), 4)
    apath = os.path.join(tmp, "chr.annot")
    cs.write_annot_file(apath, snps, annot, names)
    out_d = os.path.join(tmp, "d.L2")
    r = ld_run(["--bfile", prefix, "-kb", "100", "-maf", "0.01", "--annot",
                apath, "--streaming", "--chunk-rows", str(CHUNK_ROWS),
                "-o", out_d])
    report("d ld --annot --streaming", r, M, card)
    tab = cs.read_l2(out_d)
    plain = cs.read_l2(out_b)
    if not all(np.isfinite(tab[f"{x}.L2"]).all() for x in names):
        raise RuntimeError("d: non-finite annotation scores")
    err = max(float(np.abs(tab["base.L2"] - plain["L2"]).max()),
              float(np.abs(tab["base.L2D"] - plain["L2D"]).max()))
    cs.say("d ld --annot --streaming", f"p={p}: format_table "
           f"{100 * r['format_s'] / r['wall']:.1f}% of the wall; base.L2/L2D "
           f"against b's L2/L2D: max abs diff {err:.3g}")
    if err > 1e-4:
        raise RuntimeError("d: base.L2 is not b's L2")


def incore_runs(card: str, prefix: str) -> dict:
    """Run e: in core on the first ``INCORE_M`` SNPs."""
    import dataclasses

    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import BedReader, PackedBed, PlinkDataset
    from nldsc_tpu_torch.ld import ld_pallas_sym
    from nldsc_tpu_torch.ld.pipeline import (INCORE_BYTES_PER_GENOTYPE,
                                             compute_ld_scores, padded_shape)
    from nldsc_tpu_torch.ld.streaming import compute_ld_scores_streaming

    ds = PlinkDataset.parse(prefix)
    t0 = time.time()
    packed = ds.bed.read_raw(0, INCORE_M)
    pos = ds.positions("bp")[:INCORE_M]
    clean = PackedBed(cs.clean_copy(packed.raw, N), INCORE_M, N, False)
    cs.say("e data", f"read {INCORE_M} rows ({packed.raw.nbytes / 1e9:.2f} "
           f"GB) and made the clean copy in {time.time() - t0:.1f} s")
    cfg = LDConfig(ld_wind=100_000.0, maf_thr=0.01, std_thr=1e-5,
                   ).resolve_rsq(ds.n_snp)
    m_pad, n_pad = padded_shape(INCORE_M, N, "cuda", ld_pallas_sym.ROW_ALIGN)
    limit = INCORE_BYTES_PER_GENOTYPE["int8"]
    res = {}
    for route, data, split in (("split", packed, None),
                               ("global", packed, False),
                               ("clean", clean, None)):
        base = reset()
        cs.reset_counts()
        t0 = time.time()
        res[route] = compute_ld_scores(
            data, pos, dataclasses.replace(cfg, split_missing=split),
            device=DEV)
        torch.cuda.synchronize()
        wall = time.time() - t0
        per = peak(base) / (m_pad * n_pad)
        c = {k: v for k, v in cs.launch_counts().items()
             if v and "by_device" not in k}
        cs.say(f"e in core {route}", f"M={INCORE_M} N={N}: {wall:.2f} s; "
               f"peak device memory {per * m_pad * n_pad / 2**30:.3f} GiB = "
               f"{per:.3f} bytes per padded genotype ({m_pad} x {n_pad}; "
               f"INCORE_BYTES_PER_GENOTYPE {limit}); launches {c}; on {card}")
        if not np.isfinite(res[route]["l2"]).all():
            raise RuntimeError(f"e {route}: non-finite l2")
        if per > limit:
            raise RuntimeError(f"e {route}: {per:.3f} bytes per genotype "
                               f"above INCORE_BYTES_PER_GENOTYPE {limit}")
    keys = ("l2", "l2d")
    cs.counters_equal(res["split"], res["global"], "e split vs global")
    err = cs.within(res["split"], res["global"], keys, "e split vs global")
    base = reset()
    t0 = time.time()
    streamed = compute_ld_scores_streaming(
        BedReader(ds.bed_path, INCORE_M, N), pos, cfg, chunk_rows=CHUNK_ROWS,
        device=DEV)
    wall = time.time() - t0
    cs.counters_equal(res["split"], streamed, "e in core vs streamed")
    err_s = cs.within(streamed, res["split"], keys, "e in core vs streamed",
                      cs.GOLDEN_TOL)
    cs.say("e checks", f"split = global: counters equal, max |l2,l2d| diff "
           f"{err:.3g}; the same {INCORE_M} rows streamed ({wall:.2f} s, peak "
           f"{peak(base) / 2**30:.3f} GiB): counters equal to in core, max "
           f"|l2,l2d| diff {err_s:.3g} (golden tolerances)")
    return {"packed": packed, "clean": clean, "pos": pos}


def kernel_runs(card: str, e: dict, window: int = 512) -> dict:
    """Run f: K1 clean, K1 8-product and K2 alone on e's inputs."""
    from nldsc_tpu_torch.ld import ld_pallas_sym, ld_split

    pos = e["pos"]
    wind = 100_000.0
    r0 = (len(pos) // 2) // window * window
    rows = slice(r0, r0 + window)
    out = {}

    def held(args, n_, has_missing):
        T = ld_pallas_sym.tile(has_missing)
        kern = ld_pallas_sym.sym_credits(*args, cs.RSQ, n_samples=n_,
                                         has_missing=has_missing,
                                         block_size=T)
        return cs.compare(cs.finalized(kern, args), cs.finalized(
            cs.twin_credits(args, n_, has_missing, T), args))

    # the twins on a window of rows at full N
    args, n_, _, raw = cs.packed_inputs(torch, e["clean"].raw[rows], N,
                                        False, pos[rows], wind, DEV)
    m0 = torch.zeros_like(args[0])
    err_c = held(args, n_, False)
    err_m = held((args[0], m0, *args[2:]), n_, True)
    args, n_, _, raw = cs.packed_inputs(torch, e["packed"].raw[rows], N,
                                        True, pos[rows], wind, DEV,
                                        materialize_m=False)
    sargs = cs.split_args(args, raw, n_)
    err_k2 = cs.compare_deltas(
        ld_split.split_corrections(*sargs, n_samples=n_),
        ld_split.split_corrections_plain(*sargs, n_samples=n_))
    cs.say("f twins", f"rows [{r0}, {r0 + window}) at N={N}: K1 clean, K1 "
           f"8-product (m = 0) and K2 ({sargs[-1]['n_miss']} contaminated "
           f"rows) against their twins: counters equal, max abs diff "
           f"{err_c:.3g} / {err_m:.3g} / {err_k2:.3g}")
    del args, m0, sargs, raw

    # the whole in-core inputs, timed
    args, n_, _, _ = cs.packed_inputs(torch, e["clean"].raw, N, False, pos,
                                      wind, DEV)
    m0 = torch.zeros_like(args[0])
    n_pad = args[0].shape[1]
    for name, has_missing, m in (("K1 clean", False, args[1]),
                                 ("K1 8-product", True, m0)):
        T = ld_pallas_sym.tile(has_missing)

        def k1(m=m, has_missing=has_missing, T=T):
            return ld_pallas_sym.sym_credits(
                args[0], m, *args[2:], cs.RSQ, n_samples=n_,
                has_missing=has_missing, block_size=T)

        ms = cs.cuda_ms(torch, k1, reps=5)
        w = cs.k1_work(args[5], n_pad, has_missing, T)
        lib = cs.k1_products_library_ms(torch, (args[0], m, *args[2:]),
                                        has_missing, T)
        out[name] = {"ms": ms, "library_products_ms": lib["ms"],
                     "library_stacked_ms": lib["stacked_ms"],
                     "library_stacked_extra": lib["stacked_ops"] / lib["ops"],
                     **w}
        cs.say(f"f {name}", f"M={len(pos)} N={N} (n_pad {n_pad}) +-1000 "
               f"SNPs: {ms:.3f} ms over {w['ctas']} tiles, "
               f"{w['ops'] / ms / 1e9:.0f} int8 TOPS on the in-window pairs; "
               f"bound {w['bound_ms']:.3f} ms ({w['bound_by']}), "
               f"{100 * w['bound_ms'] / ms:.1f}% of it; "
               f"{cs.k1_cluster(torch, DEV, has_missing, n_pad)}; torch._int_mm on "
               f"its products ({lib['calls']} calls, one a product of a "
               f"pivot tile and its band) {lib['ms']:.3f} ms, stacked over "
               f"1,024 pivot rows ({lib['stacked_ops'] / lib['ops']:.2f}x "
               f"the products) {lib['stacked_ms']:.3f} ms; on {card}")
    del args, m0
    torch.cuda.empty_cache()
    args, n_, _, raw = cs.packed_inputs(torch, e["packed"].raw, N, True,
                                        pos, wind, DEV, materialize_m=False)
    sargs = cs.split_args(args, raw, n_)
    del raw

    def k2():
        return ld_split.split_corrections(*sargs, n_samples=n_)

    ms = cs.cuda_ms(torch, k2, reps=5)
    w = cs.k2_work(sargs)
    out["K2"] = {"ms": ms, **w}
    plan = sargs[-1]
    cs.say("f K2", f"split_corrections at M={len(pos)} N={N}, "
           f"{plan['n_miss']} contaminated rows, P={plan['p_band']}, "
           f"{plan['n_segs']} segments: {ms:.3f} ms; {w['pairs']} counted "
           f"pairs, {w['live']} of {w['tiles']} fused tiles live; bound "
           f"{w['bound_ms']:.3f} ms ({w['bound_by']}), "
           f"{100 * w['bound_ms'] / ms:.1f}% of it; on {card}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="where the bfile and outputs go (default: a "
                         "temporary directory, removed at the end)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: ukb_width_cuda.py needs one GPU",
              file=sys.stderr)
        return 2
    from nldsc_tpu_torch import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.time()
    _build.build("ld_sym", "split_corr")
    cs.say("build", f"K1 and K2 built in {time.time() - t0:.1f} s; "
           f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
           f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = a.out_dir or tempfile.mkdtemp(prefix="ukb_width_")
    os.makedirs(tmp, exist_ok=True)
    try:
        t0 = time.time()
        prefix = cs.write_chromosome(torch, os.path.join(tmp, "ukb"), M, N,
                                     SEED, DEV)
        torch.cuda.synchronize()
        cs.say("data", f"M={M} N={N} seed {SEED}: "
               f"{os.path.getsize(prefix + '.bed') / 1e9:.3f} GB .bed drawn, "
               f"packed and written in {time.time() - t0:.1f} s; host peak "
               f"{host_peak_gib():.2f} GiB; on {card}")
        streamed_runs(card, prefix, tmp)
        e = incore_runs(card, prefix)
        f = kernel_runs(card, e)
        print(json.dumps({"shape": [M, N], "card": card,
                          "kernels": {k: {x: v[x] for x in (
                              "ms", "bound_ms", "bound_by",
                              "library_products_ms") if x in v}
                              for k, v in f.items()}}))
    finally:
        if a.out_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    cs.say("done", f"every check passed; on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
