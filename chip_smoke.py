#!/usr/bin/env python3
"""Drive the PyTorch port (``nldsc_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one line each:
  1. the device, and ``nvidia-smi``'s name and power limit;
  2. build the hand-written CUDA kernel (``csrc/ld_sym.cu``) with nvcc;
  3. kernel against its plain PyTorch twin at M=4096, N=3001, clean and
     2% missing, adversarial rows included: counters exactly equal,
     l2/l2d within rtol 1e-5 and atol 1e-5, two kernel runs bitwise equal;
  4. the golden fixture (tests/data/golden_chr22_toy.npz) through
     ``compute_ld_scores`` on the card, at tests/test_golden.py's
     tolerances;
  5. the main path through the ``ld`` command on a synthetic clean bfile
     of M=65,536 SNPs x N=16,384 samples, 100 bp apart, ``-kb 100``
     (a window of +-1000 SNPs): the .L2/.M/.M_5_50 files, M finite rows,
     and the kernel's launches counted in that run;
  6. the same at M=16,384 with 2% missing genotypes (8-product branch);
  7. the kernel's and the twin's time at phase 5's shape, and their
     agreement there.

Then one JSON line of the kernels, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without the last line; so does a machine with no
CUDA device, or a directory without the port beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RSQ = 1e-3
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def synthetic_genotypes(rng, m: int, n: int, missing_rate: float = 0.0,
                        chunk: int = 4096) -> np.ndarray:
    """int8 (m, n) codes with MAF in [0.05, 0.5] and local LD: each SNP
    copies its predecessor at 80% of the samples."""
    out = np.empty((m, n), dtype=np.int8)
    mafs = rng.uniform(0.05, 0.5, m).astype(np.float32)
    prev = None
    for s in range(0, m, chunk):
        c = min(chunk, m - s)
        p = mafs[s:s + c, None]
        fresh = ((rng.random((c, n), dtype=np.float32) < p).astype(np.int8)
                 + (rng.random((c, n), dtype=np.float32) < p))
        keep = rng.random((c, n), dtype=np.float32) < 0.8
        for i in range(c):
            row = fresh[i] if prev is None else np.where(keep[i], prev,
                                                         fresh[i])
            out[s + i] = row
            prev = out[s + i]
        if missing_rate > 0:
            miss = rng.random((c, n), dtype=np.float32) < missing_rate
            out[s:s + c][miss] = -1
    return out


def adversarial_rows(rng, n: int) -> np.ndarray:
    """Monomorphic, all-het, ultra-rare, normal and half-missing rows."""
    heavy = rng.binomial(2, 0.25, n).astype(np.int8)
    heavy[: n // 2] = -1
    return np.stack([np.zeros(n, np.int8), np.full(n, 2, np.int8),
                     np.ones(n, np.int8),
                     rng.binomial(2, 0.001, n).astype(np.int8),
                     rng.binomial(2, 0.3, n).astype(np.int8), heavy])


def engine_inputs(torch, g: np.ndarray, pos: np.ndarray, wind: float, dev):
    """Preprocessed kernel arguments on ``dev`` for int8 codes ``g``."""
    from nldsc_tpu_torch.io.plink import encode_bed_bytes
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, preprocess, windows

    m, n = g.shape
    has_missing = bool((g < 0).any())
    T = ld_pallas_sym.TILE
    m_pad, n_pad = -(-m // T) * T, -(-n // 128) * 128
    lo, hi, pos_ok = windows.window_bounds(pos, wind)
    raw = np.full((m_pad, (n + 3) // 4), 0x55 if has_missing else 0,
                  np.uint8)
    raw[:m] = encode_bed_bytes(g)
    gd = preprocess.unpack_bed(torch.from_numpy(raw).to(dev), n, n_pad,
                               -1 if has_missing else 0)
    ok = np.zeros(m_pad, bool)
    ok[:m] = pos_ok
    pre = ld_int8.preprocess_int8(gd, torch.from_numpy(ok).to(dev), 0.01, n,
                                  assume_no_missing=not has_missing)
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            torch.from_numpy(lo_p).to(dev), torch.from_numpy(hi_p).to(dev),
            pre["usable"], dom_ok, pre["add_sd_zero"])
    return args, n, has_missing


def finalized(credits, args):
    from nldsc_tpu_torch.ld.ld_xla import finalize_outputs

    l2, ws, poi, l2d, wsd, wse = credits
    return [x.cpu().numpy() for x in finalize_outputs(
        l2, l2d, ws, wsd, wse, poi, args[6], args[8])]


def compare(ours, ref) -> float:
    """Counters exactly equal, scores within KERNEL_TOL; max abs error."""
    for a, b in zip(ours[2:], ref[2:]):
        np.testing.assert_array_equal(a, b)
    err = 0.0
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a, b, equal_nan=True, **KERNEL_TOL)
        both = ~np.isnan(a) & ~np.isnan(b)
        err = max(err, float(np.abs(a[both] - b[both]).max(initial=0.0)))
    return err


def twin_credits(args, n, has_missing, block_size):
    from nldsc_tpu_torch.ld import ld_int8

    return ld_int8.sym_scan_segment(
        *args, RSQ, 0, block_size=block_size,
        right_k=ld_int8.band_extent(args[5], block_size)[1], n_samples=n,
        n_scan_blocks=args[0].shape[0] // block_size,
        has_missing=has_missing)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    fn()                                            # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_cli(ld_pallas_sym, prefix: str, out: str):
    """One ``ld`` run through the port's CLI; returns its kernel launches
    and wall seconds."""
    from nldsc_tpu_torch.cli import main as cli_main

    ld_pallas_sym.launches = 0
    t0 = time.time()
    cli_main(["ld", "--bfile", prefix, "-kb", "100", "-maf", "0.01",
              "--extra", "-o", out])
    return ld_pallas_sym.launches, time.time() - t0


def check_outputs(out: str, m: int) -> np.ndarray:
    """The .L2/.M/.M_5_50 files exist; M rows of finite L2/L2D."""
    for suffix in (".M", ".M_5_50"):
        if not Path(out).with_suffix(suffix).exists():
            raise RuntimeError(f"missing {suffix} sidecar of {out}")
    with open(out) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    if len(rows) != m:
        raise RuntimeError(f"{out}: {len(rows)} rows, expected {m}")
    l2 = np.array([float(r[header.index("L2")]) for r in rows])
    l2d = np.array([float(r[header.index("L2D")]) for r in rows])
    if not (np.isfinite(l2).all() and np.isfinite(l2d).all()):
        raise RuntimeError(f"{out}: non-finite L2/L2D values")
    return l2


def main() -> int:
    if not (ROOT / "nldsc_tpu_torch" / "csrc" / "ld_sym.cu").exists():
        print("chip_smoke.py must run from a checkout that holds "
              "nldsc_tpu_torch/", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from nldsc_tpu_torch import _build
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.core.timing import STAGE_TIMES
    from nldsc_tpu_torch.io.plink import write_plink
    from nldsc_tpu_torch.ld import ld_pallas_sym
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = smi
    say("1 device", f"{kind}; count {torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # 2. build
    t0 = time.time()
    _build.load("ld_sym")
    info = _build.BUILD_INFO.get("ld_sym", {})
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    say("2 build", f"ld_sym.cu built and loaded in {time.time() - t0:.2f} s "
        f"(nvcc {info.get('seconds', 0.0):.2f} s); ptxas: "
        + " | ".join(ptxas))

    # 3. kernel against twin, clean and 2% missing, adversarial rows
    errs = []
    for rate in (0.0, 0.02):
        g = synthetic_genotypes(rng, 4096, 3001, missing_rate=rate)
        adv = adversarial_rows(rng, 3001)
        g[100:105] = adv[:5]
        if rate:
            g[200] = adv[5]
            g[300] = -1
        pos = np.arange(1, 4097, dtype=np.float64) * 100
        pos[7] = -1.0                                     # skip sentinel
        args, n, has_missing = engine_inputs(torch, g, pos, 100_000.0, dev)
        kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                         has_missing=has_missing,
                                         block_size=ld_pallas_sym.TILE)
        again = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                          has_missing=has_missing,
                                          block_size=ld_pallas_sym.TILE)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(kern, again)):
            raise RuntimeError("two kernel runs differ")
        twin = twin_credits(args, n, has_missing, ld_pallas_sym.TILE)
        err = compare(finalized(kern, args), finalized(twin, args))
        errs.append(err)
        say("3 kernel=twin", f"M=4096 N=3001 missing={rate}: counters "
            f"equal, max |l2,l2d| diff {err:.3g}, runs bitwise equal")
        del args, kern, again, twin

    # 4. golden fixture through compute_ld_scores on the card
    gold = dict(np.load(ROOT / "tests" / "data" / "golden_chr22_toy.npz"))
    cfg = LDConfig(ld_wind=12000.0, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=RSQ)
    res = compute_ld_scores(gold["genotypes"], gold["positions"], cfg,
                            device="cuda")
    for k in ("l2", "l2d"):
        np.testing.assert_allclose(res[k], gold[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)
    np.testing.assert_allclose(res["maf"], gold["maf"], atol=1e-6,
                               equal_nan=True)
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        np.testing.assert_array_equal(res[k], gold[k], err_msg=k)
    say("4 golden", f"golden_chr22_toy (M={gold['genotypes'].shape[0]}) "
        "matches at test_golden tolerances")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 5. main path, clean, chromosome scale
        M5, N5 = 65_536, 16_384
        t0 = time.time()
        g5 = synthetic_genotypes(rng, M5, N5)
        bp5 = np.arange(1, M5 + 1, dtype=np.int64) * 100
        prefix5 = write_plink(os.path.join(tmp, "chr_clean"), g5, bp=bp5)
        say("5 data", f"wrote {M5}x{N5} bfile "
            f"({os.path.getsize(prefix5 + '.bed') / 1e6:.0f} MB .bed) in "
            f"{time.time() - t0:.1f} s")
        out5 = os.path.join(tmp, "chr_clean.L2")
        n_launch, wall = run_cli(ld_pallas_sym, prefix5, out5)
        stages = dict(STAGE_TIMES)
        check_outputs(out5, M5)
        if n_launch < 1:
            raise RuntimeError("the main path did not launch the kernel")
        launches["ld_sym"] = n_launch
        say("5 ld clean", f"M={M5} N={N5} -kb 100: {n_launch} kernel "
            f"launch(es); {wall:.2f} s wall, {M5 / wall:.0f} SNPs/s; "
            f"stages { {k: round(v, 3) for k, v in sorted(stages.items())} } "
            f"on {card}")

        # 6. 2% missing genotypes, 8-product branch
        M6 = 16_384
        g6 = synthetic_genotypes(rng, M6, N5, missing_rate=0.02)
        prefix6 = write_plink(os.path.join(tmp, "chr_miss"), g6,
                              bp=bp5[:M6])
        out6 = os.path.join(tmp, "chr_miss.L2")
        n6, wall6 = run_cli(ld_pallas_sym, prefix6, out6)
        stages6 = dict(STAGE_TIMES)
        check_outputs(out6, M6)
        if n6 < 1:
            raise RuntimeError("the missing-data run did not launch the kernel")
        say("6 ld missing", f"M={M6} N={N5} 2% missing: {n6} launch(es); "
            f"{wall6:.2f} s wall, {M6 / wall6:.0f} SNPs/s; stages "
            f"{ {k: round(v, 3) for k, v in sorted(stages6.items())} } "
            f"on {card}")
        del g6

        # 7. kernel and twin at phase 5's shape
        args, n, has_missing = engine_inputs(
            torch, g5, bp5.astype(np.float64), 100_000.0, dev)
        del g5
        T = ld_pallas_sym.TILE

        def kernel():
            return ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                             has_missing=has_missing,
                                             block_size=T)

        kern = kernel()
        twin = twin_credits(args, n, has_missing, T)
        err5 = compare(finalized(kern, args), finalized(twin, args))
        del kern, twin
        ms = cuda_ms(torch, kernel, reps=5)
        plain = {B: cuda_ms(torch, lambda B=B: twin_credits(
            args, n, has_missing, B), reps=2) for B in (T, 512)}
        best_b = min(plain, key=plain.get)
        say("7 timing", f"M={M5} N={N5} +-1000 SNPs: kernel {ms:.3f} ms; "
            f"twin {plain[T]:.3f} ms (B={T}), {plain[512]:.3f} ms (B=512); "
            f"max |diff| vs twin {err5:.3g}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")

    if "jax" in sys.modules or any(k.startswith("nldsc_tpu.")
                                   or k == "nldsc_tpu" for k in sys.modules):
        raise RuntimeError("the port imported JAX or nldsc_tpu")
    print(json.dumps({"kernels": [{
        "name": "ld_sym", "route": "cuda",
        "source": "nldsc_tpu_torch/csrc/ld_sym.cu",
        "replaces": "nldsc_tpu/ld/ld_pallas_sym.py:52",
        "launches": launches["ld_sym"], "max_abs_err": max(errs + [err5]),
        "ms": ms, "plain_ms": plain[best_b]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
