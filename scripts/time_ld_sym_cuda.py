#!/usr/bin/env python3
"""Time kernel K1 (``nldsc_tpu_torch/csrc/ld_sym.cu``) on one GPU.

    python3 scripts/time_ld_sym_cuda.py [--m 65536] [--n 16384]
                                        [--half-window 1000] [--reps 5]
                                        [--annot 53] [--dot-dtype bf16]

Seeded random genotype codes are made on the card (MAF 0.05-0.5 per SNP;
2% missing codes for the 8-product branch), preprocessed by the port and
given windows of ``--half-window`` SNPs on each side.  Each branch is
first held against the plain twin at a small shape (counters equal,
l2/l2d within 1e-5, two runs bitwise equal), then timed with CUDA events
at the full shape beside its bound (``chip_smoke.k1_work``), its
cluster shape and resident clusters (``chip_smoke.k1_cluster``).  Also
printed: the ptxas report of the build, and ``torch._int_mm`` (cuBLASLt)
on a dense 8,192 x 16,384 by 16,384 x 8,192 int8 product, a yardstick of
the card's int8 rate that the port never calls.  The script times
whatever ``ld_sym.cu`` its checkout holds: a variant of the kernel is
timed by running it from a copy that holds the variant.  With
``--annot P`` each branch's annotation epilogue is held against the twin
too (its plain sums and counters bitwise equal to the plain launch's, the
annotation accumulators within 1e-5) and timed with P seeded annotations
(the first all ones, two binary, the rest uniform), with its bound
(``chip_smoke.k1_annot_work``) and its peak device memory.  With
``--dot-dtype bf16`` the kernel's bf16 instantiations run instead (on bf16
copies of the codes), each also held bitwise against the int8 one at the
small shape, with the bf16 bound, and the yardstick is a dense bf16
product with float32 sums.  The last line is one JSON object of the
numbers.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nldsc_tpu_torch import _build  # noqa: E402
from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym  # noqa: E402
from nldsc_tpu_torch.ld.pipeline import padded_shape  # noqa: E402

RSQ = 1e-3


def engine_args(m: int, n: int, half_window: int, missing_rate: float,
                seed: int, dev):
    """Kernel arguments for random codes made on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m_pad, n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)
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
    rows = torch.arange(m_pad, device=dev, dtype=torch.int32)
    lo = torch.where(rows < m, (rows - half_window).clamp(min=0),
                     torch.full_like(rows, m_pad))
    hi = torch.where(rows < m, (rows + half_window).clamp(max=m - 1),
                     torch.full_like(rows, -1))
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    return (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            lo.contiguous(), hi.contiguous(), pre["usable"], dom_ok,
            pre["add_sd_zero"])


def k1(args, n: int, has_missing: bool, annot=None):
    """K1 on ``args``; the operands' dtype picks the int8 or bf16
    instantiation."""
    return ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                     has_missing=has_missing,
                                     block_size=ld_pallas_sym.ROW_ALIGN,
                                     annot=annot)


def device_split(fn, reps: int = 3) -> tuple[float, list]:
    """Device milliseconds per call of ``fn`` inside K1 and, largest
    first, in the other device ops (name, count and ms per call), from
    the profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    k1_ms, other = 0.0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / reps
        if "ld_sym_kernel" in e.key:
            k1_ms += ms
        else:
            other.append((ms, e.count // reps, e.key[:48]))
    return k1_ms, sorted(other, reverse=True)


def check_small(has_missing: bool, dev, p: int = 0,
                dot_dtype: str = "int8") -> tuple[float, float]:
    """The kernel against the twin at M = 1,000, N = 1,000, window 150;
    with ``p`` annotations its annotation epilogue too; under bf16 each
    bf16 instantiation bitwise against the int8 one first.  Returns the
    max abs error of l2/l2d and of the annotation accumulators."""
    args = engine_args(1000, 1000, 150, 0.02 if has_missing else 0.0, 7,
                       dev)
    if dot_dtype == "bf16":
        for q in {0, p}:
            annot = (chip_smoke.seeded_annot(torch, args[0].shape[0], 1000,
                                             q, 7, dev) if q else None)
            chip_smoke.check_k1_bf16(torch, args, 1000, has_missing, annot)
        args = chip_smoke.as_bf16(args)
    kern = k1(args, 1000, has_missing)
    again = k1(args, 1000, has_missing)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise RuntimeError("two kernel runs differ")
    twin = chip_smoke.twin_credits(args, 1000, has_missing,
                                   ld_pallas_sym.ROW_ALIGN)
    err = chip_smoke.compare(chip_smoke.finalized(kern, args),
                             chip_smoke.finalized(twin, args))
    if not p:
        return err, 0.0
    annot = chip_smoke.seeded_annot(torch, args[0].shape[0], 1000, p, 7, dev)
    if dot_dtype == "bf16":       # held against int8 above, bitwise
        twin = chip_smoke.twin_credits(args, 1000, has_missing,
                                       ld_pallas_sym.ROW_ALIGN, annot)
        return err, chip_smoke.hold_accumulators(
            k1(args, 1000, has_missing, annot)[6:], twin[6:],
            "K1 bf16 accumulators")
    err_a = chip_smoke.check_k1_annot(torch, args, 1000, has_missing, annot,
                                      kern)
    return err, err_a


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=65_536)
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--half-window", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--annot", type=int, default=0, metavar="P",
                    help="also check and time the annotation epilogue with "
                         "P annotations")
    ap.add_argument("--dot-dtype", choices=["int8", "bf16"], default="int8",
                    help="the operand type of the instantiations timed")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build("ld_sym")
    ptxas = [ln.strip() for ln in _build.BUILD_INFO["ld_sym"]["log"]
             .splitlines() if "registers" in ln or "spill" in ln
             or "C75" in ln]
    print("ptxas: " + " | ".join(ptxas), flush=True)
    spills = [int(b) for b in re.findall(
        r"(\d+) bytes spill", _build.BUILD_INFO["ld_sym"]["log"])]
    if not spills or any(spills):
        print(f"ptxas reports spills: {spills}", file=sys.stderr)
        return 1
    dt = opt.dot_dtype
    out = {"card": card, "m": opt.m, "n": opt.n,
           "half_window": opt.half_window, "dot_dtype": dt}
    for has_missing in (False, True):
        name = "8prod" if has_missing else "clean"
        err, err_a = check_small(has_missing, dev, opt.annot, dt)
        args = engine_args(opt.m, opt.n, opt.half_window,
                           0.02 if has_missing else 0.0, opt.seed, dev)
        if dt == "bf16":
            args = chip_smoke.as_bf16(args)
        work = chip_smoke.k1_work(args[5], args[0].shape[1], has_missing,
                                  ld_pallas_sym.tile(has_missing), dt)
        ms = chip_smoke.cuda_ms(
            torch, lambda: k1(args, opt.n, has_missing), opt.reps)
        cluster = chip_smoke.k1_cluster(torch, dev, has_missing,
                                        args[0].shape[1], bf16=dt == "bf16")
        out[name] = {"ms": ms, "max_abs_err_small": err, **work,
                     "tops": work["tile_ops"] / ms / 1e9,
                     "window_tops": work["ops"] / ms / 1e9,
                     "share_of_bound": work["bound_ms"] / ms,
                     "cluster": cluster}
        print(f"{name}: {ms:.3f} ms; {work['ctas']} tiles; "
              f"{out[name]['tops']:.0f} TOPS in tiles, "
              f"{out[name]['window_tops']:.0f} TOPS in window; bound "
              f"{work['bound_ms']:.3f} ms ({work['bound_by']}), "
              f"{100 * out[name]['share_of_bound']:.1f}% of it; {cluster}; "
              f"small-shape max |diff| vs twin {err:.3g}; on {card}",
              flush=True)
        if opt.annot:
            annot = chip_smoke.seeded_annot(torch, args[0].shape[0], opt.m,
                                            opt.annot, opt.seed, dev)
            work_a = chip_smoke.k1_annot_work(work, args[0].shape[0],
                                              opt.annot, dt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms_a = chip_smoke.cuda_ms(
                torch, lambda: k1(args, opt.n, has_missing, annot),
                opt.reps)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            ms_again = chip_smoke.cuda_ms(
                torch, lambda: k1(args, opt.n, has_missing), opt.reps)
            k1_ms, other = device_split(
                lambda: k1(args, opt.n, has_missing, annot))
            print(f"{name} + {opt.annot} annotations, device time per call: "
                  f"the kernel {k1_ms:.3f} ms, {sum(c for _, c, _ in other)} "
                  f"other ops {sum(x for x, _, _ in other):.3f} ms (zero "
                  "fill and folds): " + "; ".join(
                      f"{k} x{c} {x:.3f} ms" for x, c, k in other[:5]),
                  flush=True)
            out[name + "_annot"] = {
                "p": opt.annot, "ms": ms_a, "ms_plain_again": ms_again,
                "ms_kernel": k1_ms,
                "ms_other_ops": sum(x for x, _, _ in other),
                "max_abs_err_small": err_a, "peak_gib": peak, **work_a}
            print(f"{name} + {opt.annot} annotations: {ms_a:.3f} ms (plain "
                  f"again {ms_again:.3f} ms); bound {work_a['bound_ms']:.3f} "
                  f"ms ({work_a['bound_by']}), "
                  f"{100 * work_a['bound_ms'] / ms_a:.1f}% of it; peak "
                  f"device memory above the inputs {peak:.3f} GiB; "
                  f"small-shape max |diff| of the accumulators vs twin "
                  f"{err_a:.3g}, plain sums and counters bitwise equal to "
                  f"the plain launch; on {card}", flush=True)
            del annot
        del args
        torch.cuda.empty_cache()
    a = torch.randint(-2, 3, (8192, 16384), dtype=torch.int8, device=dev)
    bt = torch.randint(-2, 3, (8192, 16384), dtype=torch.int8, device=dev)
    if dt == "bf16":
        a, bt = a.to(torch.bfloat16), bt.to(torch.bfloat16)
        ms, what = chip_smoke.library_bf16_ms(torch, [(a, bt)], opt.reps * 4)
    else:
        ms = chip_smoke.cuda_ms(torch, lambda: torch._int_mm(a, bt.t()),
                                opt.reps * 4)
        what = "torch._int_mm"
    out["library"] = {"call": what, "ms": ms,
                      "tops": 2.0 * 8192 * 16384 * 8192 / ms / 1e9}
    print(f"{what} 8192x16384 . 16384x8192: {ms:.3f} ms, "
          f"{out['library']['tops']:.0f} TOPS; on {card}", flush=True)
    out["ptxas"] = ptxas
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
