#!/usr/bin/env python3
"""Time kernel K2 (``nldsc_tpu_torch/csrc/split_corr.cu``) on one GPU.

    python3 scripts/time_split_corr_cuda.py [--m 65536] [--n 16384]
        [--half-window 1000] [--row-frac 0.05] [--entry-rate 0.02]
        [--reps 5] [--dot-dtype bf16] [--annot 5,53]

Seeded random genotype codes are made on the card (MAF 0.05-0.5 per SNP),
then ``--entry-rate`` of the codes of ``--row-frac`` of the rows are set
missing: the sparse-missing panel that the ``ld`` pipeline sends down the
split route.  The rows are preprocessed by the port, given windows of
``--half-window`` SNPs on each side and planned as the pipeline plans them.
``chip_smoke.split_timing`` then holds ``split_corrections`` against its
twin and K2's products mode against ``torch._int_mm`` (cuBLASLt) on the
same products, and times both beside K1's clean pass and the global
8-product pass on the same rows, with K2's bound (``chip_smoke.k2_work``).
Also printed: the ptxas report of the build.  The script times whatever
``split_corr.cu`` its checkout holds: a variant of the kernel is timed by
running it from a copy that holds the variant.  With ``--dot-dtype bf16``
K2's bf16 instantiations are held bitwise against the int8 ones
(``chip_smoke.check_k2_bf16``: products mode and ``split_corrections``)
and timed beside them (int8, bf16, bf16, int8) with the bf16 bound, and
the yardstick is a bf16 product with float32 sums on the same products.
With ``--annot P[,P...]`` the fused annotation instantiations are held
against the twin (plain δ bitwise the plain call's, annotation δ within
KERNEL_TOL, bf16 bitwise int8) and ``split_corrections(annot=)`` with P
seeded annotations is timed beside the call without them (plain, annot,
annot, plain) on int8 and on bf16 operands, with the device time inside
K2 and in the other ops (profiler) and the bound
(``chip_smoke.annot_bound``, the epilogue at the tf32 rate).  Every mode
prints, per kernel function of the build of K2 and of K1, its SASS
instruction count and a hash of its SASS and of its opcodes
(``cuobjdump -sass``), so that two checkouts' builds can be compared.
The last line is one JSON object of the numbers.
"""

from __future__ import annotations

import argparse
import hashlib
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


def engine_args(m: int, n: int, half_window: int, row_frac: float,
                entry_rate: float, seed: int, dev):
    """K1's arguments (lazy m) for random codes made on ``dev`` with
    missing codes in ``row_frac`` of the rows, and the raw codes."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    m_pad, n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)
    codes = torch.full((m_pad, n_pad), -1, dtype=torch.int8, device=dev)
    for r in range(0, m, 4096):
        c = min(4096, m - r)
        p = torch.rand((c, 1), generator=gen, device=dev) * 0.45 + 0.05
        codes[r:r + c, :n] = sum(
            (torch.rand((c, n), generator=gen, device=dev) < p)
            .to(torch.int8) for _ in range(2))
    rows = torch.randperm(m, generator=gen, device=dev)[:int(m * row_frac)]
    sub = codes[rows, :n]
    sub[torch.rand(sub.shape, generator=gen, device=dev) < entry_rate] = -1
    codes[rows, :n] = sub
    ok = torch.zeros(m_pad, dtype=torch.bool, device=dev)
    ok[:m] = True
    pre = ld_int8.preprocess_int8(codes, ok, 0.01, n, materialize_m=False)
    idx = torch.arange(m_pad, device=dev, dtype=torch.int32)
    lo = torch.where(idx < m, (idx - half_window).clamp(min=0),
                     torch.full_like(idx, m_pad))
    hi = torch.where(idx < m, (idx + half_window).clamp(max=m - 1),
                     torch.full_like(idx, -1))
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    return (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            lo.contiguous(), hi.contiguous(), pre["usable"], dom_ok,
            pre["add_sd_zero"]), codes


def time_bf16(sargs, opt, card: str, ptxas: list) -> int:
    """K2's bf16 instantiations against the int8 ones, bitwise, and both
    timed in turns, with the bf16 bound and a bf16 library yardstick on
    the same products."""
    from nldsc_tpu_torch.ld import ld_split

    plan = sargs[-1]
    bsargs, k_int8, k_bf16 = chip_smoke.check_k2_bf16(torch, sargs, opt.n)
    ms8, ms, ms_b, ms8_b = (chip_smoke.cuda_ms(torch, f, 2 * opt.reps)
                            for f in (k_int8, k_bf16, k_bf16, k_int8))
    work = chip_smoke.k2_work(sargs, "bf16")
    pairs = []
    for _, s0, *_, x, cat3, m_xc in ld_split.segments(*bsargs[:3], plan):
        pairs += [(x, cat3), (bsargs[2][s0:s0 + x.shape[0]],
                              cat3[:2 * plan["p_band"]]), (m_xc, cat3)]
    lib_ms, what = chip_smoke.library_bf16_ms(torch, pairs, opt.reps)
    print(f"[bf16] split_corrections bf16 {ms:.3f} / {ms_b:.3f} ms against "
          f"int8 {ms8:.3f} / {ms8_b:.3f} ms (bitwise equal, products mode "
          f"too); bound {work['bound_ms']:.3f} ms ({work['bound_by']}), "
          f"{100 * work['bound_ms'] / min(ms, ms_b):.1f}% of it; {what} on "
          f"the same products {lib_ms:.3f} ms; on {card}", flush=True)
    print(json.dumps({"card": card, "m": opt.m, "n": opt.n,
                      "dot_dtype": "bf16", "n_miss": plan["n_miss"],
                      "ms": min(ms, ms_b), "int8_ms": min(ms8, ms8_b),
                      "library_ms": lib_ms, "library": what,
                      "bound_ms": work["bound_ms"],
                      "bound_by": work["bound_by"], "ptxas": ptxas}))
    return 0


def sass_digest(name: str) -> dict:
    """Per kernel function of the built ``csrc/<name>.cu`` (keyed by its
    name from ``_kernel`` on, without the anonymous namespace): the
    instruction count and hashes of its SASS lines and of its opcodes."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path(name))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        fname, body = part.split("\n", 1)
        key = re.search(r"[a-z_]+_kernelI\w*?EE", fname)
        instr = [ln.strip() for ln in body.splitlines()
                 if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        ops = [re.sub(r"/\*[0-9a-f]+\*/\s*", "", ln).split(" ")[0]
               for ln in instr]
        out[key.group(0) if key else fname.strip()] = {
            "instructions": len(instr),
            "sass_sha": hashlib.sha256("\n".join(instr).encode())
            .hexdigest()[:16],
            "ops_sha": hashlib.sha256(" ".join(ops).encode())
            .hexdigest()[:16]}
    return out


def device_split(fn, reps: int = 3) -> tuple[float, float]:
    """Device milliseconds per call of ``fn`` inside K2 and in the other
    device ops, from the profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    k2_ms = other_ms = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / reps
        if "split_corr_kernel" in e.key:
            k2_ms += ms
        else:
            other_ms += ms
    return k2_ms, other_ms


def time_annot(sargs, opt, card: str, ptxas: list, sass: dict,
               dev) -> int:
    """``split_corrections(annot=)`` with each of ``opt.annot`` seeded
    annotation counts: held against the plain call and the twin, bf16
    against int8, then timed beside the plain call in turns on each
    operand type."""
    from nldsc_tpu_torch.ld import ld_split

    m_pad = sargs[0].shape[0]
    bsargs = chip_smoke.as_bf16(sargs)
    work = chip_smoke.k2_work(sargs)
    rows = []
    for p in opt.annot:
        annot = chip_smoke.seeded_annot(torch, m_pad, opt.m, p, opt.seed,
                                        dev)

        def k2(a=None, args=sargs):
            return ld_split.split_corrections(*args, a, n_samples=opt.n)

        kern, plain = k2(annot), k2()
        plain_sha = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in plain)).hexdigest()[:16]
        if not all(torch.equal(a, b) for a, b in zip(kern[:3], plain)):
            raise RuntimeError("the plain δ of an annot call differ from a "
                               "plain call's")
        if not chip_smoke.all_bits_equal(torch, k2(annot, bsargs), kern):
            raise RuntimeError("bf16 split_corrections(annot=) differs from "
                               "int8")
        err = chip_smoke.hold_accumulators(
            kern[3:], ld_split.split_corrections_plain(
                *sargs, annot, n_samples=opt.n)[3:],
            "split_corrections annotation δ against its twin")
        del kern, plain
        work_a = chip_smoke.annot_bound(work, work["pairs"], m_pad, p,
                                        work["int8_ops"], work["f32_ops"],
                                        tensor_cores=True)
        for dtype, args in (("int8", sargs), ("bf16", bsargs)):
            ms_plain, ms, ms2, ms_plain2 = (
                chip_smoke.cuda_ms(torch, f, 2 * opt.reps)
                for f in (lambda: k2(None, args), lambda: k2(annot, args),
                          lambda: k2(annot, args), lambda: k2(None, args)))
            k2_ms, other_ms = device_split(lambda: k2(annot, args))
            k2_plain_ms, other_plain_ms = device_split(lambda: k2(None, args))
            epi = min(ms, ms2) - min(ms_plain, ms_plain2)
            print(f"split_corrections(annot=) p={p} {dtype}, "
                  f"{sargs[-1]['n_miss']} contaminated rows: {ms:.3f} / "
                  f"{ms2:.3f} ms against {ms_plain:.3f} / {ms_plain2:.3f} ms "
                  f"without annotations (plain, annot, annot, plain): the "
                  f"epilogue's own cost {epi:.3f} ms; device time per call: "
                  f"K2 {k2_ms:.3f} ms, other ops {other_ms:.3f} ms (plain: "
                  f"{k2_plain_ms:.3f} / {other_plain_ms:.3f}); int8 bound "
                  f"{work_a['bound_ms']:.3f} ms ({work_a['bound_by']}), "
                  f"{100 * work_a['bound_ms'] / min(ms, ms2):.1f}% of it; "
                  f"max |annotation δ| diff vs twin {err:.3g}; plain δ "
                  f"sha256 {plain_sha}; on {card}", flush=True)
            rows.append({"p": p, "dot_dtype": dtype, "ms": [ms, ms2],
                         "plain_ms": [ms_plain, ms_plain2],
                         "epilogue_ms": epi, "k2_ms": k2_ms,
                         "other_ms": other_ms, "k2_plain_ms": k2_plain_ms,
                         "other_plain_ms": other_plain_ms,
                         "max_abs_err": err, "plain_sha": plain_sha,
                         "bound_ms": work_a["bound_ms"],
                         "bound_by": work_a["bound_by"]})
    print(json.dumps({"card": card, "m": opt.m, "n": opt.n,
                      "n_miss": sargs[-1]["n_miss"], "annot": rows,
                      "ptxas": ptxas, "sass": sass}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=65_536)
    ap.add_argument("--n", type=int, default=16_384)
    ap.add_argument("--half-window", type=int, default=1000)
    ap.add_argument("--row-frac", type=float, default=0.05)
    ap.add_argument("--entry-rate", type=float, default=0.02)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--dot-dtype", choices=["int8", "bf16"], default="int8",
                    help="the operand type of the instantiations timed")
    ap.add_argument("--annot", default=[], metavar="P[,P...]",
                    type=lambda v: [int(x) for x in v.split(",")],
                    help="check and time split_corrections with P "
                         "annotations instead, on int8 and bf16 operands")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build("ld_sym", "split_corr")
    ptxas = [ln.strip() for ln in _build.BUILD_INFO["split_corr"]["log"]
             .splitlines() if "registers" in ln or "spill" in ln
             or "C75" in ln]
    print("ptxas: " + " | ".join(ptxas), flush=True)
    sass = {**sass_digest("split_corr"), **sass_digest("ld_sym")}
    for k, v in sass.items():
        print(f"sass {k}: {v}", flush=True)
    args, codes = engine_args(opt.m, opt.n, opt.half_window, opt.row_frac,
                              opt.entry_rate, opt.seed, dev)
    sargs = chip_smoke.split_args(args, codes, opt.n)
    plan = sargs[-1]
    if opt.annot:
        return time_annot(sargs, opt, card, ptxas, sass, dev)
    if opt.dot_dtype == "bf16":
        return time_bf16(sargs, opt, card, ptxas)
    t = chip_smoke.split_timing(torch, args, sargs, codes, opt.n, opt.reps)
    shape = f"M={opt.m} N={opt.n} +-{opt.half_window} SNPs"
    for tag, msg in chip_smoke.split_report(t, plan, shape, card):
        print(f"[{tag}] {msg}", flush=True)
    out = {"card": card, "m": opt.m, "n": opt.n,
           "half_window": opt.half_window, "row_frac": opt.row_frac,
           "entry_rate": opt.entry_rate, "n_miss": plan["n_miss"],
           "p_band": plan["p_band"], "p_x": plan["p_x"],
           "n_segs": plan["n_segs"], "ptxas": ptxas,
           **{k: v for k, v in t.items() if k != "other"},
           "largest_other_ops": t["other"][:6], "sass": sass}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
