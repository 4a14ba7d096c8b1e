#!/usr/bin/env python3
"""Drive the PyTorch port (``nldsc_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one line each (or a few):
  1. the device, and ``nvidia-smi``'s name and power limit;
  2. build the hand-written CUDA kernels (``csrc/ld_sym.cu``, K1, and
     ``csrc/split_corr.cu``, K2 with its fused δ epilogue), one nvcc
     each, all started together, with ptxas's registers and spills of
     every instantiation (any spill fails the phase).  Both run their
     int8 products on ``wgmma`` fed by a TMA ring (one producer thread,
     two consumer warpgroups): K1 on 128 x 128 tiles with 3 products on
     the clean branch, 64 x 64 with 8 on the missing one, on wide rows
     in 2 x 2 thread-block clusters that multicast each shared tile; K2
     on 128 x rows by 32 compact columns with 5 products, h derived in
     registers;
  3. K1 against its plain PyTorch twin at M=4096, N=3001, clean and
     2% missing (both branches), adversarial rows included: counters
     exactly equal, l2/l2d within rtol 1e-5 and atol 1e-5, two kernel
     runs bitwise equal;
  4. the golden fixture (tests/data/golden_chr22_toy.npz) through
     ``compute_ld_scores`` on the card, at tests/test_golden.py's
     tolerances;
  5. the main path through the ``ld`` command on a synthetic clean bfile
     of M=65,536 SNPs x N=16,384 samples, 100 bp apart, ``-kb 100``
     (a window of +-1000 SNPs), its LD strength drawn per 512 SNPs: the
     .L2/.M/.M_5_50 files, M finite rows, and the kernel's launches
     counted in that run: 16, one per segment of the pass (progress is on
     by default at M >= 20,000);
  6. the same at M=16,384 with 2% missing genotypes (8-product branch);
  7. at phase 5's shape: K1's clean branch and its 8-product branch
     (on the same genotypes, with an all-zero missing matrix: every pair
     equals the clean one) against the twin, their times, int8 TOPS and
     share of the bound beside K1's cluster shape and resident clusters
     (``cudaOccupancyMaxActiveClusters``), the twin's time (512-row
     blocks), and
     ``torch._int_mm`` on a
     dense 8,192 x 16,384 by 16,384 x 8,192 int8 product as a yardstick
     of the card's int8 rate (the port never calls it);
  8. K2 at M=4096, N=3001, 5% of the rows contaminated, adversarial rows
     included: its products mode (``segment_products``) exactly equal to
     the integer products on the CPU, ``split_corrections`` (one products
     launch for d, one fused launch) on the card against its torch twin
     (wse δ equal, l2/l2d δ within 1e-5, two runs bitwise equal), and the
     split route against the global route through ``compute_ld_scores``
     (counters equal, l2/l2d within 1e-5); plus a probe of ATen's
     division by a Python scalar against true division;
  9. the ``ld`` command on phase 5's genotypes with 2% missing genotypes
     injected in 5% of the rows: the split route, with K1's clean branch
     launched once per segment (16), K2's two launches (products, then the
     fused mode, dispatched before the segments) and K1's 8-product
     branch not;
 10. at that shape: ``split_corrections`` against its twin, K2's products
     mode against ``torch._int_mm`` (cuBLASLt) on the same products (a, b
     with h read from memory, d; exactly equal), their times and K2's
     bound (beside the bound of the two kernels it replaced), the split
     route's LD pass against the global one (device times), and both
     routes through ``compute_ld_scores`` (equal counters, peak device
     memory);
 11. ``h2`` at full width: phase 5's .L2 copied to 18 chromosome files
     (1,179,648 regression SNPs, the size of the HapMap3 regression
     list), sumstats simulated from the LD-score model (N = 100,000,
     h² = 0.3, d² = 0.05, shuffled, 3,000 SNPs absent from the LD files);
     the ``h2`` command with ``--device cuda`` twice (bitwise equal JSON)
     and ``--device cpu`` (every field within rtol 1e-8, atol 1e-12), the
     additive h² within 6 std of 0.3 with a std below 0.05, and the
     regression's own wall and CUDA-event times;
 12. ``--strategy one-stg`` and ``--partitioned`` (two annotations
     splitting L2, phase 11's files as ``--w-ld``) on cuda and cpu, at
     the same tolerance, each recovering h² as phase 11 does;
 13. phase 5's bfile through ``ld --streaming --chunk-rows 8192`` (8
     chunks, halo 1,024 rows): K1's clean branch launched once per chunk
     and nothing else; the same scores through the API against
     ``compute_ld_scores`` in core (counters equal, l2/l2d within
     KERNEL_TOL); wall, ``STAGE_TIMES`` and peak device memory beside the
     in-core run's;
 14. the same on phase 9's bfile: K1's clean branch per chunk, K2's two
     launches per chunk whose band holds a contaminated row, no 8-product
     launch; against the in-core split route;
 15. phase 14 with ``--resume``: its .L2 byte-identical to phase 14's;
     shards from chunk 3 on deleted, the resumed .L2 byte-identical, the
     log reporting 3 resumed chunks and the cached rowmiss read; after a
     touch of the .bed the resume refuses;
 16. phase 5's packed rows tiled 4x (M = 262,144) streamed at phase 5's
     ``-rsq``: peak device memory within 10% of phase 13's, and on the
     rows more than a window from a seam counters equal to phase 13's and
     L2/L2D within KERNEL_TOL; then ``ld-genome`` on phases 5 and 9 in
     core, its .L2/.M/.M_5_50 byte-identical to theirs;
 17. partitioned LD scores, the kernels' annotation epilogues against
     their twins at M=4096, N=3001 with p=5 annotations (one all ones, two
     binary, two continuous): K1 clean, K1 8-product (2% missing) and
     ``split_corrections(annot=)`` on 5% contaminated rows: the plain
     credits and counters bitwise equal to a launch without annotations,
     the annotation accumulators within KERNEL_TOL of the twin's, two runs
     bitwise equal; every instantiation of both sources listed by ptxas
     without a spill;
 18. the golden fixture tests/data/golden_annot_toy.npz through
     ``compute_ld_scores(annot=)`` on the card (K1), through the full-band
     torch engine (``symmetric=False``) and streamed at ``chunk_rows=64``,
     at tests/test_golden.py's tolerances;
 19. ``ld --annot`` at full width: phase 5's chromosome with p=53
     annotations (the first all ones, ``base``) in core and streamed, and
     phase 9's on the split route (K2's annotation epilogue), the global
     route and streamed, and phase 6's 2%-missing bfile in core and
     streamed (every band global: the 8-product annotation instantiation
     per band): ``base.L2``/``base.L2D`` equal to phase 5's
     ``L2``/``L2D``, streamed equal to in core, split equal to global,
     53-column .M files, the launches of every annotation instantiation,
     ``h2 --partitioned`` on the result; then each annotation
     instantiation at that shape and p=53 against its twin (plain credits
     bitwise equal to a launch without annotations, the accumulators
     within KERNEL_TOL: the ``max_abs_err`` of the kernels line), its
     time beside the plain launch's, its bound, the full-band torch
     engine at that shape, and peak device memory; K2's line adds the
     epilogue's own cost, its launches' and the other ops' device time
     (profiler), its live tiles and partial bytes, and one float32
     ``torch.bmm`` per direction over the live tiles as a yardstick;
 20. the bf16 instantiations (``--dot-dtype bf16``) at phase 5's shape:
     K1's four (clean and annotated on phase 5's rows, 8-product and
     annotated on phase 9's with its real missing genotypes, p=53) and
     K2's products and fused modes (with and without annotations) on
     phase 9's split inputs, each bitwise equal to its int8 instantiation
     and within KERNEL_TOL of its twin (``dot_dtype="bf16"``), timed
     beside int8 (int8, bf16, bf16, int8) with its bf16 bound (K2
     annotated also beside bf16 without annotations, with its device
     time and the ``torch.bmm`` yardstick); the
     exactness probe at N_pad = 4,194,304 (Sgg = 2^24); ptxas's 26
     entry functions (K1's 16, in clusters and out, and K2's 10) without
     a spill; a dense bf16 product with float32
     sums as a yardstick (the port never calls it);
 21. ``ld --dot-dtype bf16`` on the bfiles of phases 5, 9 and 6 in core,
     phase 13's streamed and phase 19's ``--annot`` (clean, split,
     global): each .L2 byte-identical to the int8 run's, every K1 and K2
     launch a bf16 one, peak device memory;
 22. ``ld --engine f32``: the golden fixtures on the card (symmetric,
     full band, annot), phase 5's chromosome symmetric and full band
     against the int8 engine (ws/wsd equal, l2/l2d differences printed,
     wse under the counter contract of tests/contract.py, its tolerance
     from the f32 engine's measured error, at most 2 apart per row), a
     rerun with TF32 allowed process-wide bitwise equal, and
     ``--engine f32 --streaming --resume`` run to its end;
 23. the full-band streaming chunk engines on phases 5's and 9's bfiles
     at ``--chunk-rows 8192``: ``ld --no-symmetric --streaming`` (int8),
     the same with ``--dot-dtype bf16`` (its .L2 byte-identical to
     int8's) and ``ld --engine f32 --streaming``, none launching K1 or
     K2; through the API, int8 streamed against the in-core full band
     (counters equal, scores within rtol 1e-6) and f32 streamed against
     the in-core f32 full band (ws/wsd equal, wse under phase 22's
     contract, scores within rtol 2e-5, atol 2e-4), each streaming pass
     profiled (device busy time, idle share), peak device memory and
     ``STAGE_TIMES`` of each command; the f32 engine with phase 19's 53
     annotations streamed against in core; phase 22's checkpoint resumed
     with shards 2 and 5 deleted (6 chunks resumed, .L2 byte-identical);
 24. ``compat.calculate`` on phase 5's bfile, on the card by default:
     bitwise equal to ``compute_ld_scores`` in core, and streamed when
     ``wants_streaming`` is forced (K1 per chunk, counters equal, scores
     within KERNEL_TOL);
 25. ``nldsc-tpu-torch --log-file ld --profile-dir DIR`` on phase 5's
     bfile: the .L2 byte-identical to phase 5's, the trace's kernel
     events holding K1 (``ld_sym_kernel``), the ten device ops with the
     most time, and ``nldsc.log`` holding the completion line;
 26. multi-device in core, the shards placed round-robin on the visible
     devices (several to a device on one card): phase 5's bfile through
     ``ld_scores_sharded`` on 1, 2 and 4 shards (K1 launched once per
     shard, l2/l2d bitwise equal across the counts, counters equal to
     phase 5's in-core run, wall, CUDA-event span, K1 device time and
     peak memory per device), phase 9's on 2 shards (the 8-product
     branch per shard against the in-core global route), phase 19's 53
     annotations on 2 shards (K1's annotation instantiation against in
     core), ``ld_scores_sample_sharded`` on 1 and 2 shards and
     ``ld_scores_grid_sharded`` on 2x2 and 4x1 against the in-core full
     band (counters equal, bitwise invariant in the layout); ``ld
     --n-devices 1 --shard-axis snp`` byte-identical to phase 5, and
     ``--n-devices 2`` refused on one card (run on each axis with two);
 27. phase 14's bfile streamed through the devices ring of 2 at
     ``--chunk-rows 8192``: K1 once per chunk and K2 on the contaminated
     chunks (counted per device), the .L2 byte-identical to phase 14's,
     and again after a resume with shards 3-7 deleted; a sample mesh of
     2 and a grid of 2x2 against the single-device streamed full band
     (l2_ws and l2d_ws equal, l2d_wse under the counter contract of
     tests/contract.py, scores within KERNEL_TOL), the two bitwise equal;
 28. progress: phase 5's bfile through ``ld --no-progress`` (1 K1 launch)
     and ``ld --pallas`` (16), each .L2 byte-identical to phase 5's, phase
     5's 16 log lines each with an ETA; ``compute_ld_scores`` with and
     without progress in turns (one, 16, 16, one), bitwise equal, K1's
     device time summed over the 16 segments (profiler) beside the one
     launch's, and both walls;
 29. one chromosome across two processes: two ``gloo`` ranks sharing
     cuda:0 (``python3 chip_smoke.py --worker``, one pair of subprocesses
     for every case, each waited for with a time limit) run
     ``estimate_lds_mesh`` on phase 5's bfile, phase 9's (8 products a
     shard) and phase 19's 53 annotations: each .L2/.M/.M_5_50
     byte-identical to one process's run on two shards of cuda:0; per
     rank the K1 launches by instantiation, wall, MB sent (staged through
     the host) and peak device memory; then ``estimate_lds_multihost``
     over phases 5 and 9, a chromosome a rank, byte-identical to those
     phases' files; each worker reports that it imported no jax,
     nldsc_tpu or pandas.
 30. the per-SNP scalars' square roots (F4): in 3 fresh CPU processes,
     started together (``python3 chip_smoke.py --scalars-worker``, 8
     threads each, no CUDA device), ``preprocess_int8`` at M = 24,576,
     N = 64, its inv_sd, inv_rstd and rstd bitwise equal to NumPy's
     correctly rounded values and every per-SNP scalar bitwise equal to
     the card's from the same codes (dividing by n = 64 is exact on both
     devices, so only a square root could differ); each process then
     reports how far ATen's own CPU ``torch.sqrt`` (MKL VML), its first
     VML call, lies from them.
 31. F2's float32 arithmetic (the pair epilogue's fused multiply-adds and
     f32(1/n), as XLA compiles the JAX package) on a bfile of M = 4,096,
     N = 1,500 (not a power of two) with 2% missing genotypes in 5% of
     the rows, ``-kb 20``: ``ld`` on the split route (K1 clean, K2) and the global
     route (K1 8-product), each kernel's counters equal to its twin's on
     the card, the card's counters and per-SNP scalars (clean and with
     missing genotypes) bitwise equal to the CPU port's in the same
     process, and K1's and K2's times at the chromosome shape (phases 7
     and 10) beside the card's name and power limit.
 32. UK Biobank width: a bfile of M = 8,192 SNPs x N = 315,599 samples
     (the reference's UK Biobank count; N_pad = 315,648, the codes past
     2^31 bytes), drawn and packed into .bed bytes on the card by
     ``write_chromosome`` (``scripts/ukb_width_cuda.py``'s chromosome:
     phase 5's local-LD model, 5% missing genotypes in every 50th SNP),
     seed 2026: ``ld`` in core on the split
     and global routes (counters equal, each route's peak device bytes per
     padded genotype within ``pipeline.INCORE_BYTES_PER_GENOTYPE``),
     streamed at ``--chunk-rows 2048`` and resumed with shards 1-3 deleted
     (.L2 byte-identical, the cached rowmiss read); K1 clean, K1 8-product
     and K2 against their twins on 256 rows at full N, the card's per-SNP
     scalars there bitwise the CPU port's; and K1 clean, K1 8-product
     (m = 0) and K2 timed on all M rows beside their bounds (the kernels
     line's ``ms_wide``/``bound_ms_wide``), K1's beside its cluster shape
     and resident clusters and ``torch._int_mm`` on exactly its products
     (``library_products_ms_wide``).

Every line starts ``[phase +t s]``: the seconds since the script began.
Then one JSON line of the kernels (each with its time, its plain
version's, its bound from this run's inputs, its launches on the main
path of phases 5 and 9, in phases 13-14, on the SNP shards of phase 26,
the ring of phase 27, with and without progress (phase 28) and per rank
of phase 29, and ``library_ms``: null
for K1, which no PyTorch call computes (its line adds ``torch._int_mm``
on its products alone at width, and its cluster shape and resident
clusters); for K2 ``torch._int_mm`` on its
products, which the port never calls; null for the annotation
instantiations, whose epilogues no one PyTorch call fuses), the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without the last line; so does a machine with no
CUDA device, or a directory without the port beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RSQ = 1e-3
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN_TOL = dict(rtol=2e-5, atol=2e-4)      # tests/test_golden.py:29-36
H2_TOL = dict(rtol=1e-8, atol=1e-12)


#: the script's start: ``say`` prints the seconds since it
T_START = time.time()


def say(phase: str, msg: str) -> None:
    print(f"[{phase} +{time.time() - T_START:.1f}s] {msg}", flush=True)


def synthetic_genotypes(rng, m: int, n: int, missing_rate: float = 0.0,
                        chunk: int = 4096, copy_rate=0.8) -> np.ndarray:
    """int8 (m, n) codes with MAF in [0.05, 0.5] and local LD: each SNP
    copies its predecessor at ``copy_rate`` of the samples (a scalar, or
    one rate per SNP)."""
    out = np.empty((m, n), dtype=np.int8)
    mafs = rng.uniform(0.05, 0.5, m).astype(np.float32)
    rate = np.broadcast_to(np.asarray(copy_rate, np.float32), (m,))
    prev = None
    for s in range(0, m, chunk):
        c = min(chunk, m - s)
        p = mafs[s:s + c, None]
        fresh = ((rng.random((c, n), dtype=np.float32) < p).astype(np.int8)
                 + (rng.random((c, n), dtype=np.float32) < p))
        keep = rng.random((c, n), dtype=np.float32) < rate[s:s + c, None]
        for i in range(c):
            row = fresh[i] if prev is None else np.where(keep[i], prev,
                                                         fresh[i])
            out[s + i] = row
            prev = out[s + i]
        if missing_rate > 0:
            miss = rng.random((c, n), dtype=np.float32) < missing_rate
            out[s:s + c][miss] = -1
    return out


#: the UK Biobank-width chromosome (phase 32, scripts/ukb_width_cuda.py):
#: every ``MISS_EVERY``-th SNP carries ``MISS_RATE`` missing genotypes, the
#: copy rate is drawn once per ``RATE_SPAN`` SNPs, SNPs ``SPACING`` bp apart
MISS_EVERY, MISS_RATE, RATE_SPAN, SPACING = 50, 0.05, 512, 100


def pack_codes(torch, codes):
    """int8 (rows, n) codes {0, 1, 2, -1} -> uint8 (rows, ceil(n / 4)) .bed
    bytes, on the codes' device: the bytes
    ``nldsc_tpu_torch.io.plink.encode_bed_bytes`` gives (missing 01, het
    10, hom-A2 11, pad bitpairs 00, the first sample in the low bits)."""
    rows, n = codes.shape
    bits = torch.where(codes < 0, 1, torch.where(codes > 0, codes + 1, 0))
    bps = (n + 3) // 4
    padded = torch.zeros((rows, 4 * bps), dtype=torch.uint8,
                         device=codes.device)
    padded[:, :n] = bits.to(torch.uint8)
    q = padded.view(rows, bps, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def chromosome_blocks(torch, m: int, n: int, seed: int, device,
                      block: int = 256):
    """Yield ``(r0, codes)``: int8 (rows, n) genotype codes of SNPs
    ``[r0, r0 + rows)`` of the UK Biobank-width chromosome, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``, ``block``
    SNPs at a time.  The model is :func:`synthetic_genotypes`'s with a copy
    rate per ``RATE_SPAN`` SNPs (a SNP takes its predecessor's genotype
    where a uniform draw is below the rate, else a fresh binomial(2, MAF)
    one, drawn from a second uniform by its inverse CDF; one ``torch.where``
    per row), then ``MISS_RATE`` of the genotypes of every
    ``MISS_EVERY``-th SNP set missing."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    maf = torch.rand(m, generator=gen, device=dev) * 0.45 + 0.05
    rate = (torch.rand(-(-m // RATE_SPAN), generator=gen, device=dev) * 0.67
            + 0.3).repeat_interleave(RATE_SPAN)[:m]
    prev = None
    for r0 in range(0, m, block):
        rows = min(block, m - r0)
        u = torch.rand((2, rows, n), generator=gen, device=dev)
        p = maf[r0:r0 + rows, None]
        # binomial(2, MAF) from one draw: 0 below (1 - p)^2, 2 above 1 - p^2
        fresh = ((u[0] >= (1 - p) ** 2).to(torch.int8)
                 + (u[0] >= 1 - p * p).to(torch.int8))
        keep = u[1] < rate[r0:r0 + rows, None]
        del u
        codes = torch.empty((rows, n), dtype=torch.int8, device=dev)
        for i in range(rows):
            if prev is None:
                codes[i] = fresh[i]
            else:
                torch.where(keep[i], prev, fresh[i], out=codes[i])
            prev = codes[i]
        del fresh, keep
        prev = prev.clone()
        first = -(-r0 // MISS_EVERY) * MISS_EVERY
        hit = torch.arange(first, r0 + rows, MISS_EVERY, device=dev) - r0
        if len(hit):
            miss = torch.rand((len(hit), n), generator=gen,
                              device=dev) < MISS_RATE
            codes[hit] = torch.where(miss, -1, codes[hit]).to(torch.int8)
        yield r0, codes


def write_chromosome(torch, prefix: str, m: int, n: int, seed: int, device,
                     block: int = 256) -> str:
    """The chromosome of :func:`chromosome_blocks` as a bfile: the .bed
    written block by block from bytes packed on ``device`` (host memory
    stays one block's), the .bim/.fam as ``write_plink`` writes them."""
    from nldsc_tpu_torch.io.plink import PLINK_MAGIC, write_bim_fam

    with open(prefix + ".bed", "wb") as f:
        f.write(PLINK_MAGIC)
        for _, codes in chromosome_blocks(torch, m, n, seed, device, block):
            f.write(pack_codes(torch, codes).cpu().numpy().tobytes())
    write_bim_fam(prefix, m, n,
                  bp=np.arange(1, m + 1, dtype=np.int64) * SPACING)
    return prefix


def clean_copy(raw: np.ndarray, n: int) -> np.ndarray:
    """The packed rows ``raw`` with every missing genotype (01) set to
    hom-A1 (00), row by contaminated row."""
    from nldsc_tpu_torch.io.plink import _miss_bytes, packed_rowmiss

    out = raw.copy()
    for r in np.flatnonzero(packed_rowmiss(raw, n)):
        out[r] &= ~_miss_bytes(raw[r:r + 1], n)[0]
    return out


def adversarial_rows(rng, n: int) -> np.ndarray:
    """Monomorphic, all-het, ultra-rare, normal and half-missing rows."""
    heavy = rng.binomial(2, 0.25, n).astype(np.int8)
    heavy[: n // 2] = -1
    return np.stack([np.zeros(n, np.int8), np.full(n, 2, np.int8),
                     np.ones(n, np.int8),
                     rng.binomial(2, 0.001, n).astype(np.int8),
                     rng.binomial(2, 0.3, n).astype(np.int8), heavy])


def inject_row_missing(rng, g: np.ndarray, row_frac: float,
                       entry_rate: float) -> None:
    """Set ``entry_rate`` of the genotypes of ``row_frac`` of the rows to
    missing, in place."""
    rows = np.sort(rng.choice(g.shape[0], int(g.shape[0] * row_frac),
                              replace=False))
    for s in range(0, len(rows), 4096):
        r = rows[s:s + 4096]
        miss = rng.random((len(r), g.shape[1]), dtype=np.float32) < entry_rate
        g[r] = np.where(miss, np.int8(-1), g[r])


def engine_inputs(torch, g: np.ndarray, pos: np.ndarray, wind: float, dev,
                  materialize_m: bool = True):
    """Preprocessed kernel arguments on ``dev`` for int8 codes ``g``, the
    sample count, whether data is missing, and the raw codes."""
    from nldsc_tpu_torch.io.plink import encode_bed_bytes

    return packed_inputs(torch, encode_bed_bytes(g), g.shape[1],
                         bool((g < 0).any()), pos, wind, dev, materialize_m)


def packed_inputs(torch, packed: np.ndarray, n: int, has_missing: bool,
                  pos: np.ndarray, wind: float, dev,
                  materialize_m: bool = True):
    """``engine_inputs`` from the packed .bed rows ``packed`` of ``n``
    samples."""
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, preprocess, windows
    from nldsc_tpu_torch.ld.pipeline import padded_shape

    m = packed.shape[0]
    m_pad, n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)
    lo, hi, pos_ok = windows.window_bounds(pos, wind)
    raw = np.full((m_pad, (n + 3) // 4), 0x55 if has_missing else 0,
                  np.uint8)
    raw[:m] = packed
    gd = preprocess.unpack_bed(torch.from_numpy(raw).to(dev), n, n_pad,
                               -1 if has_missing else 0)
    ok = np.zeros(m_pad, bool)
    ok[:m] = pos_ok
    pre = ld_int8.preprocess_int8(gd, torch.from_numpy(ok).to(dev), 0.01, n,
                                  assume_no_missing=not has_missing,
                                  materialize_m=materialize_m)
    lo_p = np.full(m_pad, m_pad, np.int32)
    hi_p = np.full(m_pad, -1, np.int32)
    lo_p[:m], hi_p[:m] = lo, hi
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(1e-4))
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            torch.from_numpy(lo_p).to(dev), torch.from_numpy(hi_p).to(dev),
            pre["usable"], dom_ok, pre["add_sd_zero"])
    return args, n, has_missing, gd


def split_args(args, raw, n: int):
    """``split_corrections`` arguments for engine inputs with missing data:
    the contaminated rows, the plan, the compact indicators."""
    from nldsc_tpu_torch.ld import ld_split

    g, _, h, scal, lo, hi, usable, dom_ok, _ = args
    m_pad, n_pad = g.shape
    rowmiss = (scal[:, 8] > float(n_pad - n)) & usable      # cm: padding
    plan = ld_split.plan_split_v2(
        rowmiss.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy(),
        min(ld_split.SEG_ROWS_DEFAULT, m_pad), m_pad)
    m_c = ld_split.compact_missing_rows(raw, plan["miss_idx"])
    return (g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss, RSQ, m_pad, plan)


def compare_deltas(ours, ref) -> float:
    """wse δ exactly equal, l2/l2d δ within KERNEL_TOL; max abs error."""
    np.testing.assert_array_equal(ours[2].cpu().numpy(), ref[2].cpu().numpy())
    err = 0.0
    for a, b in zip(ours[:2], ref[:2]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, **KERNEL_TOL)
        err = max(err, float(np.abs(a - b).max(initial=0.0)))
    return err


def compare_results(ours: dict, ref: dict) -> float:
    """Two ``compute_ld_scores`` results: counters exactly equal, l2/l2d
    within KERNEL_TOL; max abs error."""
    keys = ("l2", "l2d", "l2_ws", "l2d_ws", "l2d_wse")
    return compare([ours[k] for k in keys], [ref[k] for k in keys])


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


def twin_credits(args, n, has_missing, block_size, annot=None):
    from nldsc_tpu_torch.ld import ld_int8

    return ld_int8.sym_scan_segment(
        *args, RSQ, 0, annot, block_size=block_size,
        dot_dtype=ld_int8.dot_dtype_of(args[0]),
        right_k=ld_int8.band_extent(args[5], block_size)[1], n_samples=n,
        n_scan_blocks=args[0].shape[0] // block_size,
        has_missing=has_missing)


#: published dense peaks of one H100 SXM (int8, bf16 and tf32 tensor
#: cores, float32 outside the tensor cores, HBM3)
INT8_OPS = 1979e12
BF16_OPS = 989e12
TF32_OPS = 495e12
FP32_OPS = 67e12
HBM_BYTES = 3.35e12
#: the tensor-core peak and the bytes per operand element of each
#: ``--dot-dtype``
DOT_PEAK = {"int8": (INT8_OPS, 1), "bf16": (BF16_OPS, 2)}


def bound(ops: float, nbytes: float, peak_ops: float = INT8_OPS) -> dict:
    """The least time the card could take for ``ops`` operations that
    must move ``nbytes``: the larger of the two times, and which it is."""
    t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_work(hi, n_pad: int, has_missing: bool, tile: int,
            dot_dtype: str = "int8") -> dict:
    """K1's work on inputs with window ends ``hi`` (int32, padding rows
    -1): ``ops``, the tensor-core operations of the in-window pairs i <= j
    (2 per sample per product: 3 products clean, 8 missing); ``tile_ops``,
    those of the tiles the kernel computes; ``bytes``, each input read
    once (g, h and m if missing, 1 byte a code, 2 in bf16; the per-row
    scalars and flags) and the six credit vectors written once; and its
    ``bound`` at the peak of ``dot_dtype``'s operands."""
    import torch

    peak, esize = DOT_PEAK[dot_dtype]

    m_pad = hi.shape[0]
    rows = torch.arange(m_pad, device=hi.device)
    pairs = int((hi.long() - rows + 1).clamp(min=0).sum())
    nprod = 8 if has_missing else 3
    nt = m_pad // tile
    blk_hi = torch.div(hi.view(nt, tile).amax(dim=1), tile,
                       rounding_mode="floor").clamp(max=nt - 1)
    ctas = int((blk_hi - torch.arange(nt, device=hi.device) + 1)
               .clamp(min=0).sum())
    ops = 2.0 * nprod * n_pad * pairs
    nbytes = (3 if has_missing else 2) * esize * m_pad * n_pad + m_pad * (
        9 * 4 + 2 * 4 + 3) + 6 * 4 * m_pad
    return {"ops": ops, "tile_ops": 2.0 * nprod * n_pad * ctas * tile * tile,
            "ctas": ctas, "pairs": pairs, "bytes": nbytes,
            **bound(ops, nbytes, peak)}


def k1_cluster(torch, dev, has_missing: bool, n_pad: int,
               annot: bool = False, bf16: bool = False) -> str:
    """The cluster shape K1 runs in on rows of ``n_pad`` samples and
    ``cudaOccupancyMaxActiveClusters`` of that instantiation on ``dev``,
    for the lines beside its times."""
    from nldsc_tpu_torch.ld import ld_pallas_sym

    cp, cn = ld_pallas_sym.cluster_shape(n_pad, has_missing, bf16)
    n = ld_pallas_sym.max_active_clusters(dev, has_missing, annot, bf16,
                                          (cp, cn) != (1, 1))
    return (f"clusters of {cp} x {cn} CTAs (pivot x neighbour tiles; 2 x 2 "
            f"from {ld_pallas_sym.CLUSTER_MIN_STAGES[has_missing]} ring "
            f"stages), {n} resident ({n * cp * cn} CTAs)")


def k1_products_library_ms(torch, args, has_missing: bool, tile: int,
                           reps: int = 3) -> dict:
    """``torch._int_mm`` (cuBLASLt) on the products K1 computes, in two
    forms, CUDA events over the calls alone after a warm-up pass.

    Per tile (``ms``, ``calls``, ``ops``): exactly K1's products, one call
    a product of a pivot tile b (``tile`` rows) against its band's rows
    ``[b T, (tile_hi[b] + 1) T)`` with the right operands stacked: clean
    g_b [g; h]^T and h_b g^T, with missing genotypes g_b [h; g; m]^T, h_b
    [g; m]^T and m_b [h; g; m]^T (the stacked operands interleaved tile by
    tile, so a band is one slice: the same products, the columns in
    another order).  Stacked (``stacked_ms``, ``stacked_calls``,
    ``stacked_ops``): the same calls over groups of 1,024 pivot rows
    against the union of their bands, which fill the card but compute up
    to twice the products.  The port never calls either: K1 fuses its
    epilogue onto these products."""
    from nldsc_tpu_torch.ld import ld_int8

    g, m, h = args[:3]
    nt, n = g.shape[0] // tile, g.shape[1]
    mats = {"g": g, "h": h, "m": m}
    pairs = ({"g": "hgm", "h": "gm", "m": "hgm"} if has_missing
             else {"g": "gh", "h": "g"})
    tile_hi = ld_int8.block_hi(args[5], tile).clamp(max=nt - 1).tolist()
    group = max(1, 1024 // tile)

    def stacked(cs, x0, x1):
        """Tiles [x0, x1) of the operands ``cs``, interleaved tile by
        tile: (x1 - x0) * len(cs) * tile rows."""
        parts = torch.stack([mats[c][x0 * tile:x1 * tile].view(
            x1 - x0, tile, n) for c in cs], dim=1)
        return parts.view(-1, n)

    def one_pass(per_tile: bool):
        """The pass's calls, group by group: the group's stacked operands
        built outside the timed spans; (milliseconds, calls, ops)."""
        spans, calls, ops = [], 0, 0.0
        for x0 in range(0, nt, group):
            x1 = min(x0 + group, nt)
            live = [b for b in range(x0, x1) if tile_hi[b] >= b]
            if not live:
                continue
            y1 = max(tile_hi[b] for b in live) + 1
            right = {cs: stacked(cs, x0, y1) for cs in set(pairs.values())}
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in "se")
            start.record()
            for a, cs in pairs.items():
                k = len(cs) * tile
                if per_tile:
                    for b in live:
                        y = right[cs][(b - x0) * k:(tile_hi[b] + 1 - x0) * k]
                        torch._int_mm(mats[a][b * tile:(b + 1) * tile], y.t())
                        calls += 1
                        ops += 2.0 * tile * y.shape[0] * n
                else:
                    y = right[cs]
                    torch._int_mm(mats[a][x0 * tile:x1 * tile], y.t())
                    calls += 1
                    ops += 2.0 * (x1 - x0) * tile * y.shape[0] * n
            end.record()
            spans.append((start, end))
            del right
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans), calls, ops

    out = {}
    for per_tile, key in ((True, ""), (False, "stacked_")):
        one_pass(per_tile)                                  # warm up
        runs = [one_pass(per_tile) for _ in range(reps)]
        out.update({f"{key}ms": sum(r[0] for r in runs) / reps,
                    f"{key}calls": runs[0][1], f"{key}ops": runs[0][2]})
    return out


def annot_bound(work: dict, pairs: int, m_pad: int, p: int,
                int8_ops: float, f32_ops: float = 0.0,
                peak: float = INT8_OPS, tensor_cores: bool = False) -> dict:
    """A kernel's work with its annotation epilogue: ``work`` (its plain
    ``bytes``) plus 4 contractions x 2 float32 operations x ``p`` per
    counted pair, the annotation matrix read once and the two (m_pad, p)
    accumulators written once.  On the tensor cores (``tensor_cores``, K1
    and K2) each is three tf32 products (hi + lo split) at the tf32 rate;
    else those operations run at the float32 rate.  The
    operations' times add (the products, then the epilogue's); the bound
    is the larger of that and the bytes' time."""
    epi_ops = 4.0 * 2.0 * p * pairs
    t_epi = 3 * epi_ops / TF32_OPS if tensor_cores else epi_ops / FP32_OPS
    nbytes = work["bytes"] + 3 * 4 * m_pad * p
    t_ops = int8_ops / peak + f32_ops / FP32_OPS + t_epi
    t_bytes = nbytes / HBM_BYTES
    return {"annot_f32_ops": epi_ops,
            "annot_rate": "3 tf32 products" if tensor_cores else "float32",
            "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_annot_work(work: dict, m_pad: int, p: int,
                  dot_dtype: str = "int8") -> dict:
    """K1's work with ``p`` annotations, from ``k1_work``'s ``work`` on
    the same ``m_pad`` rows (and ``dot_dtype``): the epilogue on the
    tensor cores."""
    return annot_bound(work, work["pairs"], m_pad, p, work["ops"],
                       peak=DOT_PEAK[dot_dtype][0], tensor_cores=True)


def annot_values(rng, m: int, p: int) -> np.ndarray:
    """(m, p) annotations, float64 holding float32 values: the first
    column all ones (``base``, as in the baseline model), the next two
    binary (30% ones), the rest continuous in [0, 1)."""
    a = rng.random((m, p), dtype=np.float32)
    a[:, 0] = 1.0
    a[:, 1:3] = a[:, 1:3] < 0.3
    return a.astype(np.float64)


def seeded_annot(torch, m_pad: int, m: int, p: int, seed: int, dev):
    """``annot_values`` from ``seed`` as the kernels take them: float32
    (m_pad, p) on ``dev``, zero rows for the padding."""
    out = np.zeros((m_pad, p), np.float32)
    out[:m] = annot_values(np.random.default_rng(seed), m, p)
    return torch.from_numpy(out).to(dev)


def max_abs_diff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def hold_accumulators(kern, ref, what: str) -> float:
    """The annotation accumulators ``kern`` within KERNEL_TOL of the plain
    version's ``ref`` (tensors on any device); their max abs error."""
    err = 0.0
    for a, b in zip(kern, ref):
        a, b = a.cpu(), b.cpu()
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=what,
                                   **KERNEL_TOL)
        err = max(err, max_abs_diff(a, b))
    return err


def masked_values(torch, g, m, rest, n: int, has_missing: bool) -> tuple:
    """The masked pair values of the pass in K1's tiles
    (``ld_int8.sym_tile_values``), zero-padded to the band: the rows'
    and the mirrored columns' ``(2, n_tiles, T, band T)`` (additive and
    dominance values)."""
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym

    T = ld_pallas_sym.tile(has_missing)
    nt = g.shape[0] // T
    band = ld_int8.band_extent(rest[3], T)[1]
    v_row = torch.zeros((2, nt, T, band * T), dtype=torch.float32,
                        device=g.device)
    v_col = torch.zeros_like(v_row)
    for x, K, vals, _ in ld_int8.sym_tile_values(
            g, m, *rest, RSQ, tile=T, n_samples=n, has_missing=has_missing):
        for q in range(2):
            v_row[q, x, :, :K * T] = vals[0][q]
            v_col[q, x, :, :K * T] = vals[1][q]
    return v_row, v_col


def epilogue_bmm_ms(torch, values: tuple, annot, reps: int = 3) -> dict:
    """The library yardstick of K1's annotation epilogue: one float32
    ``torch.bmm`` per direction (TF32 off, set and restored) with the
    contraction's shape, on the pass's masked values (``masked_values``):
    the rows, ``(2 n_tiles, T, band T) x (2 n_tiles, band T, p)``
    (additive and dominance values, the neighbours' annotations), and the
    mirrored columns, ``(2 n_tiles, band T, T) x (2 n_tiles, T, p)``.
    Returns the two times, their sum ``ms`` and the shape."""
    v_row, v_col = values
    _, nt, T, bT = v_row.shape
    p = annot.shape[1]
    a_pad = torch.cat([annot, annot.new_zeros((bT, p))])
    a_cols = a_pad.as_strided((nt, bT, p), (T * p, p, 1)).repeat(2, 1, 1)
    a_rows = annot.view(nt, T, p).repeat(2, 1, 1)
    lhs_r = v_row.view(2 * nt, T, bT)
    lhs_c = v_col.view(2 * nt, T, bT).transpose(1, 2)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows_ms = cuda_ms(torch, lambda: torch.bmm(lhs_r, a_cols), reps)
        cols_ms = cuda_ms(torch, lambda: torch.bmm(lhs_c, a_rows), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    del a_cols, a_rows
    return {"rows_ms": rows_ms, "cols_ms": cols_ms, "ms": rows_ms + cols_ms,
            "shape": f"({2 * nt}, {T}, {bT}) x ({2 * nt}, {bT}, {p})"}


def k2_epilogue_bmm_ms(torch, n_live: int, p: int, dev,
                       reps: int = 3) -> dict:
    """The library yardstick of K2's annotation epilogue: one float32
    ``torch.bmm`` per direction (TF32 off, set and restored) with the
    contraction's shape over the ``n_live`` live tiles, both values, on
    seeded operands: the rows, ``(2 n_live, 128, 32) x (2 n_live, 32, p)``
    (the staged credits to x, the compact columns' annotations), and the
    mirrored columns, ``(2 n_live, 32, 128) x (2 n_live, 128, p)``.
    Returns the two times, their sum ``ms`` and the shapes."""
    from nldsc_tpu_torch.ld import ld_split

    TM, TC, B = ld_split.TILE_X, ld_split.TILE_C, 2 * n_live
    gen = torch.Generator(device=dev).manual_seed(2026)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    v_row, a_col, v_col, a_row = (rand(B, TM, TC), rand(B, TC, p),
                                  rand(B, TC, TM), rand(B, TM, p))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows_ms = cuda_ms(torch, lambda: torch.bmm(v_row, a_col), reps)
        cols_ms = cuda_ms(torch, lambda: torch.bmm(v_col, a_row), reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    del v_row, a_col, v_col, a_row
    return {"rows_ms": rows_ms, "cols_ms": cols_ms, "ms": rows_ms + cols_ms,
            "shape": f"({B}, {TM}, {TC}) x ({B}, {TC}, {p}) and ({B}, {TC}, "
                     f"{TM}) x ({B}, {TM}, {p})"}


def aux_timing(torch, sargs, p: int, dev, reps: int = 10) -> dict:
    """K2's two small kernels of ``split_corrections(annot=)`` on
    ``split_args`` inputs, each held against its plain version on the card
    (bitwise) and timed beside it, with its bound (each input read once,
    each output written once): the reach kernel (``ld_split.live_tiles``:
    the fused launch's live tiles) and the fold kernel
    (``ld_split.fold_annot``) on seeded partials of the live tiles' shape,
    whose library yardstick is ``index_add_`` of the row and the column
    partials into the output (two calls, their order of addition not
    fixed; none for the reach kernel)."""
    from nldsc_tpu_torch.ld import ld_split

    g, _, _, _, lo, hi, *_, plan = sargs
    m_pad, S, P = g.shape[0], plan["seg_rows"], plan["p_band"]
    TM, TC = ld_split.TILE_X, ld_split.TILE_C
    ops = ld_split._operands(*sargs[:3], plan)
    seg, cidx = ops["seg_x"], ops["cidx"]
    reach_args = (seg, lo, hi, cidx, S, P)
    before = (ld_split.reach_launches, ld_split.fold_launches)
    live = ld_split.live_tiles(*reach_args)
    if not torch.equal(live, ld_split.live_tiles_plain(*reach_args)):
        raise RuntimeError("the reach kernel differs from its plain version")
    slot = ld_split.tile_slots(live)
    n_live = int(slot.max()) + 1
    gen = torch.Generator(device=dev).manual_seed(2026)
    pld = ld_split.annot_ld(p)
    rpa = torch.randn((n_live, 2, TM, pld), generator=gen, device=dev)
    cpa = torch.randn((n_live, TC, 2, pld), generator=gen, device=dev)
    real = cidx[:plan["n_miss"]]
    args = (rpa, cpa, slot, seg, real, S, m_pad, p)
    kern, plain = ld_split.fold_annot(*args), ld_split.fold_annot_plain(*args)
    if (ld_split.reach_launches, ld_split.fold_launches) != (
            before[0] + 1, before[1] + 1):
        raise RuntimeError("the reach and fold kernels were not launched")
    if not all_bits_equal(torch, kern, plain):
        raise RuntimeError("the annotation fold kernel differs from its "
                           "plain version")
    # the yardstick's destinations: every slot row's output row (v, gx),
    # every slot column's (v, its compact row's global row); the rows
    # and columns no output takes go to a last row
    n_xt, n_ct = slot.shape[1:]
    tiles = torch.nonzero(slot.view(-1) >= 0).view(-1)
    t_sx, ct = tiles // n_ct, tiles % n_ct
    t_s, xt = t_sx // n_xt, t_sx % n_xt
    fl = seg.long()
    v = torch.arange(2, device=dev)
    xl = xt[:, None] * TM + torch.arange(TM, device=dev)
    gx = fl[t_s, 0][:, None] + xl
    owned = (gx >= fl[t_s, 3][:, None]) & (xl < S)
    dest_r = torch.where(owned[:, None], v[:, None] * m_pad + gx[:, None],
                         2 * m_pad)
    cl = ct[:, None] * TC + torch.arange(TC, device=dev)
    cc = (fl[t_s, 1][:, None] + cl).clamp(max=real.shape[0] - 1)
    dest_c = torch.where((cl < fl[t_s, 2][:, None])[:, :, None],
                         v * m_pad + real.long()[cc][:, :, None], 2 * m_pad)
    out = torch.zeros((2 * m_pad + 1, p), device=dev)
    rows_src, cols_src = (t[..., :p].reshape(-1, p) for t in (rpa, cpa))
    dr, dc = dest_r.reshape(-1), dest_c.reshape(-1)

    def library():
        out.index_add_(0, dr, rows_src)
        out.index_add_(0, dc, cols_src)

    f_bytes = (rpa.nbytes + cpa.nbytes + slot.nbytes + seg.nbytes
               + real.nbytes + 2 * 4 * m_pad * p)
    r_bytes = lo.nbytes + hi.nbytes + cidx.nbytes + seg.nbytes + 4 * slot.numel()
    out_d = {
        "fold": {"ms": cuda_ms(torch, lambda: ld_split.fold_annot(*args),
                               reps),
                 "plain_ms": cuda_ms(
                     torch, lambda: ld_split.fold_annot_plain(*args), 3),
                 "library_ms": cuda_ms(torch, library, reps),
                 "max_abs_err": 0.0, "live_tiles": n_live, "bytes": f_bytes,
                 **bound(0.0, f_bytes)},
        "reach": {"ms": cuda_ms(torch,
                                lambda: ld_split.live_tiles(*reach_args),
                                reps),
                  "plain_ms": cuda_ms(
                      torch, lambda: ld_split.live_tiles_plain(*reach_args),
                      3),
                  "library_ms": None, "max_abs_err": 0.0,
                  "tiles": slot.numel(), "live_tiles": n_live,
                  "bytes": r_bytes, **bound(0.0, r_bytes)}}
    del rpa, cpa, rows_src, cols_src, out, kern, plain
    return out_d


def k2_device_split(torch, fn, reps: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` (``split_corrections``),
    from the profiler: K2's fused launch, its products launch (d) and
    every other device op (``other``; ``n_other`` of them per call).  One
    call runs first as the profiler's warm-up step: without it a phase
    19 run on the H100 recorded the kernels of two calls of three."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=reps)) as prof:
        for i in range(reps + 1):
            fn()
            torch.cuda.synchronize()
            if i < reps:     # the last active step ends with the profile
                prof.step()
    out = {"fused": 0.0, "products": 0.0, "other": 0.0, "n_other": 0}
    for e in prof.key_averages():
        # the steps' own ranges span their device time: not an op
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue
        ms = e.self_device_time_total / 1e3 / reps
        if "split_corr_kernel" in e.key:
            fused = "<true" in e.key or "ILb1E" in e.key
            out["fused" if fused else "products"] += ms
        else:
            out["other"] += ms
            out["n_other"] += e.count // reps
    return out


def check_k1_annot(torch, args, n: int, has_missing: bool, annot,
                   plain) -> float:
    """K1's annotation epilogue on engine inputs ``args``: two launches
    bitwise equal, its six plain credit vectors bitwise equal to the
    plain launch's (``plain``), its two accumulators within KERNEL_TOL of
    the twin's; the accumulators' max abs error."""
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym

    T = ld_pallas_sym.tile(has_missing)

    def run():
        return ld_pallas_sym.sym_credits(
            *args, RSQ, n_samples=n, has_missing=has_missing, block_size=T,
            annot=annot)

    before = ld_pallas_sym.annot_launches
    kern, again = run(), run()
    torch.cuda.synchronize()
    per_call = -(-annot.shape[1] // ld_pallas_sym.annot_max(has_missing))
    if ld_pallas_sym.annot_launches != before + 2 * per_call:
        raise RuntimeError("the annotation epilogue was not launched once "
                           "per group of annotations")
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise RuntimeError("two annot kernel runs differ")
    if not all(torch.equal(a, b) for a, b in zip(kern[:6], plain)):
        raise RuntimeError("an annot launch's plain credits differ from the "
                           "plain launch's")
    twin = ld_int8.sym_scan_segment(
        *args, RSQ, 0, annot, block_size=T,
        right_k=ld_int8.band_extent(args[5], T)[1], n_samples=n,
        n_scan_blocks=args[0].shape[0] // T, has_missing=has_missing)
    return hold_accumulators(kern[6:], twin[6:], "K1's accumulators")


#: float32 operations of K2's fused epilogue per counted pair: pair_adj
#: twice (exact and clean, 70 each), the exact call's 7 masked sums, the 3
#: differences and the 6 row and column sums
EPI_OPS_PER_PAIR = 2 * 70 + 7 + 3 + 6


def k2_work(sargs, dot_dtype: str = "int8") -> dict:
    """K2's work in one split pass on ``split_args`` inputs, counted from
    this run's data.  ``pairs``: the pairs the epilogue evaluates (in
    window, both usable, left member below ``own_hi``), ``d_pairs`` those
    of them whose x row is contaminated; ``int8_ops``: 2 per sample of
    each product those pairs need (5 per pair: Sgg, Sgm, Sgh, Shg, Shm,
    and 3 more, d, per contaminated pair); ``tile_ops``, those of the
    tiles K2 computes: the fused launch's ``live`` tiles (those that reach
    a window, picked as the kernel picks them) and every tile of the d
    launch; ``f32_ops``; ``bytes``: g once per segment, the compact
    operands g_c, m_c, h_c once, d once, the per-row and per-column inputs
    once per segment and the partials written.  The bound adds the
    operations' times (tensor cores, then the float32 rate) and takes the
    larger of that and the bytes' time.  ``old_k2_ms`` and
    ``old_delta_ms`` are the earlier yardstick: two kernels, the padded
    products written to memory and read back, pair_adj counted twice per
    padded pair.  ``dot_dtype``: the operands' peak rate and bytes per
    code (the bf16 instantiations read 2)."""
    import torch
    from nldsc_tpu_torch.ld import ld_split

    peak, esize = DOT_PEAK[dot_dtype]
    g, m_c, _, _, lo, hi, usable, _, rowmiss, _, own_hi, plan = sargs
    m_pad, n_pad = g.shape
    S, P, p_x, n_segs = (plan["seg_rows"], plan["p_band"], plan["p_x"],
                         plan["n_segs"])
    TM, TC = ld_split.TILE_X, ld_split.TILE_C
    n_ct, n_xt = -(-P // TC), -(-S // TM)
    tab = ld_split.segment_table(plan, m_pad)
    idx = torch.as_tensor(plan["miss_idx"], dtype=torch.long, device=g.device)
    cl = torch.arange(n_ct, device=g.device) * TC
    pairs = d_pairs = live = 0
    for s in range(n_segs):
        s0, seg_lo, c0, c_cnt = (int(tab[k][s]) for k in (
            "s0", "seg_lo", "c0", "c_cnt"))
        rows = torch.arange(max(s0, seg_lo), s0 + S, device=g.device)
        cid = idx[c0:c0 + c_cnt][None, :]
        r = rows[:, None]
        mask = (usable[r] & usable[cid] & (cid >= lo[r]) & (cid <= hi[r])
                & (cid != r) & (torch.minimum(r, cid) < own_hi))
        pairs += int(mask.sum())
        d_pairs += int((mask & rowmiss[r]).sum())
        # the kernel's test: an owned row whose window reaches the span of
        # the tile's real compact columns
        c_end = (cl + TC).clamp(max=c_cnt)
        first = idx[c0 + cl.clamp(max=max(c_cnt - 1, 0))]
        last = idx[c0 + (c_end - 1).clamp(min=0)]
        hit = torch.zeros((n_xt * TM, n_ct), dtype=torch.bool,
                          device=g.device)
        hit[rows - s0] = ((lo[r] <= last) & (hi[r] >= first)
                          & (cl < c_end))
        live += int(hit.view(n_xt, TM, n_ct).any(dim=1).sum())
    int8_ops = 2.0 * n_pad * (5 * pairs + 3 * d_pairs)
    tile_ops = 2.0 * n_pad * TM * TC * (
        5 * live + 3 * n_segs * n_ct * -(-p_x // TM))
    f32_ops = float(EPI_OPS_PER_PAIR * pairs)
    nbytes = (esize * (n_segs * S * n_pad + 3 * m_c.shape[0] * n_pad)
              + 4 * n_segs * p_x * 3 * P
              + n_segs * (S * (9 * 4 + 3 * 4 + 3) + P * (9 * 4 + 4 + 2))
              + 12 * (n_ct * m_pad + n_segs * n_xt * P))
    t_ops = int8_ops / peak + f32_ops / FP32_OPS
    t_bytes = nbytes / HBM_BYTES
    outs = S * 3 * P + S * 2 * P + p_x * 3 * P
    old_k2 = bound(n_segs * 2.0 * n_pad * outs,
                   n_segs * ((S + 3 * P + p_x) * n_pad + 4 * outs))
    old_delta = bound(n_segs * 2 * 70.0 * S * P,
                      n_segs * (4 * outs + (9 * 4 + 3 * 4) * (S + P)),
                      FP32_OPS)
    return {"int8_ops": int8_ops, "tile_ops": tile_ops, "pairs": pairs,
            "d_pairs": d_pairs, "live": live, "tiles": n_segs * n_xt * n_ct,
            "f32_ops": f32_ops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "old_k2_ms": old_k2["bound_ms"],
            "old_delta_ms": old_delta["bound_ms"]}


def split_timing(torch, args, sargs, raw, n: int, reps: int = 5) -> dict:
    """K2 on the split route's inputs: ``args`` from ``engine_inputs``
    (lazy m), ``sargs`` from ``split_args``, the raw codes ``raw``.

    ``split_corrections`` against its twin (wse δ equal, l2/l2d δ within
    KERNEL_TOL) and both times, with K2's launches inside it by mode and
    the largest other device ops (profiler); K2's products mode against
    ``torch._int_mm`` (cuBLASLt) on the same products, a and b per
    segment with h read from memory and d (exactly equal), and both
    times; K1's clean pass and the global 8-product pass on the same rows;
    and ``k2_work``.  Raises on any disagreement.
    """
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split

    plan = sargs[-1]
    P = plan["p_band"]
    out = {"work": k2_work(sargs)}
    # the yardstick's operands, per segment: x, h(x) read from memory
    # (preprocessing's h), cat3 and m_xc
    lib_ops = [(x, sargs[2][s0:s0 + x.shape[0]], cat3, m_xc)
               for _, s0, *_, x, cat3, m_xc
               in ld_split.segments(*sargs[:3], plan)]

    def library():
        return [(torch._int_mm(x, cat3.t()),
                 torch._int_mm(hx, cat3[:2 * P].t()),
                 torch._int_mm(m_xc, cat3.t()))
                for x, hx, cat3, m_xc in lib_ops]

    def products():
        return ld_split.segment_products(*sargs[:3], plan)

    def corrections():
        return ld_split.split_corrections(*sargs, n_samples=n)

    def corrections_plain():
        return ld_split.split_corrections_plain(*sargs, n_samples=n)

    def k1(has_missing, m=args[1]):
        return ld_pallas_sym.sym_credits(
            args[0], m, *args[2:], RSQ, n_samples=n, has_missing=has_missing,
            block_size=ld_pallas_sym.tile(has_missing))

    ours = products()
    for s_, refs in enumerate(library()):     # K2 = cuBLASLt, exactly
        for o, r in zip((ours[0][s_], ours[1][s_], ours[2][s_]), refs):
            if not torch.equal(o, r):
                raise RuntimeError("K2's products mode differs from "
                                   f"torch._int_mm in segment {s_}")
    del ours
    kern = corrections()
    if not all(torch.equal(a, b) for a, b in zip(kern, corrections())):
        raise RuntimeError("two split_corrections runs differ")
    out["err"] = compare_deltas(kern, corrections_plain())
    del kern
    out["ms_products"] = cuda_ms(torch, products, reps)
    out["ms_library"] = cuda_ms(torch, library, reps)
    out["ms_corr"] = cuda_ms(torch, corrections, 2 * reps)
    out["ms_corr_plain"] = cuda_ms(torch, corrections_plain, 2)
    # K2's own device time inside split_corrections, by mode
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            corrections()
        torch.cuda.synchronize()
    k2_dev, other = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "split_corr_kernel" in e.key:
            mode = ("fused" if "<true" in e.key or "ILb1E" in e.key
                    else "d products")
            k2_dev[mode] = k2_dev.get(mode, 0.0) + e.self_device_time_total / 3e3
        else:
            other.append((e.self_device_time_total / 3e3, e.count // 3,
                          e.key[:60]))
    other.sort(reverse=True)
    out.update(k2_dev=k2_dev, other=other,
               ms_k2=sum(k2_dev.values()) if k2_dev else None)
    out["ms_k1_clean"] = cuda_ms(torch, lambda: k1(False), reps)
    del lib_ops
    m_full = ld_int8.materialize_missing(raw)
    out["ms_k1_miss"] = cuda_ms(torch, lambda: k1(True, m_full), reps)
    return out


def split_report(t: dict, plan: dict, shape: str, card: str) -> list:
    """``split_timing``'s numbers as (tag, line) pairs."""
    w, ms_corr, ms_k2 = t["work"], t["ms_corr"], t["ms_k2"]
    other = t["other"]
    k2_text = (", ".join(f"{k} {v:.3f} ms" for k, v in t["k2_dev"].items())
               if t["k2_dev"] else "not measured (no device time traced)")
    return [
        ("10 trace", f"split_corrections, per call: K2 {ms_k2 or 0.0:.3f} "
         f"ms, {sum(c for _, c, _ in other)} other device ops "
         f"{sum(x for x, _, _ in other):.3f} ms, of {ms_corr:.3f} ms "
         "between CUDA events; largest others: "
         + "; ".join(f"{k} x{c} {x:.3f} ms" for x, c, k in other[:6])),
        ("10 timing", f"{shape}, {plan['n_miss']} contaminated rows, "
         f"P={plan['p_band']}, p_x={plan['p_x']}, {plan['n_segs']} segments "
         f"of {plan['seg_rows']} rows: split_corrections {ms_corr:.3f} ms "
         f"(K2's launches in it: {k2_text}) vs twin "
         f"{t['ms_corr_plain']:.3f} ms (wse equal, max |l2,l2d| diff "
         f"{t['err']:.3g}, runs bitwise equal); K2 products mode (a, b, d "
         f"of every segment, 2 launches) {t['ms_products']:.3f} ms vs "
         f"torch._int_mm on the same products {t['ms_library']:.3f} ms "
         f"(exactly equal); LD pass: split {t['ms_k1_clean']:.3f} + "
         f"{ms_corr:.3f} = {t['ms_k1_clean'] + ms_corr:.3f} ms vs global "
         f"8-product {t['ms_k1_miss']:.3f} ms; on {card}"),
        ("10 bounds", f"K2: {w['pairs']} counted pairs ({w['d_pairs']} with "
         f"a contaminated x row) need {w['int8_ops'] / 1e12:.3f} T int8 ops "
         f"and {w['pairs']} x {EPI_OPS_PER_PAIR} = "
         f"{w['f32_ops'] / 1e9:.3f} G f32 ops, {w['bytes'] / 1e9:.3f} GB: "
         f"bound {w['bound_ms']:.3f} ms ({w['bound_by']}), "
         f"{100 * w['bound_ms'] / ms_corr:.1f}% of split_corrections; "
         f"the fused launch computes {w['live']} of its {w['tiles']} tiles, "
         f"{w['tile_ops'] / 1e12:.3f} T int8 ops with the d launch's; "
         + (f"{100 * w['bound_ms'] / ms_k2:.1f}% of K2's launches, "
            f"{w['tile_ops'] / ms_k2 / 1e9:.0f} int8 TOPS in their tiles "
            f"({w['int8_ops'] / ms_k2 / 1e9:.0f} on the ops needed); "
            if ms_k2 else "")
         + "the earlier yardstick (products written and read back, two "
         f"kernels): K2 {w['old_k2_ms']:.3f} + δ {w['old_delta_ms']:.3f} = "
         f"{w['old_k2_ms'] + w['old_delta_ms']:.3f} ms")]


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


def device_busy_ms(torch, prof) -> float:
    """Milliseconds of device work (kernels and copies) in a profile."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def launch_counts() -> dict:
    from nldsc_tpu_torch.ld import ld_pallas_sym, ld_split

    return {"ld_sym": ld_pallas_sym.launches,
            "ld_sym_8prod": ld_pallas_sym.missing_launches,
            "ld_sym_annot": ld_pallas_sym.annot_launches,
            "ld_sym_bf16": ld_pallas_sym.bf16_launches,
            "split_corr": ld_split.corr_launches,
            "split_fused": ld_split.fused_launches,
            "split_annot": ld_split.annot_launches,
            "split_reach": ld_split.reach_launches,
            "split_fold": ld_split.fold_launches,
            "split_bf16": ld_split.bf16_launches,
            "ld_sym_by_device": dict(ld_pallas_sym.device_launches),
            "split_by_device": dict(ld_split.device_launches)}


def reset_counts() -> None:
    from nldsc_tpu_torch.ld import ld_pallas_sym, ld_split

    ld_pallas_sym.launches = ld_pallas_sym.missing_launches = 0
    ld_pallas_sym.annot_launches = ld_pallas_sym.bf16_launches = 0
    ld_split.corr_launches = ld_split.fused_launches = 0
    ld_split.annot_launches = ld_split.bf16_launches = 0
    ld_split.reach_launches = ld_split.fold_launches = 0
    ld_pallas_sym.device_launches.clear()
    ld_split.device_launches.clear()


def run_cli(prefix: str, out: str):
    """One ``ld`` run through the port's CLI; returns the kernel launches
    counted in it and its wall seconds."""
    from nldsc_tpu_torch.cli import main as cli_main

    reset_counts()
    t0 = time.time()
    cli_main(["ld", "--bfile", prefix, "-kb", "100", "-maf", "0.01",
              "--extra", "-o", out])
    return launch_counts(), time.time() - t0


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


def write_h2_inputs(l2_path: str, root: str, rng, n_chr: int = 18,
                    n_gwas: float = 100_000.0, h2: float = 0.3,
                    d2: float = 0.05, n_absent: int = 3000) -> dict:
    """The ``h2`` inputs of phases 11-12, built from one ``.L2`` file:

    * ``root/ld``: ``n_chr`` copies of it as chromosomes 1..n_chr with
      unique SNP ids, each with the file's own .M/.M_5_50;
    * ``root/part``: the same rows split into two annotations,
      A.L2 = a·L2 and B.L2 = (1−a)·L2 with a ~ U[0, 1] per SNP, with
      headered per-annotation .M_5_50 sidecars (the sums of a and 1−a);
    * ``root/trait.sumstats``: Z ~ N(0, 1 + N·h²·L2/M + N·d²·L2D/MD) for
      every LD row (M, MD: the .M_5_50 totals), plus ``n_absent`` SNPs
      the LD directory lacks, rows shuffled.
    """
    from nldsc_tpu_torch.io.ldscores import format_table, read_l2_file, read_m
    from nldsc_tpu_torch.io.plink import Table

    src = read_l2_file(l2_path)
    m = len(src)
    base = Path(l2_path)
    sidecars = {s: base.with_suffix(s).read_text() for s in (".M", ".M_5_50")}
    M, MD = (n_chr * v for v in read_m(str(base.with_suffix(".M_5_50"))))
    ld_dir, part_dir = Path(root, "ld"), Path(root, "part")
    ld_dir.mkdir(parents=True)
    part_dir.mkdir()
    snps = []
    for c in range(1, n_chr + 1):
        snp = np.array([f"rs{c}_{i}" for i in range(m)], dtype=object)
        chrom = np.full(m, c)
        (ld_dir / f"chr{c}.L2").write_text(format_table(Table(
            CHR=chrom, SNP=snp, BP=src["BP"], L2=src["L2"], L2D=src["L2D"])))
        for suffix, text in sidecars.items():
            (ld_dir / f"chr{c}{suffix}").write_text(text)
        a = rng.uniform(0.0, 1.0, m)
        (part_dir / f"chr{c}.L2").write_text(format_table(Table(
            CHR=chrom, SNP=snp, BP=src["BP"],
            **{"A.L2": a * src["L2"], "B.L2": (1.0 - a) * src["L2"]})))
        (part_dir / f"chr{c}.M_5_50").write_text(
            f"A.L2\tB.L2\n{float(a.sum())!r}\t{float((1.0 - a).sum())!r}\n")
        snps.append(snp)
    var = 1.0 + n_gwas * (h2 * np.tile(src["L2"], n_chr) / M
                          + d2 * np.tile(src["L2D"], n_chr) / MD)
    if not (var > 0).all():
        raise RuntimeError("non-positive chi-square expectation")
    snp = np.concatenate(snps + [np.array(
        [f"rsabsent_{i}" for i in range(n_absent)], dtype=object)])
    z = np.concatenate([rng.standard_normal(len(var)) * np.sqrt(var),
                        rng.standard_normal(n_absent)]).tolist()
    ss = Path(root, "trait.sumstats")
    with open(ss, "w") as f:
        f.write("SNP\tZ\tN\n")
        f.writelines(f"{snp[i]}\t{z[i]!r}\t{n_gwas!r}\n"
                     for i in rng.permutation(len(snp)).tolist())
    return {"ld": str(ld_dir), "part": str(part_dir), "ss": str(ss),
            "files": n_chr, "rows": n_chr * m, "n_ss": len(snp),
            "M": M, "MD": MD,
            "l2_mean": float(src["L2"].mean()), "l2_sd": float(src["L2"].std())}


def run_h2_cli(args: list, json_path: str):
    """One ``h2`` run through the port's CLI, saving to ``json_path``;
    the summary and the wall seconds."""
    from nldsc_tpu_torch.cli import main as cli_main

    t0 = time.time()
    cli_main(["h2", *args, "-s", json_path])
    return json.loads(Path(json_path).read_text()), time.time() - t0


def compare_summaries(ours: dict, ref: dict, where: str = "") -> tuple:
    """Every field of two h2 summaries within H2_TOL (flags and names
    equal); the worst relative difference, and the worst share of the
    tolerance ``|ours - ref| / (atol + rtol·|ref|)`` (at most 1)."""
    if set(ours) != set(ref):
        raise RuntimeError(f"summary keys differ at {where or 'top'}")
    worst, share = 0.0, 0.0
    for key, want in ref.items():
        got = ours[key]
        if isinstance(want, dict):
            w, s = compare_summaries(got, want, f"{where}.{key}")
            worst, share = max(worst, w), max(share, s)
        elif isinstance(want, (bool, str)):
            if got != want:
                raise RuntimeError(f"{where}.{key}: {got!r} != {want!r}")
        else:
            np.testing.assert_allclose(got, want, equal_nan=True,
                                       err_msg=f"{where}.{key}", **H2_TOL)
            if np.isfinite(want):
                share = max(share, abs(got - want) / (
                    H2_TOL["atol"] + H2_TOL["rtol"] * abs(want)))
                if want != 0:
                    worst = max(worst, abs(got - want) / abs(want))
    return worst, share


def check_recovery(name: str, hsq: float, std: float, true: float = 0.3,
                   max_std: float = 0.05) -> None:
    """An estimate within 6 of its std of the simulated value, with a std
    small enough for that to bind."""
    if not (np.isfinite(std) and 0 < std < max_std
            and abs(hsq - true) <= 6 * std):
        raise RuntimeError(f"{name}: h2 {hsq} +- {std} is not within 6 std "
                           f"of {true}, or the std is not in (0, {max_std})")


def h2_phases(torch, tmp: str, l2_path: str, rng, card: str) -> None:
    """Phases 11-12: the ``h2`` command at full width on 18 copies of the
    .L2 at ``l2_path``, on the card against the CPU."""
    from nldsc_tpu_torch.h2.pipeline import (drop_large_chisq,
                                             merge_ld_sumstats)
    from nldsc_tpu_torch.h2.regression import hsq_estimate
    from nldsc_tpu_torch.io.ldscores import read_ld_scores
    from nldsc_tpu_torch.io.sumstats import read_sumstats
    from nldsc_tpu_torch.ld.pipeline import resolve_device

    # 11. cuda against cpu, two cuda runs bitwise equal
    t0 = time.time()
    h2in = write_h2_inputs(l2_path, os.path.join(tmp, "h2"), rng)
    say("11 data", f"{h2in['rows']} LD rows in {h2in['files']} files "
        f"(M={h2in['M']}, MD={h2in['MD']}; L2 mean {h2in['l2_mean']:.3f}, "
        f"sd {h2in['l2_sd']:.3f}), {h2in['n_ss']} shuffled sumstats rows, "
        f"written in {time.time() - t0:.1f} s")
    base = ["--sumstats", h2in["ss"], "--ref-ld", h2in["ld"], "--w-ld",
            h2in["ld"]]
    h2 = {tag: run_h2_cli(base + ["--device", dev],
                          os.path.join(tmp, f"h2_{tag}.json"))
          for tag, dev in (("cuda", "cuda"), ("cuda2", "cuda"),
                           ("cpu", "cpu"))}
    if (Path(tmp, "h2_cuda.json").read_bytes()
            != Path(tmp, "h2_cuda2.json").read_bytes()):
        raise RuntimeError("two CUDA h2 runs differ")
    worst11, share11 = compare_summaries(h2["cuda"][0], h2["cpu"][0])
    add = h2["cuda"][0]["additive"]
    check_recovery("additive", add["hsq"], add["hsq.std"])
    # the regression alone, on the merged and filtered rows
    t0 = time.time()
    ss_t = read_sumstats(h2in["ss"])
    t1 = time.time()
    ld_t, m_t, md_t = read_ld_scores(h2in["ld"])
    t2 = time.time()
    rows, chisq = drop_large_chisq(merge_ld_sumstats(ss_t, ld_t),
                                    max(ss_t["N"].max() * 1e-3, 80))
    host = (f"host: read sumstats {t1 - t0:.2f} s, read LD {t2 - t1:.2f} s, "
            f"join and filter {time.time() - t2:.2f} s")

    def regression(dev):
        dev = resolve_device(dev)
        col = {k: torch.as_tensor(np.asarray(v, np.float64).reshape(-1, 1),
                                  device=dev)
               for k, v in (("y", chisq), ("l2", rows["L2"]),
                            ("l2d", rows["L2D"]), ("n", rows["N"]))}
        m_add, m_dom = (torch.tensor([[v]], dtype=torch.float64, device=dev)
                        for v in (m_t, md_t))
        return hsq_estimate(col["y"], col["l2"], col["l2"], col["l2d"],
                            col["l2d"], col["n"], m_add, m_dom,
                            n_blocks=200, two_step=30)["summary"]

    spans = []
    for dev in ("cuda", "cpu", "cuda", "cpu"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        regression(dev)
        end.record()
        torch.cuda.synchronize()
        spans.append(f"{dev} {time.time() - t0:.3f} s wall" + (
            f" ({start.elapsed_time(end):.1f} ms between CUDA events)"
            if dev == "cuda" else ""))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        regression("cuda")
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    reg = "; ".join(spans) + (
        f"; profiled cuda run: {busy:.1f} ms of device time in "
        f"{sum(e.count for e in kernels)} kernel and copy launches")
    dom = h2["cuda"][0]["dominant"]
    say("11 h2", f"{h2in['rows']} LD rows: h2 command wall cuda "
        f"{h2['cuda'][1]:.2f} s, again {h2['cuda2'][1]:.2f} s (bitwise "
        f"equal), cpu {h2['cpu'][1]:.2f} s; regression alone "
        f"(hsq_estimate, {len(rows)} rows): {reg}; {host}; cuda vs cpu worst relative "
        f"difference {worst11:.3g}, worst share of the tolerance "
        f"{share11:.3g}; additive h2 {add['hsq']:.4f} +- "
        f"{add['hsq.std']:.4f} (true 0.3), intercept "
        f"{add['intercept']:.4f}; dominant h2 {dom['hsq']:.4g} +- "
        f"{dom['hsq.std']:.4g} (true 0.05); on {card}")

    # 12. --strategy one-stg and --partitioned on the card
    for name, args in (
            ("one-stg", base + ["--strategy", "one-stg"]),
            ("partitioned", ["--partitioned", "--sumstats", h2in["ss"],
                             "--ref-ld", h2in["part"], "--w-ld",
                             h2in["ld"]])):
        runs = {dev: run_h2_cli(args + ["--device", dev], os.path.join(
            tmp, f"h2_{name}_{dev}.json")) for dev in ("cuda", "cpu")}
        worst, share = compare_summaries(runs["cuda"][0], runs["cpu"][0])
        est = runs["cuda"][0]["additive" if name == "one-stg" else "total"]
        check_recovery(name, est["hsq"], est["hsq.std"])
        say("12 h2 " + name, f"cuda {runs['cuda'][1]:.2f} s, cpu "
            f"{runs['cpu'][1]:.2f} s wall; worst relative difference "
            f"{worst:.3g}, worst share of the tolerance {share:.3g} "
            f"(rtol 1e-8, atol 1e-12); h2 "
            f"{est['hsq']:.4f} +- {est['hsq.std']:.4f} (true 0.3); on {card}")


class LogLines(logging.Handler):
    """The port's log messages of one run, kept in memory."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record) -> None:
        self.lines.append(record.getMessage())

    def has(self, text: str) -> bool:
        return any(text in line for line in self.lines)


def run_ld(torch, argv: list) -> dict:
    """One ``ld`` run through the port's CLI: the kernel launches counted
    in it, its wall seconds, ``STAGE_TIMES``, its peak device memory above
    what was allocated before it (GiB), and its log lines."""
    from nldsc_tpu_torch.cli import main as cli_main
    from nldsc_tpu_torch.core.logging import log
    from nldsc_tpu_torch.core.timing import STAGE_TIMES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lines = LogLines()
    log.addHandler(lines)
    reset_counts()
    t0 = time.time()
    try:
        cli_main(["ld", *argv])
    finally:
        log.removeHandler(lines)
    torch.cuda.synchronize()
    return {"launches": launch_counts(), "wall": time.time() - t0,
            "stages": {k: round(v, 3) for k, v in sorted(STAGE_TIMES.items())},
            "peak": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "log": lines}


def read_l2(path: str) -> dict:
    """The columns of an .L2 file, as float64 arrays (SNP left out)."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    return {h: np.array([float(r[i]) if r[i] else np.nan for r in rows])
            for i, h in enumerate(header) if h != "SNP"}


def band_chunks(rowmiss: np.ndarray, chunk_rows: int, halo: int) -> int:
    """Chunks whose band (pivots and halo) holds a contaminated row."""
    n_chunks = -(-len(rowmiss) // chunk_rows)
    return sum(bool(rowmiss[c * chunk_rows:c * chunk_rows + chunk_rows
                            + halo].any()) for c in range(n_chunks))


def tile_bfile(prefix: str, out: str, copies: int, spacing: int) -> int:
    """``copies`` byte copies of a bfile's packed rows, one after another,
    positions continuing at ``spacing`` bp; returns the SNP count."""
    from nldsc_tpu_torch.io.plink import PLINK_MAGIC

    raw = Path(prefix + ".bed").read_bytes()[len(PLINK_MAGIC):]
    with open(out + ".bed", "wb") as f:
        f.write(PLINK_MAGIC)
        for _ in range(copies):
            f.write(raw)
    m = copies * sum(1 for _ in open(prefix + ".bim"))
    bp = np.arange(1, m + 1, dtype=np.int64) * spacing
    with open(out + ".bim", "w") as f:
        f.writelines(f"22\trs{i + 1}\t{c!r}\t{p}\tA\tG\n" for i, (c, p) in
                     enumerate(zip((bp * 1e-6).tolist(), bp.tolist())))
    Path(out + ".fam").write_bytes(Path(prefix + ".fam").read_bytes())
    return m


def streaming_phases(torch, tmp: str, prefix5: str, out5: str, prefix9: str,
                     out9: str, m5: int, card: str, chunk: int = 8192) -> dict:
    """Phases 13-16: the streaming route and ``ld-genome`` on phase 5's
    and phase 9's bfiles (M = ``m5``, 100 bp apart), ``chunk`` rows per
    chunk; returns the kernel launches of phases 13-14."""
    from nldsc_tpu_torch.cli import main as cli_main
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PlinkDataset, scan_rowmiss
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores
    from nldsc_tpu_torch.ld.streaming import compute_ld_scores_streaming

    halo = 1024                 # +-1000 SNPs, in 512-row units
    base = ["-kb", "100", "-maf", "0.01", "--extra"]
    stream = ["--streaming", "--chunk-rows", str(chunk)]
    cfg = LDConfig(ld_wind=100_000.0, maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=1.0 / m5)
    n_chunks = m5 // chunk
    found = {}
    runs = {}
    for phase, prefix, tag in (("13", prefix5, "clean"),
                               ("14", prefix9, "split")):
        out = os.path.join(tmp, f"stream_{tag}.L2")
        r = run_ld(torch, ["--bfile", prefix, *base, "-o", out, *stream])
        check_outputs(out, m5)
        c = r["launches"]
        ds = PlinkDataset.parse(prefix)
        rowmiss = scan_rowmiss(ds.bed)
        want_k2 = band_chunks(rowmiss, chunk, halo) if tag == "split" else 0
        if (c["ld_sym"] != n_chunks or c["ld_sym_8prod"]
                or c["split_corr"] != 2 * want_k2
                or c["split_fused"] != want_k2
                or not r["log"].has(f"LD route: streaming ({n_chunks} "
                                    f"chunks of {chunk} rows, halo {halo}")):
            raise RuntimeError(f"phase {phase}: launches {c}, expected K1 "
                               f"{n_chunks}, K2 {2 * want_k2}, no 8-product")
        found[phase] = c
        # the same scores through the API, against the in-core route
        packed, pos = ds.bed.read_raw(), ds.positions("bp")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.time()
        incore = compute_ld_scores(packed, pos, cfg, device="cuda")
        torch.cuda.synchronize()
        incore_s = time.time() - t0
        incore_peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        # the device's busy time in the streaming pass (profiler)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            streamed = compute_ld_scores_streaming(
                ds.bed, pos, cfg, chunk_rows=chunk, device="cuda")
            torch.cuda.synchronize()
            stream_s = time.time() - t0
        busy = device_busy_ms(torch, prof)
        err = compare_results(streamed, incore)
        runs[phase] = r
        say(f"{phase} stream {tag}", f"M={m5} -kb 100 --streaming "
            f"--chunk-rows {chunk}: {n_chunks} chunks (halo {halo}); "
            f"launches {c}; {r['wall']:.2f} s wall, {m5 / r['wall']:.0f} "
            f"SNPs/s; stages {r['stages']}; peak device memory "
            f"{r['peak']:.3f} GiB vs in core {incore_peak:.3f} GiB "
            f"({incore_s:.2f} s for compute_ld_scores); the streaming pass "
            f"alone (profiled): {stream_s:.3f} s, device busy {busy:.1f} ms "
            f"({100 * (1 - busy / 1e3 / stream_s):.1f}% idle; "
            f"{100 * (1 - busy / 1e3 / r['wall']):.1f}% of the command's "
            f"wall); vs in core: counters equal, max |l2,l2d| diff "
            f"{err:.3g}; on {card}")
        del packed, incore

    # 15. resume after a cut, from the rowmiss cache; a touched .bed
    ck = os.path.join(tmp, "ck")
    out15, out15r = (os.path.join(tmp, f"resume{s}.L2") for s in ("", "_r"))
    argv15 = ["--bfile", prefix9, *base, *stream, "--resume", ck]
    first = run_ld(torch, argv15 + ["-o", out15])
    if Path(out15).read_bytes() != Path(
            os.path.join(tmp, "stream_split.L2")).read_bytes():
        raise RuntimeError("phase 15: a checkpointed run differs from phase "
                           "14's")
    shards = sorted(Path(ck).glob("chunk_*.npz"))
    if len(shards) != n_chunks:
        raise RuntimeError(f"phase 15: {len(shards)} shards")
    for f in shards[3:]:
        f.unlink()
    cache_mtime = Path(ck, "rowmiss.npz").stat().st_mtime_ns
    resumed = run_ld(torch, argv15 + ["-o", out15r])
    if Path(out15r).read_bytes() != Path(out15).read_bytes():
        raise RuntimeError("phase 15: the resumed .L2 is not byte-identical")
    if not (resumed["log"].has("Resuming: 3 chunks already complete")
            and resumed["log"].has("rowmiss: read the cached bitmap")
            and not resumed["log"].has("rowmiss: scanned")
            and Path(ck, "rowmiss.npz").stat().st_mtime_ns == cache_mtime):
        raise RuntimeError("phase 15: the resume did not report 3 chunks "
                           "read from the checkpoint and the cached rowmiss")
    k1_resumed = resumed["launches"]["ld_sym"]
    st = os.stat(prefix9 + ".bed")
    os.utime(prefix9 + ".bed", ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        run_ld(torch, argv15 + ["-o", os.path.join(tmp, "touched.L2")])
        raise RuntimeError("phase 15: a touched .bed was resumed")
    except SystemExit as ex:
        if "bed_mtime_ns" not in str(ex.__cause__):
            raise RuntimeError(f"phase 15: wrong refusal {ex.__cause__}")
    say("15 resume", f"phase 14 with --resume: {n_chunks} shards, .L2 "
        f"byte-identical to phase 14's; shards 3-{n_chunks - 1} deleted, "
        f"resumed: {k1_resumed} K1 launches, .L2 byte-identical, log "
        f"'Resuming: 3 chunks already complete', rowmiss read from the "
        f"cache; {first['wall']:.2f} s wall first, {resumed['wall']:.2f} s "
        f"resumed; after a touch of the .bed the resume refuses "
        f"(bed_mtime_ns); on {card}")

    # 16. device memory independent of M: phase 5's rows tiled 4x
    tiled = os.path.join(tmp, "chr_tiled")
    t0 = time.time()
    m16 = tile_bfile(prefix5, tiled, 4, 100)
    write_s = time.time() - t0
    out16 = os.path.join(tmp, "tiled.L2")
    r16 = run_ld(torch, ["--bfile", tiled, *base, "-rsq", repr(1.0 / m5),
                         "-o", out16, *stream])
    for suffix in (".bed", ".bim", ".fam"):
        os.remove(tiled + suffix)
    check_outputs(out16, m16)
    peak13 = runs["13"]["peak"]
    if abs(r16["peak"] - peak13) > 0.1 * peak13:
        raise RuntimeError(f"phase 16: peak {r16['peak']:.3f} GiB at M={m16} "
                           f"vs {peak13:.3f} GiB at M={m5}")
    a, b = read_l2(out16), read_l2(os.path.join(tmp, "stream_clean.L2"))
    r = np.arange(m16) % m5
    k = np.arange(m16) // m5
    far = (((k == 0) | (r > 1000)) & ((k == 3) | (r < m5 - 1001)))
    err16 = compare([a["L2"][far], a["L2D"][far], a["WSA"][far],
                     a["WSD"][far], a["WSDE"][far]],
                    [b["L2"][r[far]], b["L2D"][r[far]], b["WSA"][r[far]],
                     b["WSD"][r[far]], b["WSDE"][r[far]]])
    say("16 memory", f"phase 5's rows tiled 4x (M={m16}, written in "
        f"{write_s:.1f} s), --streaming -rsq 1/{m5}: "
        f"{r16['launches']['ld_sym']} K1 launches, {r16['wall']:.2f} s "
        f"wall, {m16 / r16['wall']:.0f} SNPs/s; stages {r16['stages']}; "
        f"peak device memory {r16['peak']:.3f} GiB vs {peak13:.3f} GiB at "
        f"M={m5}; the {int(far.sum())} rows more than a window from a seam "
        f"against phase 13: counters equal, max |L2,L2D| diff {err16:.3g}; "
        f"on {card}")

    # 16. ld-genome, in core, on phases 5 and 9
    gdir = os.path.join(tmp, "genome")
    reset_counts()
    t0 = time.time()
    cli_main(["ld-genome", "--bfiles", f"{prefix5},{prefix9}", "--out-dir",
              gdir, *base, "--no-streaming"])
    wall_g = time.time() - t0
    for prefix, out in ((prefix5, out5), (prefix9, out9)):
        name = os.path.basename(prefix)
        for suffix in (".L2", ".M", ".M_5_50"):
            if (Path(gdir, name + suffix).read_bytes()
                    != Path(out).with_suffix(suffix).read_bytes()):
                raise RuntimeError(f"phase 16: ld-genome's {name}{suffix} "
                                   "differs from the ld run's")
    say("16 ld-genome", f"--bfiles <phase 5>,<phase 9> in core: "
        f"{wall_g:.2f} s wall, launches {launch_counts()}; .L2/.M/.M_5_50 "
        f"byte-identical to phases 5 and 9; on {card}")
    return found


ANNOT_TOL = dict(rtol=5e-5, atol=5e-4)    # tests/test_annot.py:181-191


def check_k2_annot(torch, sargs, n: int, annot, plain) -> float:
    """K2's annotation epilogue on ``split_args`` inputs: two runs bitwise
    equal, the three plain δ vectors bitwise equal to ``plain`` (a call
    without annotations), the two annotation δ accumulators within
    KERNEL_TOL of the twin's (on the CPU); their max abs error."""
    from nldsc_tpu_torch.ld import ld_split

    reset_counts()
    kern = ld_split.split_corrections(*sargs, annot, n_samples=n)
    c = launch_counts()
    again = ld_split.split_corrections(*sargs, annot, n_samples=n)
    torch.cuda.synchronize()
    if (c["split_corr"], c["split_fused"], c["split_annot"]) != (2, 1, 1):
        raise RuntimeError(f"split_corrections(annot=) launched {c}")
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise RuntimeError("two split_corrections(annot=) runs differ")
    if not all(torch.equal(a, b) for a, b in zip(kern[:3], plain)):
        raise RuntimeError("the plain δ of an annot call differ from a plain "
                           "call's")
    cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in sargs)
    twin = ld_split.split_corrections_plain(*cpu, annot.cpu(), n_samples=n)
    return hold_accumulators(kern[3:], twin[3:], "K2's annotation δ")


def annot_kernel_phase(torch, rng, dev) -> dict:
    """Phase 17; returns each annotation instantiation's max abs error
    against its twin."""
    from nldsc_tpu_torch import _build
    from nldsc_tpu_torch.ld import ld_pallas_sym, ld_split

    p = 5
    errs = {}
    pos = np.arange(1, 4097, dtype=np.float64) * 100
    pos[7] = -1.0                                     # skip sentinel
    for name, rate in (("ld_sym annot", 0.0), ("ld_sym annot 8-product",
                                               0.02)):
        g = synthetic_genotypes(rng, 4096, 3001, missing_rate=rate)
        adv = adversarial_rows(rng, 3001)
        g[100:105] = adv[:5]
        if rate:
            g[200] = adv[5]
            g[300] = -1
        args, n, has_missing, _ = engine_inputs(torch, g, pos, 100_000.0,
                                                dev)
        plain = ld_pallas_sym.sym_credits(
            *args, RSQ, n_samples=n, has_missing=has_missing,
            block_size=ld_pallas_sym.tile(has_missing))
        # p = 97 (baselineLD v2.2): four chunks, nearly all the row credits
        # a clean launch keeps
        for pp in (p, 97):
            annot = seeded_annot(torch, args[0].shape[0], 4096, pp, 2026,
                                 dev)
            err = check_k1_annot(torch, args, n, has_missing, annot, plain)
            errs[name if pp == p else f"{name} p97"] = err
            say("17 annot kernel=twin", f"M=4096 N=3001 p={pp} "
                f"missing={rate}: {name}: plain credits and counters "
                "bitwise equal to the plain launch, max |accumulator| diff "
                f"vs twin {err:.3g}, runs bitwise equal")
        del args, plain
    g = synthetic_genotypes(rng, 4096, 3001)
    inject_row_missing(rng, g, 0.05, 0.1)
    g[100:106] = adversarial_rows(rng, 3001)
    g[300] = -1
    args, n, _, raw = engine_inputs(torch, g, pos, 100_000.0, dev,
                                    materialize_m=False)
    sargs = split_args(args, raw, n)
    annot = seeded_annot(torch, args[0].shape[0], 4096, p, 2026, dev)
    plain = ld_split.split_corrections(*sargs, n_samples=n)
    errs["split_corr annot"] = check_k2_annot(torch, sargs, n, annot, plain)
    aux = aux_timing(torch, sargs, p, dev, reps=1)
    errs["split_tile_reach"] = aux["reach"]["max_abs_err"]
    errs["split_annot_fold"] = aux["fold"]["max_abs_err"]
    say("17 annot K2=twin", f"M=4096 N=3001 p={p}, "
        f"{sargs[-1]['n_miss']} contaminated rows: split_corrections(annot=) "
        "(1 products + 1 fused launch with the annotation epilogue): plain δ "
        "bitwise equal to the plain call, max |annotation δ| diff vs twin "
        f"{errs['split_corr annot']:.3g}, runs bitwise equal; its reach "
        "and fold kernels bitwise equal to their plain versions")
    # ld_sym.cu: K1's eight instantiations in clusters and out of them;
    # split_corr.cu: K2's eight instantiations, its reach and fold kernels
    for name, want in (("ld_sym", 16), ("split_corr", 10)):
        log = _build.BUILD_INFO[name]["log"]
        entries = re.findall(r"Compiling entry function '(\w+)'", log)
        regs = re.findall(r"Used (\d+) registers", log)
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
        say("17 ptxas", f"{name}.cu: {len(entries)} instantiations "
            + ", ".join(
                "<" + ", ".join(re.findall(r"Lb([01])E", e)) + f">: {r} "
                "registers" for e, r in zip(entries, regs))
            + f"; spill bytes {sorted(set(spills))}")
        if len(entries) != want or any(spills) or not spills:
            raise RuntimeError(f"{name}.cu: expected {want} instantiations "
                               f"without spills, got {entries}, {spills}")
    return errs


def annot_golden_phase(torch, tmp: str) -> None:
    """Phase 18: the golden annot fixture on the card, three ways."""
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores
    from nldsc_tpu_torch.ld.streaming import compute_ld_scores_streaming

    gold = dict(np.load(ROOT / "tests" / "data" / "golden_annot_toy.npz"))
    cfg = LDConfig(ld_wind=12000.0, wind_metric="bp", maf_thr=0.01,
                   std_thr=1e-4, rsq_thr=RSQ, block_size=64)
    g, pos, annot = gold["genotypes"], gold["positions"], gold["annot"]
    prefix = write_plink(os.path.join(tmp, "gold_annot"), g,
                         bp=pos.astype(np.int64))
    reset_counts()
    runs = {
        "K1": compute_ld_scores(g, pos, cfg, annot=annot, device="cuda"),
        "full-band": compute_ld_scores(
            g, pos, dataclasses.replace(cfg, symmetric=False), annot=annot,
            device="cuda"),
        "streamed": compute_ld_scores_streaming(
            PlinkDataset.parse(prefix).bed, pos, cfg, chunk_rows=64,
            annot=annot, device="cuda")}
    c = launch_counts()
    if c["ld_sym_annot"] < 2 or c["ld_sym_annot"] != c["ld_sym"]:
        raise RuntimeError(f"phase 18: launches {c}")
    errs = {}
    for name, res in runs.items():
        for k in ("l2_annot", "l2d_annot"):
            np.testing.assert_allclose(res[k], gold[k], rtol=2e-5, atol=2e-4,
                                       equal_nan=True, err_msg=f"{name} {k}")
        errs[name] = max(float(np.nanmax(np.abs(res[k] - gold[k])))
                         for k in ("l2_annot", "l2d_annot"))
    say("18 golden annot", f"golden_annot_toy (M={g.shape[0]}, "
        f"p={annot.shape[1]}) matches at rtol 2e-5, atol 2e-4: max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; launches {c}")


def write_annot_file(path: str, snps, annot: np.ndarray, names) -> None:
    with open(path, "w") as f:
        f.write("\t".join(["SNP", *names]) + "\n")
        f.writelines("\t".join([s, *map(repr, row)]) + "\n"
                     for s, row in zip(snps, annot.tolist()))


def compare_tables(a: dict, b: dict, cols, tol: dict, what: str) -> float:
    """Columns ``cols`` of two .L2 tables within ``tol``, NaN in the same
    rows; the max abs difference."""
    err = 0.0
    for ca, cb in cols:
        x, y = a[ca], b[cb]
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y),
                                      err_msg=f"{what}: NaN rows of {ca}")
        np.testing.assert_allclose(x, y, equal_nan=True,
                                   err_msg=f"{what}: {ca}", **tol)
        err = max(err, float(np.nanmax(np.abs(x - y))))
    return err


def annot_full_width(torch, tmp: str, prefix5: str, out5: str, prefix6: str,
                     prefix9: str, m5: int, rng, dev, card: str,
                     p: int = 53) -> dict:
    """Phase 19; returns the launches of the annotation instantiations on
    the main path (in core and streamed), their timing entries and their
    max abs errors against the plain versions at that shape."""
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split, windows

    names = ["base"] + [f"a{i}" for i in range(1, p)]
    ds5 = PlinkDataset.parse(prefix5)
    snps = ds5.bim["SNP"].tolist()
    annot = np.round(annot_values(rng, m5, p), 4)
    apath = os.path.join(tmp, "chr.annot")
    t0 = time.time()
    write_annot_file(apath, snps, annot, names)
    say("19 data", f"{m5} x {p} annotation file "
        f"({os.path.getsize(apath) / 1e6:.0f} MB) written in "
        f"{time.time() - t0:.1f} s")
    base = ["-kb", "100", "-maf", "0.01", "--annot", apath]
    stream = ["--streaming", "--chunk-rows", "8192"]
    n_chunks = m5 // 8192
    rows = {pre: sum(1 for _ in open(pre + ".bim"))
            for pre in (prefix5, prefix6, prefix9)}
    n6 = rows[prefix6] // 8192
    # (tag, bfile, flags, expected K1, 8-product, K1 annot, K2, K2 annot);
    # the 2%-missing bfile's SNPs are the first of the annotation file's,
    # and every band of it goes global
    # in core at M >= 20,000 progress is on: 16 segments of K1
    seg = ld_pallas_sym.MAX_SEGMENTS
    plan = (("clean", prefix5, [], seg, 0, seg, 0, 0),
            ("clean streamed", prefix5, stream, n_chunks, 0, n_chunks, 0, 0),
            ("split", prefix9, [], seg, 0, seg, 2, 1),
            ("global", prefix9, ["--no-split-missing"], seg, seg, seg, 0, 0),
            ("split streamed", prefix9, stream, n_chunks, 0, n_chunks,
             2 * n_chunks, n_chunks),
            ("dense missing", prefix6, [], 1, 1, 1, 0, 0),
            ("dense missing streamed", prefix6, stream, n6, n6, n6, 0, 0))
    runs, tabs = {}, {}
    for tag, prefix, flags, k1, k1m, k1a, k2, k2a in plan:
        out = os.path.join(tmp, "annot_" + tag.replace(" ", "_") + ".L2")
        r = run_ld(torch, ["--bfile", prefix, *base, *flags, "-o", out])
        c = r["launches"]
        got = (c["ld_sym"], c["ld_sym_8prod"], c["ld_sym_annot"],
               c["split_corr"], c["split_annot"])
        if got != (k1, k1m, k1a, k2, k2a) or (
                c["split_reach"], c["split_fold"]) != (k2a, k2a):
            raise RuntimeError(f"phase 19 {tag}: launches {c}, expected K1 "
                               f"{k1} ({k1m} 8-product, {k1a} annot), K2 "
                               f"{k2} ({k2a} annot, each with one reach and "
                               "one fold launch)")
        tabs[tag] = read_l2(out)
        header = list(tabs[tag])
        want = (["CHR", "BP"] + [f"{x}.L2" for x in names]
                + [f"{x}.L2D" for x in names])
        if header != want or len(tabs[tag]["BP"]) != rows[prefix]:
            raise RuntimeError(f"phase 19 {tag}: .L2 columns {header[:6]}...")
        for suffix in (".M", ".M_5_50"):
            lines = Path(out).with_suffix(suffix).read_text().splitlines()
            if (lines[0].split("\t") != [f"{x}.L2" for x in names]
                    or len(lines[1].split("\t")) != p):
                raise RuntimeError(f"phase 19 {tag}: {suffix} is not {p} "
                                   "named counts")
        runs[tag] = r
        say(f"19 ld --annot {tag}", f"M={rows[prefix]} p={p} "
            f"{' '.join(flags)}: launches {c}; {r['wall']:.2f} s wall, "
            f"{rows[prefix] / r['wall']:.0f} "
            f"SNPs/s; stages {r['stages']}; peak device memory "
            f"{r['peak']:.3f} GiB; on {card}")
    all_cols = [(c, c) for c in list(tabs["clean"])[2:]]
    plain5 = read_l2(out5)
    errs = {
        "base = phase 5": compare_tables(
            tabs["clean"], plain5, [("base.L2", "L2"), ("base.L2D", "L2D")],
            KERNEL_TOL, "base against phase 5"),
        "streamed = in core": compare_tables(
            tabs["clean streamed"], tabs["clean"], all_cols, KERNEL_TOL,
            "streamed against in core"),
        "split = global": compare_tables(
            tabs["split"], tabs["global"], all_cols, ANNOT_TOL,
            "split against global"),
        "split streamed = split": compare_tables(
            tabs["split streamed"], tabs["split"], all_cols, ANNOT_TOL,
            "split streamed against in core"),
        "dense missing streamed = in core": compare_tables(
            tabs["dense missing streamed"], tabs["dense missing"], all_cols,
            ANNOT_TOL, "dense missing streamed against in core")}
    say("19 checks", "; ".join(f"{k}: max abs diff {v:.3g}"
                               for k, v in errs.items())
        + f"; .M/.M_5_50 hold {p} columns named <name>.L2")

    # h2 --partitioned on the partitioned scores, phase 5's plain scores
    # as the regression weights
    l2 = plain5["L2"]
    m_5_50 = float(Path(out5).with_suffix(".M_5_50").read_text().split()[2])
    z = rng.standard_normal(m5) * np.sqrt(1.0 + 100_000.0 * 0.3 * l2 / m_5_50)
    ss = os.path.join(tmp, "annot.sumstats")
    with open(ss, "w") as f:
        f.write("SNP\tZ\tN\n")
        f.writelines(f"{s}\t{v!r}\t100000.0\n"
                     for s, v in zip(snps, z.tolist()))
    summary, wall_h2 = run_h2_cli(
        ["--partitioned", "--sumstats", ss, "--ref-ld",
         os.path.join(tmp, "annot_clean.L2"), "--w-ld", out5],
        os.path.join(tmp, "annot_h2.json"))
    if list(summary["annotations"]) != [f"{x}.L2" for x in names]:
        raise RuntimeError("phase 19: h2 --partitioned did not report the "
                           f"{p} annotations")
    say("19 h2 --partitioned", f"{p} annotations reported in {wall_h2:.2f} s "
        f"(total h2 {summary['total']['hsq']:.4f} +- "
        f"{summary['total']['hsq.std']:.4f}); on {card}")

    # the annotation instantiations beside the plain launches, in turns
    pos5 = ds5.positions("bp")
    out = {"launches": {
        "ld_sym annot": runs["clean"]["launches"]["ld_sym_annot"],
        "ld_sym annot 8-product": runs["global"]["launches"]["ld_sym_annot"],
        "split_corr annot": runs["split"]["launches"]["split_annot"],
        "split_tile_reach": runs["split"]["launches"]["split_reach"],
        "split_annot_fold": runs["split"]["launches"]["split_fold"]},
        "launches_streamed": {
        "ld_sym annot": runs["clean streamed"]["launches"]["ld_sym_annot"],
        "ld_sym annot 8-product":
            runs["dense missing streamed"]["launches"]["ld_sym_annot"],
        "split_corr annot": runs["split streamed"]["launches"]["split_annot"],
        "split_tile_reach":
            runs["split streamed"]["launches"]["split_reach"],
        "split_annot_fold":
            runs["split streamed"]["launches"]["split_fold"]}}
    args, n, _, _ = packed_inputs(torch, ds5.bed.read_raw().raw, ds5.n_samples,
                                  False, pos5, 100_000.0, dev)
    m_pad, n_pad = args[0].shape
    a_dev = torch.zeros((m_pad, p), dtype=torch.float32, device=dev)
    a_dev[:m5] = torch.from_numpy(annot.astype(np.float32)).to(dev)
    m0 = torch.zeros_like(args[0])     # as phase 7: every pair the clean one
    Tc, Tm = ld_pallas_sym.TILE_CLEAN, ld_pallas_sym.TILE_MISSING

    def k1(has_missing, a=None):
        return ld_pallas_sym.sym_credits(
            args[0], m0 if has_missing else args[1], *args[2:], RSQ,
            n_samples=n, has_missing=has_missing,
            block_size=Tm if has_missing else Tc, annot=a)

    def twin(has_missing, a, B=512):
        return ld_int8.sym_scan_segment(
            args[0], m0 if has_missing else args[1], *args[2:], RSQ, 0,
            a, block_size=B, right_k=ld_int8.band_extent(args[5], B)[1],
            n_samples=n, n_scan_blocks=m_pad // B, has_missing=has_missing)

    # p = 53 (the baseline model) and 97 (baselineLD v2.2), kernel timings
    # only for 97
    a97 = seeded_annot(torch, m_pad, m5, 97, 2026, dev)
    for name, has_missing in (("ld_sym annot", False),
                              ("ld_sym annot 8-product", True)):
        T = Tm if has_missing else Tc
        work = k1_work(args[5], n_pad, has_missing, T)
        values = masked_values(torch, args[0], m0 if has_missing else args[1],
                               args[2:], n, has_missing)
        for pp, a in ((p, a_dev), (97, a97)):
            work_a = k1_annot_work(work, m_pad, pp)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            ms_plain = cuda_ms(torch, lambda: k1(has_missing), 5)
            ms = cuda_ms(torch, lambda: k1(has_missing, a), 5)
            peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
            ms2 = cuda_ms(torch, lambda: k1(has_missing, a), 5)
            ms_plain2 = cuda_ms(torch, lambda: k1(has_missing), 5)
            kern, plain = k1(has_missing, a), k1(has_missing)
            if not all(torch.equal(x, y) for x, y in zip(kern[:6], plain)):
                raise RuntimeError(f"phase 19 {name} p={pp}: an annot "
                                   "launch's plain credits differ from the "
                                   "plain launch's")
            err = hold_accumulators(kern[6:], twin(has_missing, a)[6:],
                                    f"phase 19 {name} p={pp} against its "
                                    "twin")
            del kern, plain
            epi = min(ms, ms2) - min(ms_plain, ms_plain2)
            lib = epilogue_bmm_ms(torch, values, a)
            entry = {"ms": min(ms, ms2), "epilogue_ms": epi,
                     "library_ms": lib["ms"], "max_abs_err": err,
                     "peak_gib": peak, **work_a}
            if pp == p:
                entry["plain_ms"] = cuda_ms(torch,
                                            lambda: twin(has_missing, a), 1)
                out[name] = entry
            else:
                out[name]["p97"] = entry
            say("19 timing", f"M={m5} N={n} +-1000 SNPs p={pp}, {name}: "
                f"{ms:.3f} / {ms2:.3f} ms against {ms_plain:.3f} / "
                f"{ms_plain2:.3f} ms without annotations (plain, annot, "
                f"annot, plain): the epilogue's own cost {epi:.3f} ms; "
                f"bound {work_a['bound_ms']:.3f} ms ({work_a['bound_by']}: "
                f"{work['ops'] / 1e12:.3f} T int8 ops + "
                f"{work_a['annot_f32_ops'] / 1e9:.1f} G f32 ops as "
                f"{work_a['annot_rate']}, "
                f"{work_a['bytes'] / 1e9:.2f} GB), "
                f"{100 * work_a['bound_ms'] / min(ms, ms2):.1f}% of it; "
                "plain credits and counters bitwise equal to the plain "
                f"launch's, max |accumulator| diff vs twin {err:.3g} "
                "(KERNEL_TOL); "
                + (f"twin with annotations {entry['plain_ms']:.1f} ms "
                   "(B=512); " if pp == p else "")
                + f"library yardstick (float32 torch.bmm, TF32 off, "
                f"{lib['shape']}, both directions) {lib['ms']:.3f} ms "
                f"({lib['rows_ms']:.3f} + {lib['cols_ms']:.3f}); peak device "
                f"memory of a launch and its fold {peak:.3f} GiB; on {card}")
        del values
        torch.cuda.empty_cache()
    del a97
    # the full-band torch engine (--no-symmetric) at that shape
    lo, hi, _ = windows.window_bounds(pos5, 100_000.0)
    blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, 512, m_pad // 512)

    def full_band(a=None):
        return ld_int8.ld_scores_int8(
            *args, blk_lo, blk_hi, RSQ, a, block_size=512, band_k=band_k,
            n_samples=n, has_missing=False)

    ms_fb, ms_fb_a = (cuda_ms(torch, lambda a=a: full_band(a), 2)
                      for a in (None, a_dev))
    say("19 timing", f"full-band torch engine (torch._int_mm products, "
        f"block 512, band {band_k} blocks) at that shape: {ms_fb:.1f} ms "
        f"plain, {ms_fb_a:.1f} ms with {p} annotations; on {card}")
    del args, m0, a_dev
    torch.cuda.empty_cache()

    ds9 = PlinkDataset.parse(prefix9)
    args, n, _, raw = packed_inputs(torch, ds9.bed.read_raw().raw,
                                    ds9.n_samples, True, pos5, 100_000.0,
                                    dev, materialize_m=False)
    sargs = split_args(args, raw, n)
    a_dev = torch.zeros((m_pad, p), dtype=torch.float32, device=dev)
    a_dev[:m5] = torch.from_numpy(annot.astype(np.float32)).to(dev)

    def k2(a=None):
        return ld_split.split_corrections(*sargs, a, n_samples=n)

    work2 = k2_work(sargs)
    work2_a = annot_bound(work2, work2["pairs"], m_pad, p, work2["int8_ops"],
                          work2["f32_ops"], tensor_cores=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    ms_plain = cuda_ms(torch, k2, 10)
    ms = cuda_ms(torch, lambda: k2(a_dev), 10)
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    ms2 = cuda_ms(torch, lambda: k2(a_dev), 10)
    ms_plain2 = cuda_ms(torch, k2, 10)

    def twin2():
        return ld_split.split_corrections_plain(*sargs, a_dev, n_samples=n)

    kern, plain = k2(a_dev), k2()
    if not all(torch.equal(a, b) for a, b in zip(kern[:3], plain)):
        raise RuntimeError("phase 19: the plain δ of an annot call differ "
                           "from a plain call's")
    err = hold_accumulators(kern[3:], twin2()[3:],
                            "phase 19 split_corr annot against its twin")
    del kern, plain
    n_live, part_gb = ld_split.annot_tiles, ld_split.annot_partial_bytes / 1e9
    plain_ms = cuda_ms(torch, twin2, 1)
    dev_a, dev_p = (k2_device_split(torch, f) for f in (lambda: k2(a_dev),
                                                         k2))
    lib = k2_epilogue_bmm_ms(torch, n_live, p, dev)
    epi = min(ms, ms2) - min(ms_plain, ms_plain2)
    aux = aux_timing(torch, sargs, p, dev)
    fold, reach = aux["fold"], aux["reach"]
    out["split_annot_fold"], out["split_tile_reach"] = fold, reach
    say("19 aux kernels", f"K2's reach kernel over {reach['tiles']} tiles "
        f"({reach['live_tiles']} live): equal to its plain version; "
        f"{reach['ms']:.4f} ms against plain {reach['plain_ms']:.3f} ms; "
        f"bound {reach['bound_ms']:.4f} ms ({reach['bound_by']}), "
        f"{100 * reach['bound_ms'] / reach['ms']:.1f}% of it. Its fold "
        f"kernel on the live tiles' partials (seeded, p={p}): bitwise equal "
        f"to its plain version; {fold['ms']:.3f} ms against plain "
        f"{fold['plain_ms']:.3f} ms; bound {fold['bound_ms']:.3f} ms "
        f"({fold['bound_by']}: {fold['bytes'] / 1e9:.3f} GB), "
        f"{100 * fold['bound_ms'] / fold['ms']:.1f}% of it; library "
        f"yardstick (index_add_ of the row and column partials) "
        f"{fold['library_ms']:.3f} ms; on {card}")
    out["split_corr annot"] = {"ms": min(ms, ms2), "plain_ms": plain_ms,
                               "max_abs_err": err, "epilogue_ms": epi,
                               "library_ms": lib["ms"], "peak_gib": peak,
                               "live_tiles": n_live, "device": dev_a,
                               "device_plain": dev_p, **work2_a}
    say("19 timing", f"split_corrections(annot=) p={p}, "
        f"{sargs[-1]['n_miss']} contaminated rows: {ms:.3f} / {ms2:.3f} ms "
        f"against {ms_plain:.3f} / {ms_plain2:.3f} ms without annotations "
        f"(plain, annot, annot, plain): the epilogue's own cost {epi:.3f} "
        f"ms; device time per call (profiler): K2 fused "
        f"{dev_a['fused']:.3f} + d {dev_a['products']:.3f} ms, "
        f"{dev_a['n_other']} other ops {dev_a['other']:.3f} ms (plain call: "
        f"{dev_p['fused']:.3f} + {dev_p['products']:.3f} ms, "
        f"{dev_p['n_other']} other ops {dev_p['other']:.3f} ms); bound "
        f"{work2_a['bound_ms']:.3f} ms ({work2_a['bound_by']}: "
        f"{work2['pairs']} counted pairs, "
        f"{work2_a['annot_f32_ops'] / 1e9:.2f} G f32 ops more as "
        f"{work2_a['annot_rate']}, {work2_a['bytes'] / 1e9:.2f} GB), "
        f"{100 * work2_a['bound_ms'] / min(ms, ms2):.1f}% of it; plain δ "
        "bitwise equal to the plain call's, max |annotation δ| diff vs twin "
        f"{err:.3g} (KERNEL_TOL); twin with "
        f"annotations {plain_ms:.1f} ms; library yardstick (float32 "
        f"torch.bmm, TF32 off, {lib['shape']}) {lib['ms']:.3f} ms "
        f"({lib['rows_ms']:.3f} + {lib['cols_ms']:.3f}); {n_live} live "
        f"tiles, {part_gb:.3f} GB of annotation partials; peak device "
        f"memory of a call {peak:.3f} GiB; on {card}")
    out["path"] = apath
    return out


def bits_equal(torch, a, b) -> bool:
    """Two tensors of one dtype and shape with the same bits (float NaNs
    included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def all_bits_equal(torch, xs, ys) -> bool:
    return len(xs) == len(ys) and all(bits_equal(torch, a, b)
                                      for a, b in zip(xs, ys))


def as_bf16(args):
    """Engine inputs (or ``split_args``) with the code matrices g, m, h
    (and m_c) as bf16 operands: one ``.to`` each, aliases kept."""
    from nldsc_tpu_torch.ld import ld_int8

    ops = {"g": args[0], "m": args[1], "h": args[2]}
    ld_int8.to_operands(ops, "bf16")
    return (ops["g"], ops["m"], ops["h"], *args[3:])


def check_k1_bf16(torch, args, n: int, has_missing: bool, annot=None):
    """K1's bf16 instantiation on engine inputs ``args`` against the int8
    one: every output (credits, counters and, with ``annot``, the
    annotation accumulators) bitwise equal, two bf16 runs bitwise equal,
    each counted as a bf16 launch.  Returns the bf16 inputs and the two
    callables (int8, bf16) for timing."""
    from nldsc_tpu_torch.ld import ld_pallas_sym

    T = ld_pallas_sym.tile(has_missing)
    bargs = as_bf16(args)

    def run(a):
        return ld_pallas_sym.sym_credits(
            *a, RSQ, n_samples=n, has_missing=has_missing, block_size=T,
            annot=annot)

    before = ld_pallas_sym.bf16_launches
    ref, kern, again = run(args), run(bargs), run(bargs)
    torch.cuda.synchronize()
    if ld_pallas_sym.bf16_launches != before + 2:
        raise RuntimeError("the bf16 instantiation was not launched")
    if not all_bits_equal(torch, kern, again):
        raise RuntimeError("two bf16 K1 runs differ")
    if not all_bits_equal(torch, kern, ref):
        raise RuntimeError(f"K1 bf16 (missing={has_missing}, annot="
                           f"{annot is not None}) differs from int8")
    return bargs, (lambda: run(args)), (lambda: run(bargs))


def check_k2_bf16(torch, sargs, n: int, annot=None):
    """K2's bf16 instantiations on ``split_args`` against the int8 ones:
    the products mode (a, b, d of every segment) and ``split_corrections``
    (fused mode, with ``annot`` its annotation epilogue) bitwise equal;
    returns the bf16 arguments and the two ``split_corrections``
    callables (int8, bf16)."""
    from nldsc_tpu_torch.ld import ld_split

    bsargs = as_bf16(sargs)
    plan = sargs[-1]
    before = ld_split.bf16_launches
    prod = ld_split.segment_products(*sargs[:3], plan)
    prod_b = ld_split.segment_products(*bsargs[:3], plan)
    if not all_bits_equal(torch, prod, prod_b):
        raise RuntimeError("K2's bf16 products mode differs from int8")
    del prod, prod_b

    def run(a):
        return ld_split.split_corrections(*a, annot, n_samples=n)

    ref, kern, again = run(sargs), run(bsargs), run(bsargs)
    torch.cuda.synchronize()
    if ld_split.bf16_launches != before + 2 + 4:
        raise RuntimeError("K2's bf16 instantiations were not launched")
    if not all_bits_equal(torch, kern, again):
        raise RuntimeError("two bf16 split_corrections runs differ")
    if not all_bits_equal(torch, kern, ref):
        raise RuntimeError(f"split_corrections bf16 (annot="
                           f"{annot is not None}) differs from int8")
    return bsargs, (lambda: run(sargs)), (lambda: run(bsargs))


def bf16_exactness_probe(torch, dev) -> str:
    """bf16 sums at the largest sample count they are exact for, N_pad =
    4,194,304: K2's products mode on 128 random rows whose first two are
    all 2 (Sgg = 2^24) and K1's clean branch on them with two rows all 2
    but one sample (usable at MAF 0; their Sgg = 2^24 - 3), each bitwise
    equal to its int8 instantiation, and the all-2 products exactly
    2^24."""
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split

    n = ld_int8.BF16_MAX_SAMPLES
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    x = torch.randint(0, 3, (128, n), generator=gen, dtype=torch.int8,
                      device=dev)
    x[:2] = 2
    x[2:4] = 2
    x[2:4, 0] = 1
    cat = x[:96]
    a8, b8 = ld_split.corr_products(x, cat, 64)
    ab, bb = ld_split.corr_products(x.to(torch.bfloat16),
                                    cat.to(torch.bfloat16), 64)
    torch.cuda.synchronize()
    if not (bits_equal(torch, a8, ab) and bits_equal(torch, b8, bb)):
        raise RuntimeError("bf16 products at N_pad = 2^22 differ from int8")
    if int(ab[0, 1]) != 1 << 24 or int(ab[1, 0]) != 1 << 24:
        raise RuntimeError(f"Sgg of two all-2 rows is {int(ab[0, 1])}, not "
                           "2^24")
    top = int(a8.max())
    del a8, b8, ab, bb
    ok = torch.ones(128, dtype=torch.bool, device=dev)
    pre = ld_int8.preprocess_int8(x, ok, 0.0, n, assume_no_missing=True)
    del x
    rows = torch.arange(128, dtype=torch.int32, device=dev)
    args = (pre["g"], pre["m"], pre["h"], ld_int8.stack_scalars(pre),
            torch.zeros_like(rows), torch.full_like(rows, 127),
            pre["usable"], pre["usable"] & (pre["rstd"] > 0),
            pre["add_sd_zero"])
    del pre
    check_k1_bf16(torch, args, n, False)
    return (f"N_pad = {n}: K2 products of 128 x 96 rows bitwise equal to "
            f"int8, Sgg of the all-2 rows exactly 2^24 (largest sum {top}); "
            "K1 clean on the 128 rows (two all 2 but one sample) bitwise "
            "equal to int8")


def ptxas_instantiations(name: str, want: int) -> str:
    """The ptxas report of ``csrc/<name>.cu``: ``want`` entry functions,
    each with its registers, and 0 spill bytes in every one (raises
    otherwise)."""
    from nldsc_tpu_torch import _build

    log = _build.BUILD_INFO[name]["log"]
    entries = re.findall(r"Compiling entry function '(\w+)'", log)
    regs = re.findall(r"Used (\d+) registers", log)
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
    if len(entries) != want or any(spills) or not spills:
        raise RuntimeError(f"{name}.cu: expected {want} instantiations "
                           f"without spills, got {entries}, {spills}")
    return (f"{name}.cu: {len(entries)} instantiations "
            + ", ".join("<" + ", ".join(re.findall(r"Lb([01])E", e)) + f">: "
                        f"{r} registers" for e, r in zip(entries, regs))
            + f"; spill bytes {sorted(set(spills))}")


def library_bf16_ms(torch, pairs, reps: int) -> tuple[float, str]:
    """One PyTorch call per (x, y) pair computing x · yᵀ on bf16 operands
    with float32 sums, timed: a yardstick the port never calls."""
    def run():
        return [torch.mm(x, y.t(), out_dtype=torch.float32)
                for x, y in pairs]

    return cuda_ms(torch, run, reps), "torch.mm(bf16, bf16, out_dtype=float32)"


def bf16_kernel_phase(torch, prefix5: str, prefix9: str, m5: int, rng, dev,
                      card: str, p: int = 53) -> dict:
    """Phase 20: every bf16 instantiation at phase 5's shape against its
    int8 one (bitwise) and its twin, its time beside the int8 one's (in
    turns: int8, bf16, bf16, int8), its bound; the exactness probe; the
    ptxas report.  Returns the kernels line's entries."""
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split

    out = {}
    say("20 probe", bf16_exactness_probe(torch, dev))
    for name, want in (("ld_sym", 16), ("split_corr", 10)):
        say("20 ptxas", ptxas_instantiations(name, want))
    ds5, ds9 = PlinkDataset.parse(prefix5), PlinkDataset.parse(prefix9)
    pos5 = ds5.positions("bp")
    annot = np.round(annot_values(np.random.default_rng(2027), m5, p), 4)
    # K1: the clean branch on phase 5's rows, the 8-product branch on
    # phase 9's (real missing genotypes, the global route's m)
    for branch, ds, has_missing in (("ld_sym bf16", ds5, False),
                                    ("ld_sym bf16 8-product", ds9, True)):
        args, n, _, _ = packed_inputs(torch, ds.bed.read_raw().raw,
                                      ds.n_samples, has_missing, pos5,
                                      100_000.0, dev)
        m_pad, n_pad = args[0].shape
        a_dev = torch.zeros((m_pad, p), dtype=torch.float32, device=dev)
        a_dev[:m5] = torch.from_numpy(annot.astype(np.float32)).to(dev)
        T = ld_pallas_sym.tile(has_missing)
        work8 = k1_work(args[5], n_pad, has_missing, T)
        for a in (None, a_dev):
            name = branch if a is None else branch.replace("bf16",
                                                           "bf16 annot")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            bargs, k_int8, k_bf16 = check_k1_bf16(torch, args, n,
                                                  has_missing, a)
            peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
            ms8, ms, ms_b, ms8_b = (cuda_ms(torch, f, 5) for f in (
                k_int8, k_bf16, k_bf16, k_int8))
            work = k1_work(args[5], n_pad, has_missing, T, "bf16")
            if a is not None:
                work = {**work, **k1_annot_work(work, m_pad, p, "bf16")}
            kern = k_bf16()
            t0 = time.time()
            twin = ld_int8.sym_scan_segment(
                *bargs, RSQ, 0, a, block_size=512,
                right_k=ld_int8.band_extent(args[5], 512)[1], n_samples=n,
                n_scan_blocks=m_pad // 512, has_missing=has_missing,
                dot_dtype="bf16")
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.time() - t0)
            err = compare(finalized(kern[:6], args), finalized(twin[:6],
                                                                args))
            if a is not None:
                err = max(err, hold_accumulators(kern[6:], twin[6:],
                                                 f"{name} against its twin"))
            del kern, twin, bargs
            out[name] = {"ms": min(ms, ms_b), "plain_ms": plain_ms,
                         "max_abs_err": err, "library_ms": None,
                         "int8_ms": min(ms8, ms8_b), "peak": peak, **work}
            say("20 K1 bf16", f"M={m5} N={n} +-1000 SNPs, {name}: every "
                f"output bitwise equal to the int8 launch's, max |diff| vs "
                f"its twin {err:.3g}; {ms:.3f} / {ms_b:.3f} ms against int8 "
                f"{ms8:.3f} / {ms8_b:.3f} ms (int8, bf16, bf16, int8); bf16 "
                f"bound {work['bound_ms']:.3f} ms ({work['bound_by']}; int8 "
                f"bound {work8['bound_ms']:.3f} ms), "
                f"{100 * work['bound_ms'] / min(ms, ms_b):.1f}% of it; twin "
                f"(B=512, bf16) {plain_ms:.1f} ms; peak device memory of the "
                f"check {peak:.3f} GiB (int8 and bf16 operands held "
                f"together); on {card}")
        del args, a_dev
        torch.cuda.empty_cache()
    # K2: the split route's inputs of phase 9
    args, n, _, raw = packed_inputs(torch, ds9.bed.read_raw().raw,
                                    ds9.n_samples, True, pos5, 100_000.0,
                                    dev, materialize_m=False)
    sargs = split_args(args, raw, n)
    del raw
    m_pad = args[0].shape[0]
    a_dev = torch.zeros((m_pad, p), dtype=torch.float32, device=dev)
    a_dev[:m5] = torch.from_numpy(annot.astype(np.float32)).to(dev)
    plan = sargs[-1]
    for a in (None, a_dev):
        name = "split_corr bf16" + ("" if a is None else " annot")
        bsargs, k_int8, k_bf16 = check_k2_bf16(torch, sargs, n, a)
        ms8, ms, ms_b, ms8_b = (cuda_ms(torch, f, 10) for f in (
            k_int8, k_bf16, k_bf16, k_int8))
        work = k2_work(sargs, "bf16")
        if a is not None:
            work = {**work, **annot_bound(work, work["pairs"], m_pad, p,
                                          work["int8_ops"], work["f32_ops"],
                                          BF16_OPS, tensor_cores=True)}
        kern = k_bf16()
        t0 = time.time()
        twin = ld_split.split_corrections_plain(*bsargs, a, n_samples=n,
                                                dot_dtype="bf16")
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.time() - t0)
        err = compare_deltas(kern[:3], twin[:3])
        if a is not None:
            err = max(err, hold_accumulators(kern[3:], twin[3:],
                                             f"{name} against its twin"))
        lib_pairs = []
        for _, s0, *_, x, cat3, m_xc in ld_split.segments(*bsargs[:3],
                                                          plan):
            lib_pairs += [(x, cat3), (bsargs[2][s0:s0 + x.shape[0]],
                                      cat3[:2 * plan["p_band"]]),
                          (m_xc, cat3)]
        lib_ms, what = library_bf16_ms(torch, lib_pairs, 5)
        epi_text = ""
        if a is not None:
            # the epilogue's own cost on bf16 operands, in turns with the
            # bf16 call without annotations, its device split and yardstick
            def k_plain(bs=bsargs):
                return ld_split.split_corrections(*bs, n_samples=n)

            t_p, t_a, t_a2, t_p2 = (cuda_ms(torch, f, 10) for f in (
                k_plain, k_bf16, k_bf16, k_plain))
            epi = min(t_a, t_a2) - min(t_p, t_p2)
            dev_a = k2_device_split(torch, k_bf16)
            blib = k2_epilogue_bmm_ms(torch, ld_split.annot_tiles, p, dev)
            work = {**work, "epilogue_ms": epi, "device": dev_a,
                    "epilogue_library_ms": blib["ms"]}
            epi_text = (
                f"; bf16 without annotations, in turns: {t_p:.3f}, "
                f"annotated {t_a:.3f} / {t_a2:.3f}, {t_p2:.3f} ms: the "
                f"epilogue's own cost {epi:.3f} ms; device time per call "
                f"(profiler): K2 fused {dev_a['fused']:.3f} + d "
                f"{dev_a['products']:.3f} ms, {dev_a['n_other']} other ops "
                f"{dev_a['other']:.3f} ms; epilogue yardstick (float32 "
                f"torch.bmm, TF32 off, {blib['shape']}) {blib['ms']:.3f} ms")
        del kern, twin, lib_pairs, bsargs
        out[name] = {"ms": min(ms, ms_b), "plain_ms": plain_ms,
                     "max_abs_err": err, "library_ms": lib_ms,
                     "int8_ms": min(ms8, ms8_b), **work}
        say("20 K2 bf16", f"{plan['n_miss']} contaminated rows, {name}: "
            "products mode and split_corrections bitwise equal to int8, max "
            f"|diff| vs its twin {err:.3g}; {ms:.3f} / {ms_b:.3f} ms against "
            f"int8 {ms8:.3f} / {ms8_b:.3f} ms; bf16 bound "
            f"{work['bound_ms']:.3f} ms ({work['bound_by']}), "
            f"{100 * work['bound_ms'] / min(ms, ms_b):.1f}% of it; twin "
            f"{plain_ms:.1f} ms; {what} on the same products (a, b with h "
            f"read from memory, d, per segment) {lib_ms:.3f} ms{epi_text}; "
            f"on {card}")
    del args, sargs, a_dev
    torch.cuda.empty_cache()
    a = torch.randint(0, 3, (8192, 16384), dtype=torch.int8,
                      device=dev).to(torch.bfloat16)
    b = torch.randint(0, 3, (8192, 16384), dtype=torch.int8,
                      device=dev).to(torch.bfloat16)
    ms_mm, what = library_bf16_ms(torch, [(a, b)], 20)
    say("20 yardstick", f"{what} 8192x16384 . 16384x8192: {ms_mm:.3f} ms, "
        f"{2.0 * 8192 * 16384 * 8192 / ms_mm / 1e9:.0f} TFLOPS; on {card}")
    del a, b
    torch.cuda.empty_cache()
    return out


def bf16_cli_phase(torch, tmp: str, prefix5: str, out5: str, prefix6: str,
                   out6: str, prefix9: str, out9: str, card: str) -> dict:
    """Phase 21: ``ld --dot-dtype bf16`` on the bfiles of phases 5, 9
    (split, and global with ``--no-split-missing``), 6, 13 (streamed) and
    19 (``--annot``, in core on phase 5's, 9's and 6's bfiles): each .L2
    byte-identical to the int8 run's, the launches of the bf16
    instantiations, the peak device memory per genotype; returns those
    launches per instantiation."""
    base = ["-kb", "100", "-maf", "0.01"]
    apath = os.path.join(tmp, "chr.annot")
    # the global route at the chromosome's rows: its int8 run first
    glob9 = os.path.join(tmp, "global9_int8.L2")
    r8 = run_ld(torch, ["--bfile", prefix9, *base, "--extra",
                        "--no-split-missing", "-o", glob9])
    plan = (("clean", prefix5, ["--extra"], out5),
            ("split", prefix9, ["--extra"], out9),
            ("global", prefix6, ["--extra"], out6),
            ("global 9", prefix9, ["--extra", "--no-split-missing"], glob9),
            ("clean streamed", prefix5,
             ["--extra", "--streaming", "--chunk-rows", "8192"],
             os.path.join(tmp, "stream_clean.L2")),
            ("clean --annot", prefix5, ["--annot", apath],
             os.path.join(tmp, "annot_clean.L2")),
            ("split --annot", prefix9, ["--annot", apath],
             os.path.join(tmp, "annot_split.L2")),
            ("global --annot", prefix6, ["--annot", apath],
             os.path.join(tmp, "annot_dense_missing.L2")))
    counts = {}
    for tag, prefix, flags, ref in plan:
        genotypes = (sum(1 for _ in open(prefix + ".bim"))
                     * -(-sum(1 for _ in open(prefix + ".fam")) // 128) * 128)
        out = os.path.join(tmp, "bf16_" + tag.replace(" ", "_").strip("-")
                           + ".L2")
        r = run_ld(torch, ["--bfile", prefix, *base, *flags, "-o", out,
                           "--dot-dtype", "bf16"])
        c = r["launches"]
        if (Path(out).read_bytes() != Path(ref).read_bytes()
                or c["ld_sym_bf16"] != c["ld_sym"] or c["ld_sym"] < 1
                or c["split_bf16"] != c["split_corr"]
                or tag.startswith("global")
                and c["ld_sym_8prod"] != c["ld_sym"]
                or not r["log"].has("bf16 operands")
                and "streamed" not in tag):
            raise RuntimeError(f"phase 21 {tag}: launches {c}, or the .L2 "
                               "differs from the int8 run's")
        counts[tag] = c
        say("21 ld bf16", f"{tag} {' '.join(flags)} --dot-dtype bf16: .L2 "
            f"byte-identical to the int8 run's; launches {c}; "
            f"{r['wall']:.2f} s wall; stages {r['stages']}; peak device "
            f"memory {r['peak']:.3f} GiB ({r['peak'] * 2**30 / genotypes:.3f} "
            f"bytes per padded genotype"
            + (f"; the int8 run's {r8['peak']:.3f} GiB" if tag == "global 9"
               else "") + f"); on {card}")
    return {
        "ld_sym bf16": counts["clean"]["ld_sym_bf16"],
        "ld_sym bf16 8-product": counts["global"]["ld_sym_8prod"],
        "ld_sym bf16 annot": counts["clean --annot"]["ld_sym_annot"],
        "ld_sym bf16 annot 8-product": counts["global --annot"][
            "ld_sym_annot"],
        "split_corr bf16": counts["split"]["split_bf16"],
        "split_corr bf16 annot": counts["split --annot"]["split_annot"],
        "streamed": counts["clean streamed"]["ld_sym_bf16"]}


def f32_phase(torch, tmp: str, prefix5: str, m5: int, dev,
              card: str) -> dict:
    """Phase 22: ``ld --engine f32`` on the card: the golden fixtures
    (symmetric, full band, annot); phase 5's chromosome in core, symmetric
    and full band, against the int8 engine (``ws``/``wsd`` equal, ``wse``
    under the counter contract of ``tests/contract.py`` with a tolerance
    from the f32 engine's measured error, at most 2 apart on a row and on
    at most 1/64 of the rows); a rerun with TF32 enabled process-wide
    bitwise equal; ``ld --engine f32 --streaming`` with a checkpoint.
    Returns what phase 23 reads: the config, the wse tolerance, the
    in-core full band's result and the streamed run."""
    sys.path.insert(0, str(ROOT / "tests"))
    from contract import (EPILOGUE_TOL, assert_counters_match,
                          f32_adj_error, f32_tol)

    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.core.timing import STAGE_TIMES
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import preprocess
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores

    gold = dict(np.load(ROOT / "tests" / "data" / "golden_chr22_toy.npz"))
    gcfg = LDConfig(ld_wind=12000.0, wind_metric="bp", maf_thr=0.01,
                    std_thr=1e-4, rsq_thr=RSQ, use_int8=False)
    errs = []
    for sym in (True, False):
        res = compute_ld_scores(gold["genotypes"], gold["positions"],
                                dataclasses.replace(gcfg, symmetric=sym),
                                device="cuda")
        for k in ("l2", "l2d"):
            np.testing.assert_allclose(res[k], gold[k], rtol=2e-5, atol=2e-4,
                                       equal_nan=True, err_msg=k)
            errs.append(float(np.nanmax(np.abs(res[k] - gold[k]))))
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            np.testing.assert_array_equal(res[k], gold[k], err_msg=k)
    ga = dict(np.load(ROOT / "tests" / "data" / "golden_annot_toy.npz"))
    res = compute_ld_scores(ga["genotypes"], ga["positions"],
                            dataclasses.replace(gcfg, block_size=64),
                            annot=ga["annot"], device="cuda")
    for k in ("l2_annot", "l2d_annot"):
        np.testing.assert_allclose(res[k], ga[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)
        errs.append(float(np.nanmax(np.abs(res[k] - ga[k]))))
    say("22 golden f32", "golden_chr22_toy through the f32 engine on the "
        "card, symmetric and full band (counters equal), and golden_annot_toy "
        "through its annotation engine, at test_golden's tolerances: max abs "
        f"diff {max(errs):.3g}")

    ds = PlinkDataset.parse(prefix5)
    packed, pos = ds.bed.read_raw(), ds.positions("bp")
    n = ds.n_samples
    cfg = LDConfig(ld_wind=100_000.0, maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=1.0 / m5)
    ref = compute_ld_scores(packed, pos, cfg, device="cuda")
    codes = preprocess.unpack_bed(torch.from_numpy(packed.raw).to(dev), n,
                                  n, -1)
    # the worst-case bound N_pad * 2^-24 passes rsq_thr itself at this
    # N_pad; the tolerance is twice the f32 engine's error measured on
    # the pairs that bound would exempt, plus the epilogue's rounding
    bound = f32_tol(-(-n // 128) * 128, n, cfg.rsq_thr)
    t0 = time.time()
    err32, n_near = f32_adj_error(codes, pos, cfg, bound, device=dev)
    tol = EPILOGUE_TOL + 2.0 * err32
    if not 0.0 < err32 < bound or n_near < m5 // 64:
        raise RuntimeError(f"phase 22: f32 adj error {err32:.3g} over "
                           f"{n_near} pairs, bound {bound:.3g}")
    say("22 f32 tolerance", f"max |adj_f32 - adj_f64| {err32:.4g} over the "
        f"{n_near} counted pairs within the worst-case bound {bound:.4g} of "
        f"rsq_thr {cfg.rsq_thr:.4g} ({time.time() - t0:.1f} s): wse "
        f"tolerance EPILOGUE_TOL + 2 x that = {tol:.4g}")
    runs = {}
    for tag, sym in (("symmetric", True), ("full band", False)):
        fcfg = dataclasses.replace(cfg, use_int8=False, symmetric=sym)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        STAGE_TIMES.clear()
        t0 = time.time()
        res = compute_ld_scores(packed, pos, fcfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        device_s = STAGE_TIMES.get("device_s", 0.0)
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            compute_ld_scores(packed, pos, fcfg, device="cuda")
            torch.cuda.synchronize()
        busy = device_busy_ms(torch, prof)
        n_exempt = assert_counters_match(res, ref, codes, pos, cfg, tol,
                                         device=dev)
        row_diff = int(np.abs(res["l2d_wse"] - ref["l2d_wse"]).max())
        if row_diff > 2 or n_exempt > m5 // 64:
            raise RuntimeError(f"phase 22 {tag}: l2d_wse differs on "
                               f"{n_exempt} rows, by up to {row_diff}")
        diffs = {}
        for k in ("l2", "l2d"):
            both = ~np.isnan(res[k]) & ~np.isnan(ref[k])
            np.testing.assert_array_equal(np.isnan(res[k]), np.isnan(ref[k]))
            d = np.abs(res[k][both] - ref[k][both])
            diffs[k] = (float(d.max()), float(
                (d / np.maximum(np.abs(ref[k][both]), 1e-30)).max()))
        runs[tag] = res
        say("22 f32 chromosome", f"M={m5} N={n} +-1000 SNPs, --engine f32 "
            f"{tag}: {wall:.3f} s for compute_ld_scores (device_s "
            f"{device_s:.3f}, device busy {busy:.1f} ms in a profiled "
            f"rerun), peak device memory {peak:.3f} GiB; against the int8 "
            "engine: l2_ws, l2d_ws equal; max abs / rel diff l2 "
            f"{diffs['l2'][0]:.3g} / {diffs['l2'][1]:.3g}, l2d "
            f"{diffs['l2d'][0]:.3g} / {diffs['l2d'][1]:.3g}; l2d_wse differs "
            f"on {n_exempt} rows (limit {m5 // 64}), by at most {row_diff} "
            f"(limit 2), each within the contract (tol {tol:.3g}); on "
            f"{card}")
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = compute_ld_scores(packed, pos, dataclasses.replace(
            cfg, use_int8=False), device="cuda")
    finally:
        torch.set_float32_matmul_precision("highest")
    for k, v in runs["symmetric"].items():
        if not np.array_equal(v, tf32[k], equal_nan=True):
            raise RuntimeError(f"phase 22: {k} moved with TF32 enabled")
    # the f32 engine streamed (the full-band chunk engine), checkpointed:
    # phase 23 holds it against the in-core run and resumes it
    ck = os.path.join(tmp, "ck_f32")
    out_s = os.path.join(tmp, "f32_streamed.L2")
    r = run_ld(torch, ["--bfile", prefix5, "-kb", "100", "-maf", "0.01",
                       "--extra", "--engine", "f32", "--streaming",
                       "--chunk-rows", "8192", "--resume", ck, "-o", out_s])
    check_outputs(out_s, m5)
    say("22 f32 guards", "a rerun with torch.set_float32_matmul_precision("
        "'high') (TF32 allowed process-wide) bitwise equal; --engine f32 "
        f"--streaming runs ({r['wall']:.2f} s; phase 23 checks it)")
    return {"cfg": cfg, "tol": tol, "full band": runs["full band"],
            "run": r, "out": out_s, "ck": ck}


def full_band_phase(torch, tmp: str, prefix5: str, prefix9: str, m5: int,
                    dev, card: str, f32: dict, apath: str,
                    chunk: int = 8192) -> None:
    """Phase 23: the full-band streaming chunk engines on phase 5's and
    phase 9's bfiles (``ld --no-symmetric --streaming`` on int8 and bf16
    operands, ``ld --engine f32 --streaming``): no K1 or K2 launch; bf16's
    .L2 byte-identical to int8's; int8 streamed against the in-core full
    band (counters equal, scores within rtol 1e-6, atol 1e-6); f32
    streamed against the in-core f32 full band (``ws``/``wsd`` equal,
    ``wse`` under phase 22's contract, scores within rtol 2e-5, atol
    2e-4); peak memory, ``STAGE_TIMES``, the streaming pass's device busy
    time and idle share; the f32 engine with phase 19's annotations
    against in core; phase 22's checkpointed f32 run resumed with shards 2
    and 5 deleted."""
    sys.path.insert(0, str(ROOT / "tests"))
    from contract import assert_counters_match

    from nldsc_tpu_torch.io.ldscores import read_annot
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import preprocess
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores
    from nldsc_tpu_torch.ld.streaming import compute_ld_scores_streaming

    base = ["-kb", "100", "-maf", "0.01", "--extra"]
    stream = ["--streaming", "--chunk-rows", str(chunk)]
    n_chunks = m5 // chunk
    route = (f"LD route: streaming ({n_chunks} chunks of {chunk} rows, halo "
             "1024: full band, ")
    cfg, tol = f32["cfg"], f32["tol"]
    c8 = dataclasses.replace(cfg, symmetric=False)
    cf = dataclasses.replace(cfg, use_int8=False, symmetric=False)

    def check_run(what: str, r: dict) -> None:
        if any(r["launches"].values()) or not r["log"].has(route):
            raise RuntimeError(f"phase 23 {what}: launches {r['launches']}, "
                               "or no full-band route line")

    def streamed(bed, pos, c, annot=None):
        """The streaming pass alone, profiled: the result, its wall
        seconds and the device's busy milliseconds."""
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            res = compute_ld_scores_streaming(bed, pos, c, chunk_rows=chunk,
                                              annot=annot, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
        return res, wall, device_busy_ms(torch, prof)

    def max_diff(a: dict, b: dict, keys, tol: dict) -> float:
        worst = 0.0
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], equal_nan=True,
                                       err_msg=k, **tol)
            worst = max(worst, float(np.nanmax(np.abs(a[k] - b[k]))))
        return worst

    def idle(busy_ms: float, wall_s: float) -> str:
        return (f"device busy {busy_ms:.1f} ms "
                f"({100 * (1 - busy_ms / 1e3 / wall_s):.1f}% idle)")

    for tag, prefix in (("clean", prefix5), ("split", prefix9)):
        ds = PlinkDataset.parse(prefix)
        pos = ds.positions("bp")
        runs, outs = {}, {}
        for eng, flags in (("int8", ["--no-symmetric"]),
                           ("bf16", ["--no-symmetric", "--dot-dtype",
                                     "bf16"]),
                           ("f32", ["--engine", "f32"])):
            if eng == "f32" and prefix == prefix5:
                r, out = f32["run"], f32["out"]          # phase 22's run
            else:
                out = os.path.join(tmp, f"full_{tag}_{eng}.L2")
                r = run_ld(torch, ["--bfile", prefix, *base, *flags, *stream,
                                   "-o", out])
                check_outputs(out, m5)
            check_run(f"{tag} {eng}", r)
            runs[eng], outs[eng] = r, out
        if Path(outs["bf16"]).read_bytes() != Path(outs["int8"]).read_bytes():
            raise RuntimeError(f"phase 23 {tag}: the bf16 .L2 is not the "
                               "int8 one")
        say(f"23 full band {tag}", f"M={m5} -kb 100 --streaming --chunk-rows "
            f"{chunk}: " + "; ".join(
                f"{eng} {r['wall']:.2f} s wall, peak device memory "
                f"{r['peak']:.3f} GiB, stages {r['stages']}"
                for eng, r in runs.items())
            + f"; K1/K2 launches 0 in each; bf16 .L2 byte-identical to "
            f"int8's; on {card}")
        packed = ds.bed.read_raw()
        s8, w8, b8 = streamed(ds.bed, pos, c8)
        i8 = compute_ld_scores(packed, pos, c8, device="cuda")
        err8 = max_diff(s8, i8, ("l2", "l2d", "maf", "residuals_std"),
                        dict(rtol=1e-6, atol=1e-6))
        for k in ("l2_ws", "l2d_ws", "l2d_wse"):
            np.testing.assert_array_equal(s8[k], i8[k], err_msg=k)
        del s8, i8
        sf, wf, bf = streamed(ds.bed, pos, cf)
        ref = (f32["full band"] if prefix == prefix5
               else compute_ld_scores(packed, pos, cf, device="cuda"))
        codes = preprocess.unpack_bed(torch.from_numpy(packed.raw).to(dev),
                                      ds.n_samples, ds.n_samples, -1)
        n_exempt = assert_counters_match(sf, ref, codes, pos, cfg, tol,
                                         device=dev)
        del codes
        errf = {k: max_diff(sf, ref, (k,), dict(rtol=2e-5, atol=2e-4))
                for k in ("l2", "l2d")}
        say(f"23 full band {tag} API", f"int8 streaming pass {w8:.3f} s, "
            f"{idle(b8, w8)}; against the in-core full band: counters "
            f"equal, max |l2,l2d,maf,rstd| diff {err8:.3g} (rtol 1e-6); f32 "
            f"streaming pass {wf:.3f} s, {idle(bf, wf)}; against the in-core "
            f"f32 full band: l2_ws, l2d_ws equal, l2d_wse differs on "
            f"{n_exempt} rows within the contract (tol {tol:.3g}), max abs "
            f"diff l2 {errf['l2']:.3g}, l2d {errf['l2d']:.3g}; on {card}")
        del sf, ref, packed

    # the f32 engine with phase 19's annotations, streamed against in core
    ds5 = PlinkDataset.parse(prefix5)
    pos5 = ds5.positions("bp")
    annot, names = read_annot(apath, ds5.bim)
    sa, wa, ba = streamed(ds5.bed, pos5, cf, annot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    ia = compute_ld_scores(ds5.bed.read_raw(), pos5, cf, annot=annot,
                           device="cuda")
    torch.cuda.synchronize()
    wia = time.time() - t0
    peak_ia = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    erra = max_diff(sa, ia, ("l2_annot", "l2d_annot", "l2", "l2d"),
                    dict(rtol=2e-5, atol=2e-4))
    for k in ("l2_ws", "l2d_ws"):
        np.testing.assert_array_equal(sa[k], ia[k], err_msg=k)
    say("23 full band f32 annot", f"p={len(names)}: streaming pass "
        f"{wa:.3f} s, {idle(ba, wa)}; in core {wia:.3f} s, peak "
        f"{peak_ia:.3f} GiB; l2_ws, l2d_ws equal, max abs diff of "
        f"l2_annot, l2d_annot, l2, l2d {erra:.3g} (rtol 2e-5, atol 2e-4); "
        f"on {card}")
    del sa, ia, annot

    # phase 22's checkpoint, two shards deleted: only they run again
    ck = f32["ck"]
    shards = sorted(f for f in os.listdir(ck) if f.startswith("chunk_"))
    if len(shards) != n_chunks:
        raise RuntimeError(f"phase 23: {len(shards)} shards")
    for i in (2, 5):
        os.remove(os.path.join(ck, shards[i]))
    out_r = os.path.join(tmp, "f32_resumed.L2")
    r = run_ld(torch, ["--bfile", prefix5, *base, "--engine", "f32",
                       *stream, "--resume", ck, "-o", out_r])
    check_run("resume", r)
    if Path(out_r).read_bytes() != Path(f32["out"]).read_bytes():
        raise RuntimeError("phase 23: the resumed .L2 is not byte-identical")
    n_res = n_chunks - 2
    if not (r["log"].has(f"Resuming: {n_res} chunks already complete")
            and r["log"].has(f"f32 2, resumed {n_res})")):
        raise RuntimeError(f"phase 23: the resume did not report {n_res} "
                           "chunks")
    say("23 full band resume", f"phase 22's f32 checkpoint with shards 2 and "
        f"5 deleted: {n_res} chunks resumed, 2 run, .L2 byte-identical; "
        f"{r['wall']:.2f} s wall; on {card}")


def compat_phase(torch, prefix5: str, m5: int, card: str) -> None:
    """Phase 24: ``compat.calculate`` on phase 5's bfile, on the card by
    default: in core bitwise equal to ``compute_ld_scores``; with
    ``pipeline.wants_streaming`` forced, streamed (K1 per chunk) within
    KERNEL_TOL, counters equal."""
    from nldsc_tpu_torch import compat
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import pipeline

    ds = PlinkDataset.parse(prefix5)
    pos = ds.positions("bp")
    params = compat.LDScoreParams(
        bfile=prefix5 + ".bed", n_snp=m5, n_org=ds.n_samples,
        ld_wind=100_000.0, maf=0.01, std_thr=1e-4, rsq_thr=1.0 / m5,
        positions=pos.tolist())
    ref = pipeline.compute_ld_scores(
        ds.bed.read_raw(), pos, LDConfig(ld_wind=100_000.0, maf_thr=0.01,
                                         std_thr=1e-4, rsq_thr=1.0 / m5),
        device="cuda")

    def run():
        reset_counts()
        t0 = time.time()
        res = compat.calculate(params)
        return ({k: np.asarray(getattr(res, k)) for k in ref},
                time.time() - t0, launch_counts())

    res, wall, c = run()
    for k in ref:
        if not np.array_equal(res[k], ref[k], equal_nan=True):
            raise RuntimeError(f"phase 24: compat.calculate's {k} is not "
                               "compute_ld_scores'")
    wants = pipeline.wants_streaming
    pipeline.wants_streaming = lambda *a, **k: True
    try:
        res_s, wall_s, c_s = run()
    finally:
        pipeline.wants_streaming = wants
    err = compare_results(res_s, ref)
    if c["ld_sym"] != 1 or c_s["ld_sym"] != m5 // 8192:
        raise RuntimeError(f"phase 24: launches {c} in core, {c_s} streamed")
    say("24 compat", f"compat.calculate (device cuda by default) on phase "
        f"5's bfile: in core {wall:.2f} s, bitwise equal to "
        f"compute_ld_scores (K1 {c['ld_sym']}); streamed (wants_streaming "
        f"forced) {wall_s:.2f} s, K1 {c_s['ld_sym']}, counters equal, max "
        f"|l2,l2d| diff {err:.3g} (KERNEL_TOL); on {card}")


def profile_phase(torch, tmp: str, prefix5: str, out5: str,
                  card: str) -> None:
    """Phase 25: ``nldsc-tpu-torch --log-file ld --profile-dir`` on phase
    5's bfile: the .L2 byte-identical to phase 5's, the trace's kernel
    events include K1's, the ten device ops with the most time, and
    ``nldsc.log`` holding the run's completion line."""
    from nldsc_tpu_torch.cli import main as cli_main
    from nldsc_tpu_torch.ld.pipeline import TRACE_FILE

    work = os.path.join(tmp, "profiled")
    os.makedirs(work)
    prof_dir, out = os.path.join(work, "prof"), os.path.join(work, "p.L2")
    cwd = os.getcwd()
    os.chdir(work)                       # --log-file writes ./nldsc.log
    try:
        t0 = time.time()
        cli_main(["--log-file", "ld", "--bfile", prefix5, "-kb", "100",
                  "-maf", "0.01", "--extra", "-o", out, "--profile-dir",
                  prof_dir])
        wall = time.time() - t0
    finally:
        os.chdir(cwd)
    if Path(out).read_bytes() != Path(out5).read_bytes():
        raise RuntimeError("phase 25: the profiled .L2 is not phase 5's")
    trace_path = Path(prof_dir, TRACE_FILE)
    events = json.loads(trace_path.read_text())["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not any("ld_sym_kernel" in e.get("name", "") for e in device
               if e.get("cat") == "kernel"):
        raise RuntimeError("phase 25: no ld_sym_kernel event in the trace")
    totals: dict = {}
    for e in device:
        totals[e["name"]] = totals.get(e["name"], 0.0) + float(e.get("dur", 0))
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    log_text = Path(work, "nldsc.log").read_text()
    if "Estimation completed" not in log_text:
        raise RuntimeError("phase 25: nldsc.log lacks the completion line")
    say("25 profile", f"--log-file ld --profile-dir: {wall:.2f} s wall; .L2 "
        f"byte-identical to phase 5's; {trace_path.name} "
        f"{trace_path.stat().st_size / 1e6:.1f} MB, {len(device)} device "
        f"events, {sum(totals.values()) / 1e3:.2f} ms of device time; the "
        "ten with the most: " + "; ".join(
            f"{name[:70]} {us / 1e3:.3f} ms" for name, us in top)
        + f"; nldsc.log {len(log_text.splitlines())} lines with the "
        f"completion line; on {card}")


def same_bits(a: dict, b: dict, keys=("l2", "l2d")) -> bool:
    """Whether the float arrays of ``keys`` are bitwise equal (NaN in the
    same places)."""
    return all(np.array_equal(a[k], b[k], equal_nan=True) for k in keys)


def counters_equal(a: dict, b: dict, what: str) -> None:
    for k in ("l2_ws", "l2d_ws", "l2d_wse"):
        if not np.array_equal(a[k], b[k]):
            raise RuntimeError(f"{what}: {k} differs in "
                               f"{int((a[k] != b[k]).sum())} rows")


def within(a: dict, b: dict, keys, what: str, tol=KERNEL_TOL) -> float:
    """The largest difference of ``keys`` between two results, held to
    ``tol``."""
    worst = 0.0
    for k in keys:
        np.testing.assert_allclose(a[k], b[k], equal_nan=True,
                                   err_msg=f"{what}: {k}", **tol)
        d = np.abs(np.asarray(a[k], np.float64) - b[k])
        worst = max(worst, float(np.nanmax(d)) if np.isfinite(d).any()
                    else 0.0)
    return worst


def timed_run(torch, fn, devices, profile: bool = True):
    """``fn()`` once: its result, wall seconds, the CUDA-event span and the
    peak memory above the start (GiB) on each distinct device, and the
    device time of K1's kernels (profiler, ms; None without ``profile``,
    for runs that launch no kernel: tracing their thousands of torch ops
    costs tens of seconds)."""
    import contextlib

    distinct = sorted({d.index for d in devices})
    torch.cuda.synchronize()
    base = {i: torch.cuda.memory_allocated(i) for i in distinct}
    ev = {}
    with (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profile
          else contextlib.nullcontext()) as prof:
        for i in distinct:
            torch.cuda.reset_peak_memory_stats(i)
            with torch.cuda.device(i):
                ev[i] = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                ev[i][0].record()
        t0 = time.time()
        out = fn()
        for i in distinct:
            with torch.cuda.device(i):
                ev[i][1].record()
        torch.cuda.synchronize()
        wall = time.time() - t0
    k1_ms = None if prof is None else sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "ld_sym_kernel" in e.key) / 1e3
    per_dev = {f"cuda:{i}": {
        "event_ms": ev[i][0].elapsed_time(ev[i][1]),
        "peak_gib": (torch.cuda.max_memory_allocated(i) - base[i]) / 2**30}
        for i in distinct}
    return out, wall, per_dev, k1_ms


def multi_device_phase(torch, tmp: str, prefix5: str, out5: str,
                       prefix9: str, apath: str, m5: int, card: str) -> dict:
    """Phase 26: the SNP, sample and grid axes in core at phase 5's shape
    (shards placed round-robin on the visible devices), and the ``ld``
    flags; returns K1's launches and device times per device count."""
    from nldsc_tpu_torch.cli import main as cli_main
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.core.errors import NLDSCParameterError
    from nldsc_tpu_torch.io.ldscores import read_annot
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores
    from nldsc_tpu_torch.parallel import (grid_devices,
                                          ld_scores_grid_sharded,
                                          ld_scores_sample_sharded,
                                          ld_scores_sharded, mesh,
                                          snp_devices)

    k = torch.cuda.device_count()
    cfg = LDConfig(ld_wind=100.0, wind_metric="kbp", maf_thr=0.01,
                   std_thr=1e-4).resolve_rsq(m5)
    ds5 = PlinkDataset.parse(prefix5)
    packed5, pos5 = ds5.bed.read_raw(), ds5.positions("bp")
    incore = compute_ld_scores(packed5, pos5, cfg, device="cuda")
    found = {"launches": {}, "k1_ms": {}}
    runs = {}
    for d in (1, 2, 4):
        devs = snp_devices(d, "cuda", share=True)
        reset_counts()
        mesh.exchange_bytes = 0
        res, wall, per_dev, k1_ms = timed_run(
            torch, lambda: ld_scores_sharded(packed5, pos5, cfg, devs), devs)
        c = launch_counts()
        if c["ld_sym"] != d or c["ld_sym_8prod"] or c["split_corr"]:
            raise RuntimeError(f"phase 26 d={d}: launches {c}, expected K1 "
                               f"{d} (clean)")
        counters_equal(res, incore, f"phase 26 d={d} vs in core")
        if d > 1 and not same_bits(res, runs[1]):
            raise RuntimeError(f"phase 26: l2/l2d at d={d} differ from d=1")
        bit = same_bits(res, incore)
        err = within(res, incore, ("l2", "l2d"), f"phase 26 d={d}")
        runs[d] = res
        found["launches"][str(d)] = c["ld_sym"]
        found["k1_ms"][str(d)] = k1_ms
        say("26 snp axis", f"M={m5} N=16384 -kb 100, ld_scores_sharded on "
            f"{d} shard(s) over {len(set(devs))} distinct device(s) of {k}: "
            f"K1 launches {c['ld_sym']} ({c['ld_sym_by_device']}); wall "
            f"{wall:.3f} s; K1 device time {k1_ms:.3f} ms; per device "
            f"{per_dev}; exchanged {mesh.exchange_bytes / 1e6:.1f} MB; "
            f"counters equal to in core, l2/l2d "
            f"{'bitwise equal to' if bit else f'{err:.3g} off'} in core"
            f"{'' if d == 1 else ', bitwise equal to d=1'}; on {card}")
    del runs

    # the 8-product branch per shard, and the annotation instantiation
    ds9 = PlinkDataset.parse(prefix9)
    packed9, pos9 = ds9.bed.read_raw(), ds9.positions("bp")
    glob = compute_ld_scores(
        packed9, pos9, dataclasses.replace(cfg, split_missing=False),
        device="cuda")
    devs2 = snp_devices(2, "cuda", share=True)
    reset_counts()
    res9 = ld_scores_sharded(packed9, pos9, cfg, devs2)
    c = launch_counts()
    if c["ld_sym_8prod"] != 2 or c["split_corr"]:
        raise RuntimeError(f"phase 26 missing: launches {c}")
    counters_equal(res9, glob, "phase 26 missing vs in-core global")
    err9 = within(res9, glob, ("l2", "l2d"), "phase 26 missing")
    say("26 snp axis missing", f"phase 9's bfile on 2 shards: 8-product K1 "
        f"launches {c['ld_sym_8prod']}; vs the in-core global route: "
        f"counters equal, l2/l2d {'bitwise equal' if same_bits(res9, glob) else f'max diff {err9:.3g}'}")
    del glob, res9, packed9
    annot, _ = read_annot(apath, ds5.bim)
    a_in = compute_ld_scores(packed5, pos5, cfg, annot=annot, device="cuda")
    reset_counts()
    a_sh = ld_scores_sharded(packed5, pos5, cfg, devs2, annot=annot)
    c = launch_counts()
    if c["ld_sym_annot"] != 2:
        raise RuntimeError(f"phase 26 annot: launches {c}")
    counters_equal(a_sh, a_in, "phase 26 annot")
    err_a = within(a_sh, a_in, ("l2", "l2d", "l2_annot", "l2d_annot"),
                   "phase 26 annot")
    say("26 snp axis annot", f"p={annot.shape[1]} on 2 shards: K1 annot "
        f"launches {c['ld_sym_annot']}; vs in core: counters equal, "
        f"l2/l2d/annot {'bitwise equal' if same_bits(a_sh, a_in, ('l2', 'l2d', 'l2_annot', 'l2d_annot')) else f'max diff {err_a:.3g}'}")
    del a_in, a_sh, annot

    # the sample axis and the grid: the integer full band, in torch ops
    full = compute_ld_scores(packed5, pos5,
                             dataclasses.replace(cfg, symmetric=False),
                             device="cuda")
    tabs = {}
    for name, run, layout in (
            ("samples 1", ld_scores_sample_sharded, snp_devices(1, "cuda")),
            ("samples 2", ld_scores_sample_sharded,
             snp_devices(2, "cuda", share=True)),
            ("grid 2x2", ld_scores_grid_sharded,
             grid_devices(2, 2, "cuda", share=True)),
            ("grid 4x1", ld_scores_grid_sharded,
             grid_devices(4, 1, "cuda", share=True))):
        reset_counts()
        mesh.exchange_bytes = 0
        flat = [d for row in layout for d in
                (row if isinstance(row, list) else [row])]
        res, wall, per_dev, _ = timed_run(
            torch, lambda: run(packed5, pos5, cfg, layout), flat,
            profile=False)
        if launch_counts()["ld_sym"] or launch_counts()["split_corr"]:
            raise RuntimeError(f"phase 26 {name}: a kernel ran")
        counters_equal(res, full, f"phase 26 {name}")
        err = within(res, full, ("l2", "l2d"), f"phase 26 {name}")
        tabs[name] = res
        say(f"26 {name.split()[0]}", f"{name} (in core, full band, "
            f"torch._int_mm products summed over the shards): wall "
            f"{wall:.3f} s; per device {per_dev}; exchanged "
            f"{mesh.exchange_bytes / 1e6:.1f} MB; vs the in-core full band: "
            f"counters equal, l2/l2d "
            f"{'bitwise equal' if same_bits(res, full) else f'max diff {err:.3g}'}; on {card}")
    for a, b in (("samples 1", "samples 2"), ("grid 2x2", "grid 4x1")):
        if not same_bits(tabs[a], tabs[b]):
            raise RuntimeError(f"phase 26: {a} and {b} differ")
    del tabs, full, incore

    # the ld flags
    base = ["--bfile", prefix5, "-kb", "100", "-maf", "0.01", "--extra"]
    out1 = os.path.join(tmp, "nd1.L2")
    r1 = run_ld(torch, base + ["--n-devices", "1", "--shard-axis", "snp",
                               "-o", out1])
    if Path(out1).read_bytes() != Path(out5).read_bytes():
        raise RuntimeError("phase 26: ld --n-devices 1 differs from phase 5")
    if k == 1:
        try:
            cli_main(["ld", *base, "--n-devices", "2", "-o",
                      os.path.join(tmp, "nd2.L2")])
            raise RuntimeError("phase 26: --n-devices 2 ran on one card")
        except SystemExit as ex:
            if not isinstance(ex.__cause__, NLDSCParameterError):
                raise RuntimeError(f"phase 26: wrong refusal {ex.__cause__}")
        flags = "--n-devices 2 refused (NLDSCParameterError: one card)"
    else:
        one_full = os.path.join(tmp, "nd1_full.L2")
        run_ld(torch, base + ["--no-symmetric", "-o", one_full])
        for axis, want in (("snp", out5), ("samples", one_full),
                           ("grid", None)):
            out = os.path.join(tmp, f"nd2_{axis}.L2")
            run_ld(torch, base + ["--n-devices", "2", "--shard-axis", axis,
                                  "-o", out])
            if want and Path(out).read_bytes() != Path(want).read_bytes():
                raise RuntimeError(f"phase 26: ld --n-devices 2 "
                                   f"--shard-axis {axis} differs")
        flags = ("--n-devices 2 on each axis: snp byte-identical to phase 5, "
                 "samples to the one-device --no-symmetric run, grid ran "
                 "(2 devices: no 2-D factorization, the SNP axis)")
    say("26 ld flags", f"ld --n-devices 1 --shard-axis snp: .L2 "
        f"byte-identical to phase 5's ({r1['wall']:.2f} s); {flags}; "
        f"{k} visible device(s)")
    return found


def multi_stream_phase(torch, tmp: str, prefix9: str, out14: str, m5: int,
                       card: str, chunk: int = 8192) -> dict:
    """Phase 27: phase 14's bfile through the devices ring of 2 (K1 per
    chunk, K2 per contaminated chunk, .L2 byte-identical to phase 14's,
    resumed), a sample mesh of 2 and a grid of 2x2 against the
    single-device streamed full band; returns the ring's launches."""
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.ldscores import make_output, write_l2
    from nldsc_tpu_torch.io.plink import PlinkDataset, scan_rowmiss
    from nldsc_tpu_torch.ld.streaming import compute_ld_scores_streaming
    from nldsc_tpu_torch.parallel import grid_devices, snp_devices

    cfg = LDConfig(ld_wind=100.0, wind_metric="kbp", maf_thr=0.01,
                   std_thr=1e-4).resolve_rsq(m5)
    ds = PlinkDataset.parse(prefix9)
    pos = ds.positions("bp")
    n_chunks = m5 // chunk
    want_k2 = band_chunks(scan_rowmiss(ds.bed), chunk, 1024)
    ring = snp_devices(2, "cuda", share=True)

    def write(res, name):
        out = os.path.join(tmp, name)
        write_l2(make_output(ds.bim, res, extra=True), out)
        return Path(out).read_bytes()

    want = Path(out14).read_bytes()
    reset_counts()
    res, wall, per_dev, k1_ms = timed_run(
        torch, lambda: compute_ld_scores_streaming(
            ds.bed, pos, cfg, chunk_rows=chunk, device="cuda", devices=ring),
        ring)
    c = launch_counts()
    if (c["ld_sym"] != n_chunks or c["ld_sym_8prod"]
            or c["split_corr"] != 2 * want_k2):
        raise RuntimeError(f"phase 27 ring: launches {c}, expected K1 "
                           f"{n_chunks}, K2 {2 * want_k2}")
    if write(res, "ring.L2") != want:
        raise RuntimeError("phase 27: the ring's .L2 differs from phase 14's")
    found = {"ld_sym": c["ld_sym"], "split_corr": c["split_corr"]}
    say("27 ring", f"phase 14's bfile, devices ring of 2 ({len(set(ring))} "
        f"distinct device(s)), --chunk-rows {chunk}: K1 {c['ld_sym']} "
        f"({c['ld_sym_by_device']}), K2 {c['split_corr']} "
        f"({c['split_by_device']}); .L2 byte-identical to phase 14's; wall "
        f"{wall:.3f} s, K1 device time {k1_ms:.3f} ms, per device "
        f"{per_dev}; on {card}")

    ck = os.path.join(tmp, "ring_ck")
    compute_ld_scores_streaming(ds.bed, pos, cfg, chunk_rows=chunk,
                                device="cuda", devices=ring, resume_path=ck)
    for f in sorted(Path(ck).glob("chunk_*.npz"))[3:]:
        f.unlink()
    reset_counts()
    resumed = compute_ld_scores_streaming(
        ds.bed, pos, cfg, chunk_rows=chunk, device="cuda", devices=ring,
        resume_path=ck)
    if write(resumed, "ring_resumed.L2") != want:
        raise RuntimeError("phase 27: the resumed ring's .L2 differs")
    say("27 ring resume", f"shards 3-{n_chunks - 1} deleted: "
        f"{launch_counts()['ld_sym']} K1 launches, .L2 byte-identical to "
        "phase 14's")

    # the sample-sharded rings run the symmetric pass in torch ops: the
    # mirrored dominance value of a pair multiplies its per-SNP factors in
    # another order than the full band's direct one, so l2d_wse is held to
    # tests/contract.py with the epilogue's rounding as its tolerance
    sys.path.insert(0, str(ROOT / "tests"))
    from contract import EPILOGUE_TOL, assert_counters_match
    from nldsc_tpu_torch.ld.preprocess import unpack_bed

    full = compute_ld_scores_streaming(
        ds.bed, pos, dataclasses.replace(cfg, symmetric=False),
        chunk_rows=chunk, device="cuda")
    codes = unpack_bed(torch.from_numpy(ds.bed.read_raw().raw).cuda(),
                       ds.n_samples, ds.n_samples, -1)
    sampled = {}
    for name, kw in (("sample mesh of 2",
                      {"sample_mesh": snp_devices(2, "cuda", share=True)}),
                     ("grid 2x2",
                      {"grid": grid_devices(2, 2, "cuda", share=True)})):
        reset_counts()
        flat = kw.get("sample_mesh") or [d for r in kw["grid"] for d in r]
        res, wall, per_dev, _ = timed_run(
            torch, lambda kw=kw: compute_ld_scores_streaming(
                ds.bed, pos, cfg, chunk_rows=chunk, device="cuda", **kw),
            flat, profile=False)
        if launch_counts()["ld_sym"] or launch_counts()["split_corr"]:
            raise RuntimeError(f"phase 27 {name}: a kernel ran")
        n_exempt = assert_counters_match(res, full, codes, pos, cfg,
                                         EPILOGUE_TOL, device="cuda")
        if n_exempt > m5 // 1024:
            raise RuntimeError(f"phase 27 {name}: l2d_wse differs on "
                               f"{n_exempt} rows")
        err = within(res, full, ("l2", "l2d"), f"phase 27 {name}")
        sampled[name] = res
        say("27 samples", f"{name}, streamed (symmetric, torch ops, products "
            f"summed over the sample shards): wall {wall:.3f} s, per device "
            f"{per_dev}; vs the single-device streamed full band: l2_ws, "
            f"l2d_ws equal, l2d_wse on {n_exempt} rows within the contract "
            f"(tol {EPILOGUE_TOL:.3g}), max |l2,l2d| diff {err:.3g}; on "
            f"{card}")
    if not same_bits(*sampled.values(), keys=tuple(full)):
        raise RuntimeError("phase 27: the grid's results differ from the "
                           "sample mesh's")
    say("27 samples", "the grid 2x2 bitwise equal to the sample mesh of 2")
    return found


def progress_phase(torch, tmp: str, prefix5: str, out5: str, m5: int,
                   card: str) -> dict:
    """Phase 28: ``ld --no-progress`` and ``ld --pallas`` on phase 5's
    bfile against phase 5's run (16 segments), and K1's device time over
    the segments beside one launch; returns the launches with and
    without progress."""
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import ld_pallas_sym
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores

    seg = ld_pallas_sym.MAX_SEGMENTS
    base = ["--bfile", prefix5, "-kb", "100", "-maf", "0.01", "--extra"]
    runs = {}
    for tag, flags, want in (("progress", [], seg),
                             ("--no-progress", ["--no-progress"], 1),
                             ("--pallas", ["--pallas"], seg)):
        out = os.path.join(tmp, f"p28_{tag.strip('-')}.L2")
        r = run_ld(torch, base + flags + ["-o", out])
        c = r["launches"]
        if c["ld_sym"] != want or c["ld_sym_8prod"] or c["split_corr"]:
            raise RuntimeError(f"phase 28 {tag}: launches {c}, expected "
                               f"K1 {want}")
        if Path(out).read_bytes() != Path(out5).read_bytes():
            raise RuntimeError(f"phase 28 {tag}: the .L2 is not phase 5's")
        runs[tag] = r
    ticks = [x for x in runs["progress"]["log"].lines
             if x.startswith("LD pass")]
    if len(ticks) != seg or not all("| ETA " in x for x in ticks):
        raise RuntimeError(f"phase 28: {len(ticks)} progress lines {ticks}")
    say("28 progress", f"ld on phase 5's bfile: progress on by default, "
        f"{runs['progress']['launches']['ld_sym']} K1 launches, "
        f"{runs['progress']['wall']:.2f} s wall, lines {ticks[0]!r} ... "
        f"{ticks[-1]!r}; --no-progress {runs['--no-progress']['launches']['ld_sym']} "
        f"launch, {runs['--no-progress']['wall']:.2f} s wall; --pallas "
        f"{runs['--pallas']['launches']['ld_sym']} launches, "
        f"{runs['--pallas']['wall']:.2f} s wall; each .L2 byte-identical to "
        f"phase 5's; on {card}")

    # the pass alone, one launch and 16 segments in turns
    ds = PlinkDataset.parse(prefix5)
    packed, pos = ds.bed.read_raw(), ds.positions("bp")
    cfg = LDConfig(ld_wind=100.0, wind_metric="kbp", maf_thr=0.01,
                   std_thr=1e-4).resolve_rsq(m5)
    dev = [torch.device("cuda", 0)]
    compute_ld_scores(packed, pos, cfg, device="cuda")        # warm up
    timed = {"one": [], "segments": []}
    results = {}
    for tag in ("one", "segments", "segments", "one"):
        prog = None if tag == "one" else (lambda done, total: None)
        res, wall, _, k1_ms = timed_run(torch, lambda: compute_ld_scores(
            packed, pos, cfg, device="cuda", progress=prog), dev)
        timed[tag].append((wall, k1_ms))
        results[tag] = res
    if not same_bits(results["one"], results["segments"],
                     keys=tuple(results["one"])):
        raise RuntimeError("phase 28: the segmented pass differs from one "
                           "launch")
    say("28 segments", "compute_ld_scores on phase 5's chromosome, in turns "
        "(one launch, 16 segments, 16 segments, one launch): K1 device time "
        + ", ".join(f"{k1:.3f} ms" for _, k1 in (
            timed["one"][0], *timed["segments"], timed["one"][1]))
        + "; walls " + ", ".join(f"{w:.3f} s" for w, _ in (
            timed["one"][0], *timed["segments"], timed["one"][1]))
        + f"; outputs bitwise equal; on {card}")
    return {"launches": {"progress": runs["progress"]["launches"]["ld_sym"],
                         "no_progress":
                             runs["--no-progress"]["launches"]["ld_sym"]},
            "k1_ms": {k: [k1 for _, k1 in v] for k, v in timed.items()},
            "wall_s": {k: [w for w, _ in v] for k, v in timed.items()}}


#: the cases of phase 29: the bfile of phase 5 or 9, with phase 19's
#: annotations or not
MP_CASES = {"clean": ("prefix5", False), "missing": ("prefix9", False),
            "annot": ("prefix5", True)}


def mp_worker(rank: int, port: int, spec_path: str) -> int:
    """One rank of phase 29 (``python3 chip_smoke.py --worker RANK PORT
    SPEC``): every case of :data:`MP_CASES` through
    ``estimate_lds_mesh`` on cuda:0, then ``estimate_lds_multihost``;
    writes its report beside ``SPEC``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from nldsc_tpu_torch.parallel import distributed, mesh

    spec = json.loads(Path(spec_path).read_text())
    distributed.init_distributed(f"127.0.0.1:{port}", 2, rank, "gloo",
                                 timeout_s=300)
    mesh.RECV_TIMEOUT_S = 300
    run = dict(maf_thr=0.01, std_thr=1e-4)
    report = {"cases": {}}
    for name, (key, annot) in MP_CASES.items():
        reset_counts()
        mesh.exchange_bytes = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        distributed.estimate_lds_mesh(
            spec[key], 100.0, "kbp", extra=not annot, devices=["cuda:0"],
            annot=spec["annot"] if annot else None,
            out=os.path.join(spec["work"], f"mp_{name}.L2"), **run)
        torch.cuda.synchronize()
        c = launch_counts()
        report["cases"][name] = {
            "wall_s": time.time() - t0, "sent_mb": mesh.exchange_bytes / 1e6,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "launches": {k: v for k, v in c.items() if k.startswith("ld_sym")
                         and not k.endswith("device")}}
    reset_counts()
    t0 = time.time()
    report["multihost"] = distributed.estimate_lds_multihost(
        [spec["prefix5"], spec["prefix9"]],
        os.path.join(spec["work"], f"mh{rank}", "{stem}.L2"), ld_wind=100.0,
        wind_metric="kbp", extra=True, device="cuda", **run)
    report["multihost_s"] = time.time() - t0
    report["multihost_launches"] = launch_counts()["ld_sym"]
    report["imported"] = sorted({k.split(".")[0] for k in sys.modules}
                                & {"jax", "nldsc_tpu", "pandas"})
    torch.distributed.destroy_process_group()
    Path(spec["work"], f"rank{rank}.json").write_text(json.dumps(report))
    return 0


def multiprocess_phase(torch, tmp: str, prefix5: str, out5: str,
                       prefix9: str, out9: str, apath: str,
                       card: str) -> dict:
    """Phase 29: two ``gloo`` ranks on cuda:0 against one process's run on
    two shards of it; returns each rank's K1 launches per case."""
    import socket

    from nldsc_tpu_torch.parallel import distributed, mesh

    work = os.path.join(tmp, "mp")
    for d in ("", "mh0", "mh1"):
        os.makedirs(os.path.join(work, d), exist_ok=True)
    spec = {"work": work, "prefix5": prefix5, "prefix9": prefix9,
            "annot": apath}
    files = {"prefix5": prefix5, "prefix9": prefix9}
    one = {}
    for name, (key, annot) in MP_CASES.items():
        reset_counts()
        mesh.exchange_bytes = 0
        t0 = time.time()
        distributed.estimate_lds_mesh(
            files[key], 100.0, "kbp", maf_thr=0.01, std_thr=1e-4,
            extra=not annot, devices=["cuda:0", "cuda:0"],
            annot=apath if annot else None,
            out=os.path.join(work, f"one_{name}.L2"))
        one[name] = (time.time() - t0, mesh.exchange_bytes / 1e6,
                     launch_counts()["ld_sym"])
    torch.cuda.empty_cache()
    spec_path = os.path.join(work, "spec.json")
    Path(spec_path).write_text(json.dumps(spec))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--worker", str(r), str(port), spec_path])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.time() - t0
    if rcs != [0, 0]:
        raise RuntimeError(f"phase 29: the ranks exited {rcs}")
    reports = [json.loads(Path(work, f"rank{r}.json").read_text())
               for r in range(2)]
    for name in MP_CASES:
        for suffix in (".L2", ".M", ".M_5_50"):
            if (Path(work, f"mp_{name}{suffix}").read_bytes()
                    != Path(work, f"one_{name}{suffix}").read_bytes()):
                raise RuntimeError(f"phase 29 {name}: {suffix} differs from "
                                   "one process's run on two shards")
        per = [r["cases"][name] for r in reports]
        k1 = [p["launches"]["ld_sym"] for p in per]
        if k1 != [1, 1]:
            raise RuntimeError(f"phase 29 {name}: K1 launches {k1}")
        say("29 ranks", f"{name}: estimate_lds_mesh on 2 gloo ranks x 1 shard "
            f"(cuda:0 shared): .L2/.M/.M_5_50 byte-identical to one process "
            f"on 2 shards ({one[name][0]:.2f} s, {one[name][1]:.1f} MB "
            f"copied, K1 {one[name][2]}); per rank: "
            + "; ".join(f"rank {r}: launches {p['launches']}, wall "
                        f"{p['wall_s']:.2f} s, sent {p['sent_mb']:.1f} MB, "
                        f"peak {p['peak_gib']:.3f} GiB"
                        for r, p in enumerate(per)) + f"; on {card}")
    want = {0: (prefix5, out5), 1: (prefix9, out9)}
    for r, rep in enumerate(reports):
        prefix, ref = want[r]
        path = os.path.join(work, f"mh{r}", Path(prefix).stem + ".L2")
        if rep["multihost"] != [path]:
            raise RuntimeError(f"phase 29: rank {r} wrote {rep['multihost']}")
        for suffix in (".L2", ".M", ".M_5_50"):
            if (Path(path).with_suffix(suffix).read_bytes()
                    != Path(ref).with_suffix(suffix).read_bytes()):
                raise RuntimeError(f"phase 29: rank {r}'s {suffix} is not "
                                   "the ld run's")
        if rep["imported"]:
            raise RuntimeError(f"phase 29: rank {r} imported {rep['imported']}")
    say("29 multihost", "estimate_lds_multihost([phase 5, phase 9]): rank 0 "
        f"wrote {Path(reports[0]['multihost'][0]).name} "
        f"({reports[0]['multihost_s']:.2f} s, K1 "
        f"{reports[0]['multihost_launches']}), rank 1 "
        f"{Path(reports[1]['multihost'][0]).name} "
        f"({reports[1]['multihost_s']:.2f} s, K1 "
        f"{reports[1]['multihost_launches']}), each byte-identical to its "
        f"phase's .L2/.M/.M_5_50; neither rank imported jax, nldsc_tpu or "
        f"pandas; both processes {wall:.1f} s in all; on {card}")
    return {str(r): {name: rep["cases"][name]["launches"]["ld_sym"]
                     for name in MP_CASES} for r, rep in enumerate(reports)}


def scalars_worker(codes_path: str, out_path: str) -> int:
    """One process of phase 30 (``python3 chip_smoke.py --scalars-worker
    CODES OUT``, no CUDA device): the CPU per-SNP scalars of the F4 codes
    at 8 threads, then ATen's own ``torch.sqrt`` of the additive variance
    as the process's first MKL VML call; writes both to ``OUT``."""
    import torch

    torch.set_num_threads(8)
    sys.path.insert(0, str(ROOT))
    from nldsc_tpu_torch.ld import ld_int8

    g = torch.from_numpy(np.load(codes_path))
    n = g.shape[1]
    pre = ld_int8.preprocess_int8(g, torch.ones(len(g), dtype=torch.bool),
                                  0.01, n, assume_no_missing=True)
    c1 = (g == 1).sum(1, dtype=torch.float32)
    c2 = (g == 2).sum(1, dtype=torch.float32)
    va = ld_int8.dom_class_stats(float(n) - c1 - c2, c1, c2)[0]
    x = va / float(n) / float(n)
    np.savez(out_path, x=x.numpy(), aten_sqrt=torch.sqrt(x).numpy(),
             threads=torch.get_num_threads(),
             capability=torch.backends.cpu.get_cpu_capability(),
             **{k: pre[k].numpy() for k in (*ld_int8.SCAL_FIELDS, "rstd")})
    return 0


def numerics_phase(torch, tmp: str, dev, card: str) -> None:
    """Phase 30: the CPU per-SNP scalars at the F4 shape in 3 fresh
    processes against NumPy's correctly rounded values and the card's."""
    sys.path.insert(0, str(ROOT / "tests"))
    from numerics_ref import F4_CFG, f4_data, reference_scalars, sqrt64

    from nldsc_tpu_torch.core.numerics import sqrt_rn
    from nldsc_tpu_torch.ld import ld_int8

    t0 = time.time()
    g, _ = f4_data()
    m, n = g.shape
    codes = os.path.join(tmp, "f4_codes.npy")
    np.save(codes, g)
    ref = reference_scalars(g, F4_CFG["maf_thr"], n)
    card_pre = ld_int8.preprocess_int8(
        torch.from_numpy(g).to(dev), torch.ones(m, dtype=torch.bool,
                                                device=dev),
        F4_CFG["maf_thr"], n, assume_no_missing=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    outs = [os.path.join(tmp, f"f4_scalars{i}.npz") for i in range(3)]
    # started together: importing torch takes most of each process's time
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--scalars-worker", codes, out], env=env)
             for out in outs]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    if rcs != [0, 0, 0]:
        raise RuntimeError(f"phase 30: the CPU processes exited {rcs}")
    runs = [dict(np.load(out)) for out in outs]
    aten = []
    for i, r in enumerate(runs):
        for k in ("inv_sd", "inv_rstd", "rstd"):
            if not np.array_equal(r[k], ref[k], equal_nan=True):
                raise RuntimeError(f"phase 30, process {i}: the CPU {k} is not "
                                   "correctly rounded")
        for k in (*ld_int8.SCAL_FIELDS, "rstd"):
            if not np.array_equal(r[k], card_pre[k].cpu().numpy(),
                                  equal_nan=True):
                raise RuntimeError(f"phase 30, process {i}: the CPU {k} "
                                   "differs from the card's")
        want = sqrt64(r["x"])
        off = np.flatnonzero(r["aten_sqrt"] != want)
        rel = (float(np.max(np.abs(r["aten_sqrt"][off] / want[off] - 1)))
               if off.size else 0.0)
        aten.append(f"{off.size} rows off (max rel {rel:.3g})")
    x = torch.from_numpy(runs[0]["x"])
    if not (np.array_equal(sqrt_rn(x).numpy(), sqrt64(runs[0]["x"]))
            and torch.equal(sqrt_rn(x.to(dev)).cpu(), sqrt_rn(x))):
        raise RuntimeError("phase 30: sqrt_rn differs between the devices")
    say("30 scalars", f"M={m} N={n}: 3 fresh CPU processes at "
        f"{int(runs[0]['threads'])} threads ({runs[0]['capability']}): "
        "inv_sd, inv_rstd, rstd bitwise NumPy's correctly rounded values, "
        "every per-SNP scalar bitwise the card's, sqrt_rn bitwise on both "
        "devices; ATen's CPU torch.sqrt as each process's first VML call: "
        + "; ".join(aten) + f"; {time.time() - t0:.1f} s; on {card}")


def xla_f32_phase(torch, tmp: str, dev, card: str, times: dict) -> None:
    """Phase 31: at N = 1,500 the kernels' counters equal their twins' on
    the card, and the card's counters and per-SNP scalars are bitwise the
    CPU port's, on the split and the global route."""
    from nldsc_tpu_torch.config import LDConfig
    from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split
    from nldsc_tpu_torch.ld.pipeline import compute_ld_scores

    t0 = time.time()
    rng = np.random.default_rng(31)
    m, n = 4096, 1500
    g = synthetic_genotypes(rng, m, n)
    inject_row_missing(rng, g, 0.05, 0.02)
    bp = np.arange(1, m + 1, dtype=np.int64) * 100
    prefix = write_plink(os.path.join(tmp, "f2_card"), g, bp=bp)
    ds = PlinkDataset.parse(prefix)
    packed, pos = ds.bed.read_raw(), ds.positions("bp")
    # a +-200 SNP window (20 kb): the CPU runs each route once too
    cfg = LDConfig(ld_wind=20_000.0, maf_thr=0.01, std_thr=1e-4,
                   rsq_thr=RSQ)
    keys = ("l2_ws", "l2d_ws", "l2d_wse")
    for route, split in (("split", None), ("global", False)):
        out = os.path.join(tmp, f"f2_{route}.L2")
        run = run_ld(torch, ["--bfile", prefix, "-kb", "20", "-maf", "0.01",
                             "-rsq", str(RSQ), "--extra", "-o", out]
                     + ([] if split is None else ["--no-split-missing"]))
        c = run["launches"]
        if route == "split" and not (c["ld_sym"] and c["split_fused"] == 1
                                     and not c["ld_sym_8prod"]):
            raise RuntimeError(f"phase 31: ld took no split route: {c}")
        if route == "global" and not (c["ld_sym_8prod"]
                                      and not c["split_corr"]):
            raise RuntimeError(f"phase 31: ld took no global route: {c}")
        l2 = read_l2(out)
        rcfg = dataclasses.replace(cfg, split_missing=split)
        card_res = compute_ld_scores(packed, pos, rcfg, device="cuda")
        cpu_res = compute_ld_scores(packed, pos, rcfg, device="cpu")
        for k, col in zip(keys, ("WSA", "WSD", "WSDE")):
            if not (np.array_equal(card_res[k], cpu_res[k])
                    and np.array_equal(l2[col], card_res[k])):
                raise RuntimeError(f"phase 31 {route}: {k} of the card "
                                   "differs from the CPU port's")
        for k in ("maf", "residuals_std"):
            if not np.array_equal(card_res[k], cpu_res[k], equal_nan=True):
                raise RuntimeError(f"phase 31 {route}: {k} of the card "
                                   "differs from the CPU port's")
        err = compare_results(card_res, cpu_res)
        say("31 F2 ld", f"M={m} N={n}, {route} route: ld launches "
            f"{ {k: v for k, v in c.items() if v and 'by_device' not in k} }; "
            "card l2_ws, l2d_ws, l2d_wse, maf and rstd bitwise the CPU "
            f"port's (and the .L2's), max |l2,l2d| diff {err:.3g}")

    # each kernel against its twin on the card, counters exactly equal
    wind = cfg.ld_wind
    for has_missing in (False, True):
        args, n_, _, raw = engine_inputs(torch, g, pos, wind, dev,
                                         materialize_m=has_missing)
        T = ld_pallas_sym.tile(has_missing)
        kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n_,
                                         has_missing=has_missing,
                                         block_size=T)
        err = compare(finalized(kern, args),
                      finalized(twin_credits(args, n_, has_missing, T),
                                args))
        say("31 K1=twin", f"{'8-product' if has_missing else 'clean'} "
            f"branch at N={n}: counters equal to the twin on the card, max "
            f"|l2,l2d| diff {err:.3g}")
        if not has_missing:
            sargs = split_args(args, raw, n_)
            kern = ld_split.split_corrections(*sargs, n_samples=n_)
            err = compare_deltas(kern, ld_split.split_corrections_plain(
                *sargs, n_samples=n_))
            cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in sargs)
            err = max(err, compare_deltas(
                kern, ld_split.split_corrections_plain(*cpu_args,
                                                       n_samples=n_)))
            say("31 K2=twin", f"fused corrections at N={n}: wse equal to the "
                "twin on the card and on the CPU, max |l2,l2d| diff "
                f"{err:.3g}")
        del args, raw, kern

    # the per-SNP scalars, with a constant and a counted n_valid
    pos_ok = torch.ones(m, dtype=torch.bool)
    for tag, codes, clean in (("clean", np.maximum(g, 0), True),
                              ("missing", g, False)):
        pre = {d: ld_int8.preprocess_int8(
            torch.from_numpy(codes).to(d), pos_ok.to(d), 0.01, n,
            assume_no_missing=clean) for d in (dev, torch.device("cpu"))}
        for k in (*ld_int8.SCAL_FIELDS, "maf", "rstd"):
            a, b = pre[dev][k].cpu().numpy(), pre[torch.device("cpu")][k]
            if not np.array_equal(a.view(np.int32), b.numpy().view(np.int32)):
                raise RuntimeError(f"phase 31: the card's {tag} {k} differs "
                                   "from the CPU port's")
    say("31 scalars", f"M={m} N={n}: every per-SNP scalar bitwise the CPU "
        "port's, clean (n_valid the constant n) and with missing genotypes")
    say("31 times", "at the chromosome shape (M=65,536 N=16,384, phases 7 "
        "and 10), with the fused multiply-adds and f32(1/n) in the "
        "epilogue: " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + f"; phase {time.time() - t0:.1f} s; on {card}")


#: phase 32's shape: the reference's UK Biobank sample count (n_pad
#: 315,648: the sample padding runs at width), its in-core codes past
#: 2^31 bytes
WIDE_M, WIDE_N = 8192, 315_599


def wide_phase(torch, tmp: str, dev, card: str) -> dict:
    """Phase 32: UK Biobank width, N = 315,599 x M = 8,192; returns K1's
    and K2's times and bounds at that width."""
    from nldsc_tpu_torch.io.plink import PlinkDataset
    from nldsc_tpu_torch.ld import ld_int8, ld_pallas_sym, ld_split, preprocess
    from nldsc_tpu_torch.ld.pipeline import (INCORE_BYTES_PER_GENOTYPE,
                                             padded_shape)

    m, n = WIDE_M, WIDE_N
    t0 = time.time()
    prefix = write_chromosome(torch, os.path.join(tmp, "wide"), m, n,
                              2026, dev)
    torch.cuda.empty_cache()
    ds = PlinkDataset.parse(prefix)
    packed, pos = ds.bed.read_raw(), ds.positions("bp")
    m_pad, n_pad = padded_shape(m, n, "cuda", ld_pallas_sym.ROW_ALIGN)
    say("32 data", f"M={m} N={n} (n_pad {n_pad}; the codes "
        f"{m_pad * n_pad / 2**31:.2f} x 2^31 bytes), seed 2026, "
        f"{int(MISS_RATE * 100)}% missing in every {MISS_EVERY}th "
        f"SNP: drawn and packed on the card, {packed.raw.nbytes / 1e6:.0f} "
        f"MB .bed, in {time.time() - t0:.1f} s")

    # in core on the split and global routes: counters equal, the peak
    # within the auto-streaming rule's bytes per genotype
    base = ["--bfile", prefix, "-kb", "100", "-maf", "0.01", "--extra"]
    limit = INCORE_BYTES_PER_GENOTYPE["int8"]
    tabs, over = {}, []
    for route, flags, want in (("split", [], ("ld_sym", "split_fused")),
                               ("global", ["--no-split-missing"],
                                ("ld_sym_8prod",))):
        out = os.path.join(tmp, f"wide_{route}.L2")
        r = run_ld(torch, base + flags + ["-o", out])
        c = r["launches"]
        if not all(c[k] for k in want) or (route == "split") == bool(
                c["ld_sym_8prod"]):
            raise RuntimeError(f"phase 32 {route}: launches {c}")
        check_outputs(out, m)
        tabs[route] = read_l2(out)
        per = r["peak"] * 2**30 / (m_pad * n_pad)
        if per > limit:
            over.append(f"{route} {per:.3f}")
        say(f"32 ld {route}", f"in core: {r['wall']:.2f} s wall; stages "
            f"{r['stages']}; peak device memory {r['peak']:.3f} GiB = "
            f"{per:.3f} bytes per padded genotype (INCORE_BYTES_PER_GENOTYPE "
            f"{limit}); launches "
            f"{ {k: v for k, v in c.items() if v and 'by_device' not in k} }"
            f"; on {card}")
    cols = ("L2", "L2D", "WSA", "WSD", "WSDE")
    err = compare([tabs["split"][k] for k in cols],
                  [tabs["global"][k] for k in cols])

    # streamed at 2,048 rows a chunk, then resumed
    ck = os.path.join(tmp, "wide_ck")
    stream = base + ["--streaming", "--chunk-rows", "2048", "--resume", ck]
    out_s, out_r = (os.path.join(tmp, f"wide_stream{s}.L2") for s in ("", "_r"))
    r = run_ld(torch, stream + ["-o", out_s])
    shards = sorted(Path(ck).glob("chunk_*.npz"))
    for f in shards[1:]:
        f.unlink()
    rr = run_ld(torch, stream + ["-o", out_r])
    if Path(out_s).read_bytes() != Path(out_r).read_bytes() or not rr[
            "log"].has("rowmiss: read the cached bitmap"):
        raise RuntimeError("phase 32: the resumed .L2 is not byte-identical, "
                           "or the resume scanned the .bed again")
    st = read_l2(out_s)
    err_s = compare([st[k] for k in cols], [tabs["split"][k] for k in cols])
    say("32 stream", f"--streaming --chunk-rows 2048: {len(shards)} chunks, "
        f"{r['wall']:.2f} s wall, peak {r['peak']:.3f} GiB, launches "
        f"{ {k: v for k, v in r['launches'].items() if v and 'by_device' not in k} }"
        f"; shards 1-{len(shards) - 1} deleted and resumed in "
        f"{rr['wall']:.2f} s: .L2 byte-identical, cached rowmiss read; "
        f"split = global in core (counters equal, max |L2,L2D| diff "
        f"{err:.3g}), streamed = in core (max diff {err_s:.3g})")

    # each kernel against its twin on 256 rows at full N; the per-SNP
    # scalars against the CPU port's
    wind = 100_000.0
    rows = slice(m // 2, m // 2 + 256)
    win_raw = packed.raw[rows]
    clean_raw = clean_copy(win_raw, n)
    errs = {}
    for name, raw_w, has_missing in (("K1 clean", clean_raw, False),
                                     ("K1 8-product", win_raw, True)):
        args, n_, _, _ = packed_inputs(torch, raw_w, n, has_missing,
                                       pos[rows], wind, dev)
        T = ld_pallas_sym.tile(has_missing)
        kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n_,
                                         has_missing=has_missing,
                                         block_size=T)
        errs[name] = compare(finalized(kern, args), finalized(
            twin_credits(args, n_, has_missing, T), args))
    args, n_, _, raw = packed_inputs(torch, win_raw, n, True, pos[rows],
                                     wind, dev, materialize_m=False)
    sargs = split_args(args, raw, n_)
    errs["K2"] = compare_deltas(
        ld_split.split_corrections(*sargs, n_samples=n_),
        ld_split.split_corrections_plain(*sargs, n_samples=n_))
    n_miss = sargs[-1]["n_miss"]
    del args, sargs
    cpu = torch.device("cpu")
    for tag, raw_w, clean in (("clean", clean_raw, True),
                              ("missing", win_raw, False)):
        gd = preprocess.unpack_bed(torch.from_numpy(raw_w).to(dev), n,
                                   n_pad, 0 if clean else -1)
        ok = torch.ones(gd.shape[0], dtype=torch.bool)
        pre = {d: ld_int8.preprocess_int8(gd.to(d), ok.to(d), 0.01, n,
                                          assume_no_missing=clean)
               for d in (dev, cpu)}
        for k in (*ld_int8.SCAL_FIELDS, "maf", "rstd"):
            a, b = pre[dev][k].cpu().numpy(), pre[cpu][k].numpy()
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                raise RuntimeError(f"phase 32: the card's {tag} {k} at "
                                   f"N={n} differs from the CPU port's")
    say("32 kernels=twins", f"rows [{rows.start}, {rows.stop}) at N={n}: "
        f"K1 clean, K1 8-product and K2 ({n_miss} contaminated rows) "
        "against their twins on the card: counters equal, max abs diff "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + "; every per-SNP scalar (clean and with missing genotypes) "
        "bitwise the CPU port's")

    # K1 and K2 at width, on all M rows
    times = {}
    args, n_, _, _ = packed_inputs(torch, clean_copy(packed.raw, n), n,
                                   False, pos, wind, dev)
    m0 = torch.zeros_like(args[0])
    for name, has_missing, mm in (("K1 clean", False, args[1]),
                                  ("K1 8-product", True, m0)):
        T = ld_pallas_sym.tile(has_missing)
        ms = cuda_ms(torch, lambda mm=mm, h=has_missing, T=T:
                     ld_pallas_sym.sym_credits(
                         args[0], mm, *args[2:], RSQ, n_samples=n_,
                         has_missing=h, block_size=T), reps=3)
        lib = k1_products_library_ms(torch, (args[0], mm, *args[2:]),
                                     has_missing, T)
        times[name] = {"ms": ms, "library_products_ms": lib["ms"],
                       "library_calls": lib["calls"],
                       "library_stacked_ms": lib["stacked_ms"],
                       "library_stacked_extra": lib["stacked_ops"]
                       / lib["ops"],
                       "cluster": k1_cluster(torch, dev, has_missing,
                                             n_pad),
                       **k1_work(args[5], n_pad, has_missing, T)}
    del args, m0
    torch.cuda.empty_cache()
    args, n_, _, raw = packed_inputs(torch, packed.raw, n, True, pos, wind,
                                     dev, materialize_m=False)
    sargs = split_args(args, raw, n_)
    del raw
    times["K2"] = {"ms": cuda_ms(torch, lambda: ld_split.split_corrections(
        *sargs, n_samples=n_), reps=3), **k2_work(sargs)}
    del args, sargs
    torch.cuda.empty_cache()
    say("32 timing", f"M={m} N={n} (n_pad {n_pad}) +-1000 SNPs: " + "; ".join(
        f"{k} {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
        f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of it"
        + (f" ({t['cluster']}); torch._int_mm on its products "
           f"({t['library_calls']} calls, one a product of a pivot tile "
           f"and its band) {t['library_products_ms']:.3f} ms, stacked "
           f"over 1,024 pivot rows ({t['library_stacked_extra']:.2f}x the "
           f"products) {t['library_stacked_ms']:.3f} ms"
           if "cluster" in t else "")
        for k, t in times.items()) + f"; on {card}")
    if over:
        raise RuntimeError("phase 32: in-core peak above "
                           f"INCORE_BYTES_PER_GENOTYPE {limit}: {over}")
    return {"errs": errs, "times": times}


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
    from nldsc_tpu_torch.io.plink import PlinkDataset, write_plink
    from nldsc_tpu_torch.ld import ld_pallas_sym, ld_split
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

    # 2. build, one nvcc per source, all started together
    t0 = time.time()
    _build.build("ld_sym", "split_corr")
    for name in ("ld_sym", "split_corr"):
        info = _build.BUILD_INFO.get(name, {})
        log = info.get("log", "")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "entry" in ln
                 or "wgmma" in ln.lower()]
        say("2 build", f"{name}.cu built and loaded (nvcc "
            f"{info.get('seconds', 0.0):.2f} s); ptxas: " + " | ".join(ptxas))
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
        if not spills or any(spills):
            raise RuntimeError(f"{name}.cu: ptxas reports spills {spills}")
    say("2 build", f"both built and loaded in {time.time() - t0:.2f} s; "
        "0 spill bytes in every instantiation")

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
        args, n, has_missing, _ = engine_inputs(torch, g, pos, 100_000.0,
                                                dev)
        T = ld_pallas_sym.tile(has_missing)
        kern = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                         has_missing=has_missing,
                                         block_size=T)
        again = ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                          has_missing=has_missing,
                                          block_size=T)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(kern, again)):
            raise RuntimeError("two kernel runs differ")
        twin = twin_credits(args, n, has_missing, T)
        err = compare(finalized(kern, args), finalized(twin, args))
        errs.append(err)
        say("3 kernel=twin", f"M=4096 N=3001 missing={rate} ({T}-row "
            f"tiles): counters equal, max |l2,l2d| diff {err:.3g}, runs "
            "bitwise equal")
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
        # LD that varies along the chromosome, so that phase 11's L2 has
        # the spread the regression needs to identify h²
        g5 = synthetic_genotypes(rng, M5, N5, copy_rate=np.repeat(
            rng.uniform(0.3, 0.97, M5 // 512), 512))
        bp5 = np.arange(1, M5 + 1, dtype=np.int64) * 100
        prefix5 = write_plink(os.path.join(tmp, "chr_clean"), g5, bp=bp5)
        say("5 data", f"wrote {M5}x{N5} bfile "
            f"({os.path.getsize(prefix5 + '.bed') / 1e6:.0f} MB .bed) in "
            f"{time.time() - t0:.1f} s")
        out5 = os.path.join(tmp, "chr_clean.L2")
        counts5, wall = run_cli(prefix5, out5)
        n_launch = counts5["ld_sym"]
        stages = dict(STAGE_TIMES)
        check_outputs(out5, M5)
        # M >= 20,000 turns progress on: the pass runs in 16 segments
        if (n_launch != ld_pallas_sym.MAX_SEGMENTS
                or counts5["ld_sym_8prod"]):
            raise RuntimeError("the main path did not launch the clean "
                               f"kernel once per segment: {counts5}")
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
        counts6, wall6 = run_cli(prefix6, out6)
        n6 = counts6["ld_sym_8prod"]
        stages6 = dict(STAGE_TIMES)
        check_outputs(out6, M6)
        if n6 < 1 or counts6["split_corr"]:
            raise RuntimeError("the missing-data run did not take the global "
                               f"8-product route: {counts6}")
        say("6 ld missing", f"M={M6} N={N5} 2% missing: global route, "
            f"{n6} 8-product launch(es); "
            f"{wall6:.2f} s wall, {M6 / wall6:.0f} SNPs/s; stages "
            f"{ {k: round(v, 3) for k, v in sorted(stages6.items())} } "
            f"on {card}")
        del g6

        # 7. both branches of K1 at phase 5's shape, the twin, and the
        # card's int8 yardstick
        args, n, has_missing, _ = engine_inputs(
            torch, g5, bp5.astype(np.float64), 100_000.0, dev)
        Tc, Tm = ld_pallas_sym.TILE_CLEAN, ld_pallas_sym.TILE_MISSING
        if has_missing or n != args[0].shape[1]:
            raise RuntimeError("phase 7 needs clean genotypes with N = N_pad")
        # no genotype is missing and no sample is padding: with m = 0 the
        # 8-product branch gives every pair the clean branch's values
        m0 = torch.zeros_like(args[0])

        def kernel():
            return ld_pallas_sym.sym_credits(*args, RSQ, n_samples=n,
                                             has_missing=False,
                                             block_size=Tc)

        def kernel8():
            return ld_pallas_sym.sym_credits(args[0], m0, *args[2:], RSQ,
                                             n_samples=n, has_missing=True,
                                             block_size=Tm)

        twin = twin_credits(args, n, False, Tc)
        err5 = compare(finalized(kernel(), args), finalized(twin, args))
        err5m = compare(finalized(kernel8(), args), finalized(twin, args))
        del twin
        ms = cuda_ms(torch, kernel, reps=10)
        ms8 = cuda_ms(torch, kernel8, reps=5)
        # the twin's time at its fastest block (512 rows), one call after
        # the warm-up: it is seconds of plain torch ops, checked above
        plain_ms = cuda_ms(torch, lambda: twin_credits(args, n, False, 512),
                           reps=1)
        work = k1_work(args[5], args[0].shape[1], False, Tc)
        work8 = k1_work(args[5], args[0].shape[1], True, Tm)
        k1_line = {"ld_sym": (ms, work, False),
                   "ld_sym 8-product": (ms8, work8, True)}
        for name, (t, w, hm) in k1_line.items():
            say("7 timing", f"M={M5} N={N5} +-1000 SNPs, {name}: {t:.3f} ms "
                f"over {w['ctas']} tiles, {w['tile_ops'] / t / 1e9:.0f} "
                f"int8 TOPS in its tiles ({w['ops'] / t / 1e9:.0f} on the "
                f"{w['ops'] / 1e12:.3f} T ops of the in-window pairs); bound "
                f"{w['bound_ms']:.3f} ms ({w['bound_by']}), "
                f"{100 * w['bound_ms'] / t:.1f}% of it; "
                f"{k1_cluster(torch, dev, hm, N5)}; on {card}")
        say("7 timing", f"twin {plain_ms:.3f} ms (B=512); max |l2,l2d| "
            f"diff vs twin {err5:.3g} clean, "
            f"{err5m:.3g} 8-product (counters equal); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
        del args, m0
        a8 = torch.randint(-2, 3, (8192, 16384), dtype=torch.int8, device=dev)
        b8 = torch.randint(-2, 3, (8192, 16384), dtype=torch.int8, device=dev)
        ms_mm = cuda_ms(torch, lambda: torch._int_mm(a8, b8.t()), reps=20)
        say("7 yardstick", f"torch._int_mm (cuBLASLt) 8192x16384 . "
            f"16384x8192 int8: {ms_mm:.3f} ms, "
            f"{2.0 * 8192 * 16384 * 8192 / ms_mm / 1e9:.0f} TOPS; on {card}")
        del a8, b8
        torch.cuda.empty_cache()

        # 8. the split-missing kernels against their plain versions
        g = synthetic_genotypes(rng, 4096, 3001)
        inject_row_missing(rng, g, 0.05, 0.1)
        g[100:106] = adversarial_rows(rng, 3001)
        g[300] = -1
        pos = np.arange(1, 4097, dtype=np.float64) * 100
        pos[7] = -1.0
        args, n, _, raw = engine_inputs(torch, g, pos, 100_000.0, dev,
                                        materialize_m=False)
        sargs = split_args(args, raw, n)
        plan = sargs[-1]
        P = plan["p_band"]
        # K2's products mode: every segment's a, b and d in two launches
        a_k, b_k, d_k = ld_split.segment_products(*sargs[:3], plan)
        k2_err = 0
        for s_, *_, x, cat3, m_xc in ld_split.segments(*sargs[:3], plan):
            xi, ci, mi = (t.cpu().double() for t in (x, cat3, m_xc))
            refs = (xi @ ci.T, 2 * xi.clamp(max=1) @ ci[:2 * P].T, mi @ ci.T)
            for o, r in zip((a_k[s_], b_k[s_], d_k[s_]), refs):
                k2_err = max(k2_err, int((o.cpu().long() - r.long()).abs()
                                         .max()))
        if k2_err:
            raise RuntimeError(f"K2 products differ by up to {k2_err}")
        del a_k, b_k, d_k
        reset_counts()
        kern = ld_split.split_corrections(*sargs, n_samples=n)
        c_corr = launch_counts()
        again = ld_split.split_corrections(*sargs, n_samples=n)
        torch.cuda.synchronize()
        if (c_corr["split_corr"], c_corr["split_fused"]) != (2, 1):
            raise RuntimeError(f"split_corrections launched {c_corr}")
        if not all(torch.equal(a, b) for a, b in zip(kern, again)):
            raise RuntimeError("two split_corrections runs differ")
        cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                         for a in sargs)
        err8 = compare_deltas(kern, ld_split.split_corrections_plain(
            *cpu_args, n_samples=n))
        say("8 K2=plain", f"M=4096 N=3001, {plan['n_miss']} contaminated "
            f"rows, P={P}, p_x={plan['p_x']}, {plan['n_segs']} segment(s): "
            "products mode: a, b, d exactly equal to the integer products; "
            "fused corrections (1 products + 1 fused launch) vs twin: wse "
            f"equal, max |l2,l2d| diff {err8:.3g}, runs bitwise equal")
        cfg8 = LDConfig(ld_wind=100_000.0, maf_thr=0.01, std_thr=1e-4,
                        rsq_thr=RSQ)
        reset_counts()
        res_split = compute_ld_scores(g, pos, cfg8, device="cuda")
        c_split = launch_counts()
        reset_counts()
        res_glob = compute_ld_scores(
            g, pos, dataclasses.replace(cfg8, split_missing=False),
            device="cuda")
        c_glob = launch_counts()
        if not (c_split["split_fused"] and not c_split["ld_sym_8prod"]
                and c_glob["ld_sym_8prod"] and not c_glob["split_corr"]):
            raise RuntimeError(f"wrong routes: split {c_split}, "
                               f"global {c_glob}")
        err8r = compare_results(res_split, res_glob)
        say("8 split=global", f"compute_ld_scores at M=4096: split route "
            f"(launches {c_split}) vs global route (launches {c_glob}): "
            f"counters equal, max |l2,l2d| diff {err8r:.3g}")
        x = torch.randn(1 << 22, device=dev) * 1000.0
        q_scalar = x / float(n)
        q_true = x / torch.full_like(x, float(n))
        say("8 division probe", f"x / {n}.0 (Python scalar) differs from "
            f"true division (tensor divisor) in "
            f"{int((q_scalar != q_true).sum())} of {x.numel()} f32 values "
            "on the card; the tensor divisor differs from the CPU's "
            f"x / {n}.0 in {int((q_true.cpu() != x.cpu() / float(n)).sum())}")
        del args, sargs, raw, kern, again, x, q_scalar, q_true

        # 9. the split route through the ld command, chromosome shape
        inject_row_missing(rng, g5, 0.05, 0.02)
        t0 = time.time()
        prefix9 = write_plink(os.path.join(tmp, "chr_split"), g5, bp=bp5)
        say("9 data", f"phase 5's genotypes, 2% missing in 5% of the rows: "
            f"wrote the bfile in {time.time() - t0:.1f} s")
        out9 = os.path.join(tmp, "chr_split.L2")
        counts9, wall9 = run_cli(prefix9, out9)
        stages9 = dict(STAGE_TIMES)
        check_outputs(out9, M5)
        if (counts9["ld_sym"] != ld_pallas_sym.MAX_SEGMENTS
                or counts9["split_corr"] != 2 or counts9["split_fused"] != 1
                or counts9["ld_sym_8prod"]):
            raise RuntimeError(f"the ld run did not take the split route: "
                               f"{counts9}")
        launches["split_corr"] = counts9["split_corr"]
        say("9 ld split", f"M={M5} N={N5} -kb 100, 5% contaminated rows: "
            f"launches {counts9}; {wall9:.2f} s wall, {M5 / wall9:.0f} "
            f"SNPs/s; stages "
            f"{ {k: round(v, 3) for k, v in sorted(stages9.items())} } "
            f"on {card}")

        # 10. the split route's kernels and routes at that shape
        args, n, _, raw = engine_inputs(torch, g5, bp5.astype(np.float64),
                                        100_000.0, dev, materialize_m=False)
        del g5
        sargs = split_args(args, raw, n)
        plan = sargs[-1]
        t10 = split_timing(torch, args, sargs, raw, n)
        for tag, msg in split_report(t10, plan, f"M={M5} N={N5} +-1000 SNPs",
                                     card):
            say(tag, msg)
        err10, work2 = t10["err"], t10["work"]
        del args, sargs, raw
        torch.cuda.empty_cache()

        ds9 = PlinkDataset.parse(prefix9)
        packed, pos9 = ds9.bed.read_raw(), ds9.positions("bp")
        cfg10 = LDConfig(ld_wind=100_000.0, maf_thr=0.01, std_thr=1e-4,
                         rsq_thr=1.0 / M5)
        runs = {}
        for route, flag in (("split", None), ("global", False)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.time()
            res = compute_ld_scores(
                packed, pos9, dataclasses.replace(cfg10, split_missing=flag),
                device="cuda")
            torch.cuda.synchronize()
            runs[route] = (res, time.time() - t0,
                           (torch.cuda.max_memory_allocated() - base) / 2**30)
        err10r = compare_results(runs["split"][0], runs["global"][0])
        say("10 routes", "compute_ld_scores on the phase 9 bfile: split "
            f"{runs['split'][1]:.3f} s, peak {runs['split'][2]:.2f} GiB; "
            f"global {runs['global'][1]:.3f} s, peak "
            f"{runs['global'][2]:.2f} GiB; counters equal, max |l2,l2d| "
            f"diff {err10r:.3g}; on {card}")
        if runs["split"][2] >= runs["global"][2]:
            raise RuntimeError("the split route's peak device memory is not "
                               "below the global route's")

        # 11-12. h2 at full width on phase 5's LD scores
        h2_phases(torch, tmp, out5, rng, card)

        # 13-16. streaming, resume and ld-genome on phases 5 and 9
        torch.cuda.empty_cache()
        streamed = streaming_phases(torch, tmp, prefix5, out5, prefix9, out9,
                                    M5, card)

        # 17-19. partitioned LD scores: the annotation epilogues
        torch.cuda.empty_cache()
        errs_a = annot_kernel_phase(torch, rng, dev)
        annot_golden_phase(torch, tmp)
        annot19 = annot_full_width(torch, tmp, prefix5, out5, prefix6,
                                   prefix9, M5, rng, dev, card)

        # 20-22. bf16 operands and the f32 engine
        torch.cuda.empty_cache()
        bf16 = bf16_kernel_phase(torch, prefix5, prefix9, M5, rng, dev, card)
        bf16_launches = bf16_cli_phase(torch, tmp, prefix5, out5, prefix6,
                                       out6, prefix9, out9, card)
        torch.cuda.empty_cache()
        f32 = f32_phase(torch, tmp, prefix5, M5, dev, card)

        # 23-25. the full-band streaming engines, compat, the profiler
        torch.cuda.empty_cache()
        full_band_phase(torch, tmp, prefix5, prefix9, M5, dev, card, f32,
                        annot19["path"])
        del f32
        torch.cuda.empty_cache()
        compat_phase(torch, prefix5, M5, card)
        profile_phase(torch, tmp, prefix5, out5, card)

        # 26-27. multi-device: in core on each axis, and the streaming rings
        torch.cuda.empty_cache()
        multi = multi_device_phase(torch, tmp, prefix5, out5, prefix9,
                                   annot19["path"], M5, card)
        ring = multi_stream_phase(torch, tmp, prefix9,
                                  os.path.join(tmp, "stream_split.L2"), M5,
                                  card)

        # 28-29. progress in segments; one chromosome across processes
        torch.cuda.empty_cache()
        prog = progress_phase(torch, tmp, prefix5, out5, M5, card)
        ranks = multiprocess_phase(torch, tmp, prefix5, out5, prefix9, out9,
                                   annot19["path"], card)

        # 30. the per-SNP scalars' square roots on the CPU (F4)
        numerics_phase(torch, tmp, dev, card)

        # 31. F2: the card's epilogue and scalars against the CPU port's
        xla_f32_phase(torch, tmp, dev, card, {
            "K1 clean": ms, "K1 8-product": ms8, "K2": t10["ms_k2"]})

        # 32. UK Biobank width: N = 315,599
        torch.cuda.empty_cache()
        wide = wide_phase(torch, tmp, dev, card)
        wt, we = wide["times"], wide["errs"]

    bad = sorted({k.split(".")[0] for k in sys.modules}
                 & {"jax", "nldsc_tpu", "pandas"})
    if bad:
        raise RuntimeError(f"the port imported {bad}")
    print(json.dumps({"kernels": [{
        "name": "ld_sym", "route": "cuda",
        "source": "nldsc_tpu_torch/csrc/ld_sym.cu",
        "replaces": "nldsc_tpu/ld/ld_pallas_sym.py:52",
        "launches": launches["ld_sym"],
        "launches_stream_clean": streamed["13"]["ld_sym"],
        "launches_stream_split": streamed["14"]["ld_sym"],
        "launches_sharded": multi["launches"],
        "launches_ring": ring["ld_sym"],
        "launches_progress": prog["launches"],
        "launches_multiprocess": ranks,
        "ms_sharded": multi["k1_ms"], "ms_progress": prog["k1_ms"],
        "max_abs_err": max(errs + [err5, err5m, we["K1 clean"],
                                   we["K1 8-product"]]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
        "bound_by": work["bound_by"], "library_ms": None,
        "tops": work["tile_ops"] / ms / 1e9, "ms_8prod": ms8,
        "bound_ms_8prod": work8["bound_ms"],
        "tops_8prod": work8["tile_ops"] / ms8 / 1e9,
        "ms_wide": wt["K1 clean"]["ms"],
        "bound_ms_wide": wt["K1 clean"]["bound_ms"],
        "ms_8prod_wide": wt["K1 8-product"]["ms"],
        "bound_ms_8prod_wide": wt["K1 8-product"]["bound_ms"],
        "library_products_ms_wide": wt["K1 clean"]["library_products_ms"],
        "library_products_ms_8prod_wide":
            wt["K1 8-product"]["library_products_ms"],
        "library_stacked_ms_wide": wt["K1 clean"]["library_stacked_ms"],
        "library_stacked_ms_8prod_wide":
            wt["K1 8-product"]["library_stacked_ms"],
        "cluster": list(ld_pallas_sym.CLUSTER),
        "cluster_min_stages": ld_pallas_sym.CLUSTER_MIN_STAGES[False],
        "cluster_min_stages_8prod": ld_pallas_sym.CLUSTER_MIN_STAGES[True],
        "max_active_clusters": ld_pallas_sym.max_active_clusters(
            dev, False, False, False)}, {
        "name": "split_corr", "route": "cuda",
        "source": "nldsc_tpu_torch/csrc/split_corr.cu",
        "replaces": "scripts/pallas_corr_probe.py:54",
        "launches": launches["split_corr"],
        "launches_stream_clean": streamed["13"]["split_corr"],
        "launches_stream_split": streamed["14"]["split_corr"],
        "launches_ring": ring["split_corr"],
        "max_abs_err": max(err8, err10, float(k2_err), we["K2"]),
        "ms": t10["ms_corr"], "plain_ms": t10["ms_corr_plain"],
        "bound_ms": work2["bound_ms"], "bound_by": work2["bound_by"],
        "library_ms": t10["ms_library"], "ms_products": t10["ms_products"],
        "ms_kernels": t10["ms_k2"],
        "tops": (work2["tile_ops"] / t10["ms_k2"] / 1e9 if t10["ms_k2"]
                 else None),
        "bound_ms_old": work2["old_k2_ms"] + work2["old_delta_ms"],
        "ms_wide": wt["K2"]["ms"], "bound_ms_wide": wt["K2"]["bound_ms"]}] + [{
        "name": name, "route": "cuda",
        "source": f"nldsc_tpu_torch/csrc/{src}.cu", "replaces": replaces,
        "launches": annot19["launches"][name],
        "launches_streamed": annot19["launches_streamed"][name],
        "max_abs_err": annot19[name]["max_abs_err"],
        "max_abs_err_p5": errs_a[name], "ms": annot19[name]["ms"],
        "plain_ms": annot19[name]["plain_ms"],
        "bound_ms": annot19[name]["bound_ms"],
        "bound_by": annot19[name]["bound_by"],
        "library_ms": annot19[name].get("library_ms"),
        **{k: annot19[name][k] for k in ("epilogue_ms", "peak_gib", "p97",
                                          "live_tiles", "device")
           if k in annot19[name]}}
        for name, src, replaces in (
            ("ld_sym annot", "ld_sym", "nldsc_tpu/ld/ld_pallas_sym.py:52"),
            ("ld_sym annot 8-product", "ld_sym",
             "nldsc_tpu/ld/ld_pallas_sym.py:52"),
            ("split_corr annot", "split_corr",
             "scripts/pallas_corr_probe.py:54"),
            ("split_tile_reach", "split_corr",
             "scripts/pallas_corr_probe.py:54"),
            ("split_annot_fold", "split_corr",
             "scripts/pallas_corr_probe.py:54"))] + [{
        "name": name, "route": "cuda",
        "source": f"nldsc_tpu_torch/csrc/{name.split()[0]}.cu",
        "replaces": ("nldsc_tpu/ld/ld_pallas_sym.py:52"
                     if name.startswith("ld_sym")
                     else "scripts/pallas_corr_probe.py:54"),
        "launches": bf16_launches[name],
        **{k: bf16[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "int8_ms")}}
        for name in ("ld_sym bf16", "ld_sym bf16 8-product",
                     "ld_sym bf16 annot", "ld_sym bf16 annot 8-product",
                     "split_corr bf16", "split_corr bf16 annot")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--scalars-worker"]:
        sys.exit(scalars_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
