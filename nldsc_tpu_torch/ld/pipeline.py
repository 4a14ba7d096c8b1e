"""End-to-end LD-score estimation (the ``ld`` command) on one device, in
core (here) or streaming (``streaming.py``), plain or partitioned by an
annotation matrix (``--annot``).

  host:   parse .bim/.fam -> window bounds (exact f64 -> index intervals)
          -> read the packed .bed rows
  device: unpack the 2-bit codes -> class counts and per-SNP scalars
          -> symmetric banded pass (the CUDA kernels on a GPU, their
          plain twins on the CPU) -> NaN/-1 sentinel finalization
  host:   .L2 TSV + .M/.M_5_50

Routes, as in ``nldsc_tpu``: ``clean`` (no counted pair touches a missing
genotype: the 3-product pass), ``split`` (at most 25% of the usable rows
contaminated, or ``split_missing=True``: the clean pass plus exact
compact corrections, ``ld_split.py``) and ``global`` (the 8-product
pass).  Engines: the symmetric one on every route (kernels K1 and K2
on a GPU, with their annotation epilogues when ``annot`` is given), or
the full-band torch engine ``ld_int8.ld_scores_int8`` (``--no-symmetric``;
the default of clean partitioned runs on the CPU, as in ``nldsc_tpu``);
their products on int8 operands or, with ``--dot-dtype bf16``, on bf16
ones (the same exact sums).  ``--engine f32`` (``use_int8=False``) runs
the f32 engine of ``ld_xla.py`` instead: standardized float32 rows,
symmetric or full band in core, and full band with ``annot`` or streamed.
The streaming route (``streaming.py``) runs the symmetric engine, or the
full band with ``--no-symmetric`` and the f32 engine, as the reference
does.  ``profile_dir`` traces the compute pass with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..config import LDConfig
from ..core.errors import NLDSCParameterError
from ..core.logging import log
from ..core import timing
from ..core.timing import STAGE_TIMES, elapsed_time, span, stage_add
from ..io.ldscores import (make_output, make_output_annot, read_annot,
                           write_l2, write_m_files, write_m_files_annot)
from ..io.plink import PackedBed, PlinkDataset
from . import ld_int8, ld_pallas_sym, ld_split, ld_xla, preprocess, windows
from .ld_xla import finalize_outputs


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (no silent
    fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NLDSCParameterError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass --device cpu to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise NLDSCParameterError(f"unsupported device {device!r}")
    return dev


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    pad_shape = (size - x.shape[0],) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)], axis=0)


def padded_shape(m: int, n: int, device_type: str,
                 block_size: int) -> tuple[int, int]:
    """``(m_pad, n_pad)`` of the engine's inputs: the rows padded to the
    kernel's row alignment on CUDA (a multiple of both of its branch
    tiles: the route is chosen after the padding) or to ``block_size``
    for the CPU twin and for the engines in torch ops (the full-band and
    f32 engines, which walk pivot blocks of ``block_size`` rows on any
    device: pass ``"cpu"``), the samples to a multiple of 128."""
    B = ld_pallas_sym.ROW_ALIGN if device_type == "cuda" else block_size
    return -(-m // B) * B, -(-n // 128) * 128


def incore_route(rowmiss: np.ndarray, m: int, block_size: int,
                 split_missing: bool | None) -> tuple[str, float]:
    """The in-core route of genotypes with missing data, and the fraction
    of contaminated rows it was chosen on, as the reference chooses them
    (``nldsc_tpu/ld/pipeline.py:284-294``).

    ``rowmiss`` flags the usable rows that carry a missing genotype (its
    padding rows are False).  ``clean`` when no usable row is
    contaminated: no counted pair touches missing data, so the clean
    epilogue is exact.  Otherwise ``split`` when ``split_missing``, or
    when it is None and at most 25% of the rows are contaminated, else
    ``global``.  The fraction's denominator is the reference's padded row
    count, ``ceil(m / block_size) · block_size``, on every device (the
    CUDA path pads its rows to the kernel's alignment instead).
    """
    n_cont = int(np.count_nonzero(rowmiss))
    frac = n_cont / (-(-m // block_size) * block_size)
    if not n_cont:
        return "clean", frac
    want = split_missing if split_missing is not None else frac <= 0.25
    return ("split" if want else "global"), frac


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    with span("ld.transfer"):
        t0 = time.time()
        out = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stage_add("transfer_s", t0)
    return out


def to_host_result(l2, l2d, ws, wsd, wse, maf, rstd, m: int,
                   annot=None) -> dict:
    """Assemble the reference ``LDScoreResult`` fields on host (first m
    rows), with ``annot`` = ``(l2_annot, l2d_annot)`` also those: every
    output fetched first (span ``ld.fetch``), then each converted to
    float64 or int64 (``ld.to_float64``)."""
    fields = {"l2": l2, "l2d": l2d, "maf": maf, "residuals_std": rstd,
              "l2_ws": ws, "l2d_ws": wsd, "l2d_wse": wse}
    if annot is not None:
        fields["l2_annot"], fields["l2d_annot"] = annot
    with span("ld.fetch"):
        fetched = {k: x[:m].cpu() for k, x in fields.items()}
    with span("ld.to_float64"):
        return {k: x.numpy().astype(np.int64 if k in ("l2_ws", "l2d_ws",
                                                      "l2d_wse")
                                    else np.float64)
                for k, x in fetched.items()}


def resolve_symmetric(symmetric: bool | None, annot, has_missing: bool,
                      device_type: str) -> bool:
    """The engine of an in-core run: ``symmetric`` when given.  Otherwise
    on CUDA always the symmetric engine, whose kernels carry the
    annotation epilogues; on the CPU the reference's choice, so that both
    packages run like engines there: symmetric, except full-band for clean
    partitioned data (``nldsc_tpu/ld/pipeline.py:226-231``)."""
    if symmetric is not None:
        return symmetric
    return annot is None or device_type == "cuda" or has_missing


def _f32_pass(g_dev, pos_ok, lo: np.ndarray, hi: np.ndarray, lo_dev,
              hi_dev, config: LDConfig, a_dev, n: int, symmetric: bool,
              progress, m: int) -> dict:
    """The f32 engine on the padded int8 codes ``g_dev`` (sample padding
    missing): ``preprocess_block``, then ``ld_xla``'s symmetric or
    full-band pass, or its partitioned pass (full band) with ``a_dev``
    (``nldsc_tpu/ld/pipeline.py:396-437``), as one span (``ld.pass``)."""
    B = config.block_size
    m_pad = g_dev.shape[0]
    with span("ld.pass"):
        pre = preprocess.preprocess_block(g_dev, pos_ok, config.maf_thr, n)
        dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(config.std_thr))
        blk_lo, blk_hi, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
        args = (pre.pop("add"), pre.pop("res"), lo_dev, hi_dev,
                pre["usable"], dom_ok, pre["add_sd_zero"], blk_lo, blk_hi,
                config.rsq_thr)
        kw = dict(block_size=B, band_k=band_k, n_samples=n)
        log.info("LD route: f32 engine, %s%s",
                 "symmetric" if symmetric and a_dev is None else "full band",
                 "" if a_dev is None else f", {a_dev.shape[1]} annotations")
        if config.matmul_precision == "high":
            log.info("matmul_precision 'high' (the TPU's bf16_3x pass): the "
                     "f32 engine runs full float32 products, as for "
                     "'highest'")
        if progress is not None:
            progress(0, m)
        annot_out = None
        if a_dev is not None:
            l2_a, l2d_a, *fin = ld_xla.ld_scores_xla_annot(*args, a_dev,
                                                           **kw)
            annot_out = (l2_a, l2d_a)
        elif symmetric:
            fin = ld_xla.ld_scores_xla_sym(
                *args, right_k=windows.right_band_blocks(blk_hi, B), **kw)
        else:
            fin = ld_xla.ld_scores_xla(*args, **kw)
    out = to_host_result(*fin, pre["maf"], pre["rstd"], m, annot_out)
    if progress is not None:
        progress(m, m)
    return out


def compute_ld_scores(genotypes, positions: np.ndarray, config: LDConfig, *,
                      annot: np.ndarray | None = None, device="cuda",
                      progress=None) -> dict:
    """LD scores for an in-core genotype matrix.

    Parameters
    ----------
    genotypes : int8 (M, N) codes {0,1,2,-1}, or a
        :class:`~nldsc_tpu_torch.io.plink.PackedBed` of un-decoded 2-bit
        rows, unpacked on the device.
    positions : float64 (M,); negative = skip sentinel
    config : LDConfig with ``rsq_thr`` resolved
    annot : optional (M, p) annotation matrix: partitioned LD scores
    device : 'cuda' (the kernels) or 'cpu' (the plain twins)
    progress : optional callable ``progress(done_rows, total_rows)``.
        The symmetric integer pass then runs in up to 16 segments and
        ticks after each, once the device has finished it, as the
        reference does (``ld_pallas_sym.sym_credits_segmented``; one
        block: no tick); the other engines tick before and after.

    Returns
    -------
    dict of host float64/int64 arrays: l2, l2d, maf, residuals_std,
    l2_ws, l2d_ws, l2d_wse — the reference ``LDScoreResult`` fields; with
    ``annot`` also l2_annot and l2d_annot, float64 (M, p).
    """
    if config.rsq_thr is None:
        raise NLDSCParameterError("resolve rsq_thr first (LDConfig.resolve_rsq)")
    dev = resolve_device(device)
    with span("ld.call", root=True, device=dev):
        return _compute_ld_scores(genotypes, positions, config, annot, dev,
                                  progress)


def _compute_ld_scores(genotypes, positions: np.ndarray, config: LDConfig,
                       annot, dev: torch.device, progress) -> dict:
    """:func:`compute_ld_scores` on the resolved device, in the spans of
    ``core.timing``: ``ld.windows``, ``ld.transfer``, ``ld.unpack``,
    ``ld.annot_prep``, ``ld.preprocess``, ``ld.route``, ``ld.operands``,
    ``ld.k2``, ``ld.k1``, ``ld.finalize`` (the full-band and f32 engines:
    one ``ld.pass``), ``ld.fetch`` and ``ld.to_float64``, with the
    windows' and K2's counters (:func:`_counters`)."""
    packed = isinstance(genotypes, PackedBed)
    m, n = genotypes.shape
    use_int8 = config.use_int8 is not False
    # only real missing genotypes force the 8-product branch; without
    # them pad with zeros and let g alias m.  The f32 engine imputes the
    # padding, so it always pads with missing codes.
    has_missing = (genotypes.has_missing if packed
                   else bool((genotypes < 0).any()))
    pad_val = -1 if has_missing or not use_int8 else 0
    if use_int8:
        symmetric = resolve_symmetric(config.symmetric, annot, has_missing,
                                      dev.type)
        if config.use_pallas and not symmetric:
            raise NLDSCParameterError(
                "--engine pallas is the symmetric kernel; drop "
                "--no-symmetric")
    else:
        # the f32 partitioned engine exists full band only
        symmetric = annot is None and config.symmetric is not False
        if config.use_pallas and annot is None:
            raise NLDSCParameterError(
                "--engine pallas runs the integer kernels; the f32 engine "
                "has no Pallas or CUDA kernel (drop --engine pallas, or use "
                "--engine f32 alone)")
    # the engines in torch ops walk pivot blocks of block_size rows
    kernels = use_int8 and symmetric
    m_pad, n_pad = padded_shape(m, n, dev.type if kernels else "cpu",
                                config.block_size)
    if use_int8:
        ld_int8.check_dot_dtype(config.int8_dot_dtype, n_pad)
    if annot is not None and (annot.ndim != 2 or annot.shape[0] != m
                              or annot.shape[1] < 1):
        raise NLDSCParameterError(
            f"annot must be ({m}, p >= 1), got {annot.shape}")

    with span("ld.windows"):
        lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
        pos_ok_pad = _pad_to(pos_ok, m_pad, False)
        # an empty window for each padding row
        lo_pad = _pad_to(lo, m_pad, np.int32(m_pad))
        hi_pad = _pad_to(hi, m_pad, np.int32(-1))

    if packed:
        # pad rows in byte space (0x55 = four missing bitpairs, 0x00 =
        # four zero codes); columns are padded inside the unpack
        pad_byte = np.uint8(0x55) if pad_val == -1 else np.uint8(0x00)
        raw_dev = _to_device(_pad_to(genotypes.raw, m_pad, pad_byte), dev)
        t_dev = time.time()
        with span("ld.unpack"):
            g_dev = preprocess.unpack_bed(raw_dev, n_samples=n, n_pad=n_pad,
                                          pad_val=pad_val)
        del raw_dev
    else:
        g = np.full((m_pad, n_pad), pad_val, dtype=np.int8)
        g[:m, :n] = genotypes
        g_dev = _to_device(g, dev)
        t_dev = time.time()

    lo_dev = torch.from_numpy(lo_pad).to(dev)
    hi_dev = torch.from_numpy(hi_pad).to(dev)
    a_dev = None
    if annot is not None:
        # zero rows for the padding, float32, sent once
        with span("ld.annot_prep"):
            a_host = _pad_to(np.ascontiguousarray(annot, dtype=np.float32),
                             m_pad, np.float32(0.0))
        a_dev = _to_device(a_host, dev)
        del a_host
    if not use_int8:
        out = _f32_pass(g_dev, torch.from_numpy(pos_ok_pad).to(dev), lo, hi,
                        lo_dev, hi_dev, config, a_dev, n, symmetric,
                        progress, m)
        stage_add("device_s", t_dev)
        return out

    # the split route reads the missing indicators only through the
    # contaminated rows, and the global route decides it needs all of them
    # only after the per-row missing counts: defer the full m to that
    lazy_m = has_missing and symmetric and not config.use_pallas
    with span("ld.preprocess"):
        pre = ld_int8.preprocess_int8(
            g_dev, torch.from_numpy(pos_ok_pad).to(dev), config.maf_thr,
            n_samples=n, assume_no_missing=not has_missing,
            materialize_m=not lazy_m)
        dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(config.std_thr))
        scal = ld_int8.stack_scalars(pre)

    # the products' operands, taken out of pre so that under bf16 each
    # int8 matrix is freed once its bf16 copy exists
    route, split = "global" if has_missing else "clean", None
    ops = {"g": pre.pop("g"), "m": pre.pop("m"), "h": pre.pop("h")}
    if lazy_m:
        with span("ld.route"):
            rowmiss = (pre["cm"] > float(n_pad - n)) & pre["usable"]
            rowmiss_h = rowmiss.cpu().numpy()
            route, frac = incore_route(rowmiss_h, m, config.block_size,
                                       config.split_missing)
            if route == "split":
                plan = ld_split.plan_split_v2(
                    rowmiss_h, lo_pad, hi_pad,
                    min(ld_split.SEG_ROWS_DEFAULT, m_pad), m_pad)
                log.info("Split-missing engine: %.2f%% contaminated rows "
                         "(P=%d, Px=%d, %d segments)", 100.0 * frac,
                         plan["p_band"], plan["p_x"], plan["n_segs"])
                split = (rowmiss, plan)
    dot_dtype = config.int8_dot_dtype
    with span("ld.operands"):
        if split is not None:
            ops["m_c"] = ld_split.compact_missing_rows(g_dev,
                                                       split[1]["miss_idx"])
        elif lazy_m and route == "global":
            ops["m"] = ld_int8.materialize_missing(g_dev)
        del g_dev                  # the raw codes are not read past here
        ld_int8.to_operands(ops, dot_dtype)
    log.info("LD route: %s%s%s%s", route,
             "" if symmetric else ", full-band engine",
             "" if dot_dtype == "int8" else f", {dot_dtype} operands",
             "" if annot is None else f", {annot.shape[1]} annotations")

    annot_out = None
    if symmetric:
        deltas = ()
        if split is not None:
            # dispatched before the pass, so that its ticks cover both
            rowmiss, plan = split
            with span("ld.k2"):
                deltas = ld_split.split_corrections(
                    ops["g"], ops["m_c"], ops["h"], scal, lo_dev, hi_dev,
                    pre["usable"], dom_ok, rowmiss, config.rsq_thr, m_pad,
                    plan, a_dev, n_samples=n)
        timing.defer(lambda: _counters(
            lo_dev, hi_dev, m, None if split is None else split[1]))
        with span("ld.k1"):
            accs = list(ld_pallas_sym.sym_credits_segmented(
                ops["g"], ops["m"], ops["h"], scal, lo_dev, hi_dev,
                pre["usable"], dom_ok, pre["add_sd_zero"], config.rsq_thr,
                n_samples=n, has_missing=route == "global",
                block_size=config.block_size, n_rows=m, progress=progress,
                annot=a_dev))
        with span("ld.finalize"):
            # δ-credits of (l2, l2d, wse[, l2_annot, l2d_annot])
            for at, delta in zip((0, 3, 5, 6, 7), deltas):
                accs[at] = accs[at] + delta
            l2_c, ws_c, poi_c, l2d_c, wsd_c, wse_c = accs[:6]
            l2, l2d, ws, wsd, wse = finalize_outputs(
                l2_c, l2d_c, ws_c, wsd_c, wse_c, poi_c, pre["usable"],
                pre["add_sd_zero"])
            if a_dev is not None:
                annot_out = ld_int8.finalize_annot(
                    accs[6], accs[7], a_dev, pre["usable"],
                    pre["add_sd_zero"], poi_c, wsd_c)
    else:
        if progress is not None:
            progress(0, m)
        with span("ld.pass"):
            blk_lo, blk_hi, band_k = windows.band_blocks(
                lo, hi, config.block_size, m_pad // config.block_size)
            fin = ld_int8.ld_scores_int8(
                ops["g"], ops["m"], ops["h"], scal, lo_dev, hi_dev,
                pre["usable"], dom_ok, pre["add_sd_zero"], blk_lo, blk_hi,
                config.rsq_thr, a_dev, block_size=config.block_size,
                band_k=band_k, n_samples=n, has_missing=has_missing,
                dot_dtype=dot_dtype)
        l2, l2d, ws, wsd, wse = fin[-5:]
        if a_dev is not None:
            annot_out = fin[:2]
    out = to_host_result(l2, l2d, ws, wsd, wse, pre["maf"], pre["rstd"], m,
                         annot_out)
    if progress is not None and not symmetric:
        progress(m, m)
    stage_add("device_s", t_dev)
    return out


def _counters(lo: torch.Tensor, hi: torch.Tensor, m: int, plan) -> dict:
    """The symmetric pass's counters that the host can work out, run
    after the call (:func:`timing.defer`) on the call's windows ``lo``,
    ``hi`` (padded, on its device: the call keeps no host copy for them):
    ``k1.window_pairs``, the pairs (i, j) with i <= j <= hi[i] of the
    real rows; with the split route's ``plan`` also K2's contaminated
    rows, compact width after padding, and the tiles of its fused launch
    and those that compute (:func:`ld_split.tile_counts`).  K1's
    ``k1.tile_pairs`` its launcher counts."""
    out = {"k1.window_pairs": windows.window_pairs(hi.cpu().numpy(), m)}
    if plan is not None:
        out["k2.tiles"], out["k2.live_tiles"] = ld_split.tile_counts(
            plan, lo, hi)
        out["k2.contaminated_rows"] = plan["n_miss"]
        out["k2.compact_cols"] = len(plan["miss_idx"])
    return out


def compute_ld_scores_annot(genotypes, positions: np.ndarray,
                            annot: np.ndarray, config: LDConfig, *,
                            device="cuda") -> dict:
    """Partitioned LD scores: :func:`compute_ld_scores` with ``annot``
    (the reference's name for it, kept for API parity)."""
    return compute_ld_scores(genotypes, positions, config, annot=annot,
                             device=device)


def show_summary(result: dict) -> str:
    """Post-run sanity summary (reference show_summary, routine.py:15-29):
    the L2/L2D/MAF correlation matrix over rows where all three are set,
    non-null counts and per-column statistics."""
    cols = {"L2": result["l2"], "L2D": result["l2d"], "MAF": result["maf"]}
    data = np.stack([np.asarray(v, dtype=np.float64) for v in cols.values()])
    names = list(cols)
    lines = ["=" * 62, "L2/L2D/MAF Correlation matrix",
             "      " + "".join(f"{k:>12}" for k in names)]
    for i, a in enumerate(names):
        row = []
        for j in range(len(names)):
            ok = ~np.isnan(data[i]) & ~np.isnan(data[j])
            with np.errstate(invalid="ignore", divide="ignore"):
                c = (np.corrcoef(data[i][ok], data[j][ok])[0, 1]
                     if ok.sum() > 1 else np.nan)
            row.append(f"{c:>12.6f}")
        lines.append(f"{a:<6}" + "".join(row))
    lines += ["", "Short summary:",
              f"- Number of additive non-null LD: {int((~np.isnan(data[0])).sum())}",
              f"- Number of non-additive non-null LD: "
              f"{int((~np.isnan(data[1])).sum())}",
              "      " + "".join(f"{k:>12}" for k in names)]
    stats = {"mean": np.nanmean, "std": lambda v: np.nanstd(v, ddof=1),
             "min": np.nanmin, "25%": lambda v: np.nanpercentile(v, 25),
             "50%": np.nanmedian, "75%": lambda v: np.nanpercentile(v, 75),
             "max": np.nanmax}
    for label, fn in stats.items():
        vals = []
        for v in data:
            with np.errstate(invalid="ignore"):
                vals.append(fn(v) if (~np.isnan(v)).sum() > 1 else np.nan)
        lines.append(f"{label:<6}" + "".join(f"{x:>12.6f}" for x in vals))
    lines.append("=" * 62)
    text = "\n".join(lines)
    print(text)
    return text


#: the reference's auto-streaming threshold of the dense working set, in
#: bytes (``nldsc_tpu/ld/pipeline.py:471``), kept on the CPU so that the
#: CPU chooses as the JAX package does
STREAMING_BYTES_THRESHOLD = 8 << 30
#: device bytes per padded genotype of the in-core routes at their peak on
#: the H100, per engine, rounded up (PERF.md section 5): the global route's
#: 4.006 (int8) and 7.006 (bf16) at 65,536 x 16,384 genotypes
#: (chip_smoke.py phase 21; the clean and split routes peak below them),
#: the f32 engine's 9.908 (phase 22; add and res are 8 bytes)
INCORE_BYTES_PER_GENOTYPE = {"int8": 4.01, "bf16": 7.01, "f32": 9.91}


def wants_streaming(m: int, n: int, device: torch.device,
                    engine: str = "int8") -> bool:
    """Whether ``estimate_lds(streaming=None)`` streams: on the CPU the
    reference's rule (3 bytes per padded genotype for the integer engines
    and 8 for the f32 one, above 8 GiB, ``nldsc_tpu/ld/pipeline.py:583-588``);
    on CUDA when the in-core peak of ``engine`` (``'int8'``, ``'bf16'``
    or ``'f32'``) would pass 90% of the device's free memory."""
    genotypes = m * (-(-n // 128) * 128)
    if device.type == "cpu":
        bpe = 8 if engine == "f32" else 3
        return bpe * genotypes > STREAMING_BYTES_THRESHOLD
    free, _ = torch.cuda.mem_get_info(device)
    return INCORE_BYTES_PER_GENOTYPE[engine] * genotypes > 0.9 * free


def _progress_logger():
    """Percent/elapsed/ETA logger for :func:`compute_ld_scores` progress
    (``nldsc_tpu/ld/pipeline.py:489-501``): no line before any row is
    done."""
    t0 = time.time()

    def cb(done: int, total: int) -> None:
        if done <= 0:
            return
        elapsed = time.time() - t0
        eta = elapsed * (total - done) / done
        log.info("LD pass: %d/%d SNPs (%.0f%%) | elapsed %.1fs | ETA %.1fs",
                 done, total, 100.0 * done / total, elapsed, eta)

    return cb


def _sharded(genotypes, positions, config, annot, dev, n_dev: int,
             axis: str, grid) -> dict:
    """An in-core run over ``n_dev`` devices of ``dev``'s type on
    ``axis`` (``snp``, ``samples`` or ``grid`` of shape ``grid``)."""
    from ..parallel import (grid_sharded, mesh, sample_sharded,  # noqa: PLC0415
                            sharded)

    if axis != "snp" and config.use_int8 is False:
        raise NLDSCParameterError(
            f"--shard-axis {axis} runs the integer engine only (the "
            "reference's sample and grid bodies); use --shard-axis snp with "
            "--engine f32")
    t0 = time.time()
    mesh.exchange_bytes = 0
    if axis == "grid":
        log.info("Running the LD estimator on a %dx%d snp-x-sample grid of "
                 "%s devices...", *grid, dev.type)
        result = grid_sharded.ld_scores_grid_sharded(
            genotypes, positions, config, mesh.grid_devices(*grid, dev),
            annot)
    else:
        log.info("Running the LD estimator on %d %s devices (%s axis)...",
                 n_dev, dev.type, axis.upper())
        run = (sample_sharded.ld_scores_sample_sharded if axis == "samples"
               else sharded.ld_scores_sharded)
        result = run(genotypes, positions, config,
                     mesh.snp_devices(n_dev, dev), annot)
    stage_add("device_s", t0)
    STAGE_TIMES["exchange_mb"] = mesh.exchange_bytes / 1e6
    return result


#: the file that ``estimate_lds(profile_dir=DIR)`` writes into DIR
TRACE_FILE = "ld_trace.json"


@contextlib.contextmanager
def profiled(profile_dir: str | None, device: torch.device):
    """Trace the enclosed work with ``torch.profiler`` into
    ``<profile_dir>/ld_trace.json`` (Chrome trace format, as the
    reference's ``jax.profiler.trace`` wraps its compute pass,
    ``nldsc_tpu/ld/pipeline.py:601-605``): CPU activity, and CUDA activity
    on a CUDA device, with the ``nldsc.ld.*`` ranges of each traced call
    (``core.timing.span``); then one log line per traced call, each span's
    ``device_ms`` and the call's counters.  A profiler that cannot trace
    the card raises; it never writes a CPU-only trace of a CUDA run.
    Nothing when ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    act = torch.profiler.ProfilerActivity
    activities = [act.CPU]
    if device.type == "cuda":
        if act.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("--profile-dir: this torch cannot trace CUDA "
                               "activity (no CUPTI)")
        activities.append(act.CUDA)
    first = len(timing.calls())
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for call in timing.calls()[first:]:
        log.info("Traced %s", timing.call_line(call))
    if device.type == "cuda" and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError("--profile-dir: the profiler recorded no CUDA "
                           "activity in a CUDA run")
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("Wrote the profiler trace: %s", path)


def grid_shape(n_dev: int) -> tuple[int, int] | None:
    """The squarest (rows, columns) factorization of ``n_dev`` devices for
    ``--shard-axis grid``, or None when there is none (``n_dev`` prime or
    below 4): the caller then shards the SNP axis, with the reference's
    warning (``nldsc_tpu/ld/pipeline.py:474-487``)."""
    c = max(d for d in range(1, int(n_dev ** 0.5) + 1) if n_dev % d == 0)
    if c == 1:
        log.warning("--shard-axis grid: %d devices have no 2-D "
                    "factorization; using 1-D SNP sharding", n_dev)
        return None
    return n_dev // c, c


def resolve_n_devices(n_devices: int | None, device: torch.device) -> int:
    """The device count of a run: ``None`` means every visible CUDA device
    (one on a one-card machine, or with an indexed device), and one on
    the CPU; an explicit N runs N shards, on the CPU N repeated CPU
    shards.  More than the visible CUDA devices is refused, as the
    reference refuses more than ``jax.devices()``
    (``nldsc_tpu/ld/pipeline.py:592-600``)."""
    if n_devices is not None and n_devices < 1:
        raise NLDSCParameterError(f"--n-devices must be >= 1, got "
                                  f"{n_devices}")
    if device.type == "cpu":
        return 1 if n_devices is None else n_devices
    avail = 1 if device.index is not None else torch.cuda.device_count()
    if n_devices is not None and n_devices > avail:
        raise NLDSCParameterError(
            f"--n-devices {n_devices} exceeds the {avail} visible CUDA "
            f"device(s) of {device}; run with fewer devices")
    return avail if n_devices is None else n_devices


@elapsed_time
def estimate_lds(
    bfile: str,
    ld_wind: float,
    wind_metric: str,
    maf_thr: float = 1e-5,
    std_thr: float = 1e-5,
    rsq_thr: float | None = None,
    *,
    out: str | None = None,
    extra: bool = False,
    summary: bool = False,
    block_size: int = 512,
    write_m: bool = True,
    int8_dot_dtype: str = "int8",
    split_missing: bool | None = None,
    use_pallas: bool = False,
    use_int8: bool | None = None,
    progress: bool | None = None,
    streaming: bool | None = None,
    chunk_rows: int = 8192,
    resume_path: str | None = None,
    annot: str | None = None,
    symmetric: bool | None = None,
    profile_dir: str | None = None,
    n_devices: int | None = None,
    shard_samples: bool = False,
    shard_grid: bool = False,
    device="cuda",
):
    """Estimate additive + dominance LD scores from a PLINK bfile.

    API parity with the reference ``estimate_lds``
    (``nldsc/ldscore/routine.py:51-102``) on one device, in core or
    streaming; returns the .L2 table when ``out`` is None, else writes
    ``<out>`` (and ``.M``/``.M_5_50``) and returns None.

    ``split_missing``: None picks the split-missing route when at most
    25% of the usable rows carry a missing genotype; ``use_pallas``
    (``--engine pallas``) always runs the single global pass in core.
    ``int8_dot_dtype``: the integer engines' operands, ``'int8'`` or
    ``'bf16'``; ``use_int8=False`` (``--engine f32``) the f32 engine, in
    core only.
    ``streaming``: None streams when the in-core working set would not
    fit (:func:`wants_streaming`); ``chunk_rows`` pivot rows per chunk;
    ``resume_path`` a checkpoint directory of the streaming route.
    ``annot``: a per-SNP annotation file (:func:`..io.ldscores.read_annot`):
    partitioned LD scores, one ``<name>.L2`` and one ``<name>.L2D`` column
    per annotation (``extra`` adds nothing to that table) and
    per-annotation ``.M``/``.M_5_50``.  ``symmetric``: the engine; in core
    :func:`resolve_symmetric`; streamed, the symmetric one unless it is
    False or ``use_int8`` is False, then the full band.
    ``profile_dir``: a directory for a ``torch.profiler`` trace of the
    compute pass (:func:`profiled`).
    ``n_devices`` (:func:`resolve_n_devices`): above one, the run is
    sharded (``nldsc_tpu_torch.parallel``), routed as the reference routes
    it (``nldsc_tpu/ld/pipeline.py:611-760``): the SNP axis by default
    (in core ``ld_scores_sharded``, streamed chunks round-robin over the
    devices), the samples with ``shard_samples``, a 2-D grid with
    ``shard_grid`` (:func:`grid_shape`; the SNP axis when there is none).
    """
    STAGE_TIMES.clear()
    dev = resolve_device(device)
    t_parse = time.time()
    ds = PlinkDataset.parse(bfile)
    stage_add("disk_s", t_parse)

    config = LDConfig(
        ld_wind=ld_wind, wind_metric=wind_metric, maf_thr=maf_thr,
        std_thr=std_thr, rsq_thr=rsq_thr, block_size=block_size,
        int8_dot_dtype=int8_dot_dtype, split_missing=split_missing,
        use_pallas=use_pallas, symmetric=symmetric, use_int8=use_int8,
    ).resolve_rsq(ds.n_snp)

    log.info("Input: %s, size: (M=%d, N=%d)", ds.bed_path, ds.n_snp,
             ds.n_samples)
    positions = ds.positions(config.wind_metric)
    if streaming is None:
        streaming = wants_streaming(
            ds.n_snp, ds.n_samples, dev,
            "f32" if config.use_int8 is False else config.int8_dot_dtype)
    annot_mat = annot_names = None
    if annot is not None:
        t_annot = time.time()
        annot_mat, annot_names = read_annot(annot, ds.bim)
        stage_add("disk_s", t_annot)
        log.info("Partitioned LD scores: %d annotations from %s",
                 len(annot_names), annot)

    n_dev = resolve_n_devices(n_devices, dev)
    grid = grid_shape(n_dev) if shard_grid and n_dev > 1 else None
    axis = ("grid" if grid else "samples" if shard_samples and n_dev > 1
            else "snp" if n_dev > 1 else None)
    t0 = time.time()
    with profiled(profile_dir, dev):
        if streaming:
            from ..parallel import mesh  # noqa: PLC0415
            from .streaming import compute_ld_scores_streaming  # noqa: PLC0415

            layout = ({} if axis is None else
                      {"grid": mesh.grid_devices(*grid, dev)} if grid else
                      {"sample_mesh" if axis == "samples" else "devices":
                       mesh.snp_devices(n_dev, dev)})
            log.info("Running the LD estimator on %s (streaming, chunk=%d "
                     "rows%s)...", dev, chunk_rows,
                     "" if axis is None else
                     f", {n_dev} devices, {axis} axis")
            result = compute_ld_scores_streaming(
                ds.bed, positions, config, chunk_rows=chunk_rows,
                resume_path=resume_path, annot=annot_mat, device=dev,
                **layout)
        else:
            if resume_path:
                log.warning("--resume checkpoints the streaming route "
                            "only; this run is in core")
            genotypes = ds.bed.read_raw()
            stage_add("disk_s", t0)
            if axis is None:
                log.info("Running the LD estimator on %s...", dev)
                want_prog = (progress if progress is not None
                             else ds.n_snp >= 20000)
                result = compute_ld_scores(
                    genotypes, positions, config, annot=annot_mat,
                    device=dev,
                    progress=_progress_logger() if want_prog else None)
            else:
                result = _sharded(genotypes, positions, config, annot_mat,
                                  dev, n_dev, axis, grid)
    dt = time.time() - t0
    log.info("Estimation completed: %d SNPs in %.2fs (%.0f SNPs/s)",
             ds.n_snp, dt, ds.n_snp / max(dt, 1e-9))
    log.info("Stage decomposition: %s",
             {k: round(v, 3) for k, v in sorted(STAGE_TIMES.items())})

    if summary:
        show_summary(result)

    if annot_mat is None:
        table = make_output(ds.bim, result, extra=extra)
    else:
        table = make_output_annot(ds.bim, result, annot_names)
    if out:
        t_w = time.time()
        write_l2(table, out)
        if write_m and annot_mat is None:
            write_m_files(result, out)
        elif write_m:
            write_m_files_annot(result, annot_mat, annot_names, out)
        stage_add("write_s", t_w)
        return None
    return table
