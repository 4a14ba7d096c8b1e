"""Sample-sharded LD scores: every shard holds all the SNP rows and one
slice of the samples.

Port of ``nldsc_tpu/parallel/sample_sharded.py`` on a list of devices
driven by one process.  Every dot product of the integer algebra is a sum
over samples, so

  * each shard counts its columns' genotype classes; the counts are added
    exactly on the first device (the lead), where
    ``ld_int8.finish_preprocess_int8`` turns them into the per-SNP
    scalars;
  * each tile pair's products are computed on every shard
    (``ld_int8.idot``/``bdot``: ``torch._int_mm`` on a card) and added on
    the lead: non-negative integers below 2^24, exact in float32, so the
    order of the sum is free and the result is bitwise invariant in the
    shard count;
  * the epilogue runs once, on the lead, through ``ld_xla.band_pass``
    (in core, the full band) or ``ld_int8.sym_scan`` (the symmetric
    chunks of the streaming rings).

Kernel K1 fuses the epilogue into its products, before any sum across
shards could happen, so these products are ``torch._int_mm``, as the
reference computes them in XLA outside its Pallas kernel.  Packed rows
are split into 32-byte (128-sample) lanes per shard and unpacked on the
shard (``preprocess.unpack_bed(col0=)``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.plink import PackedBed
from ..ld import ld_int8, ld_xla, preprocess, windows
from .mesh import send
from .sharded import annot_rows, finish

#: bytes (samples) of a lane: each shard's columns are whole lanes
LANE_BYTES = 32


def host_rows(genotypes, m_pad: int, d: int):
    """The genotypes as host rows padded for ``d`` sample shards: packed
    bytes ``(m_pad, bps_pad)`` padded with 0x55 (missing) to whole lanes
    per shard, or int8 codes ``(m_pad, n_pad)`` padded with -1.  Returns
    ``(rows, n_pad, packed)``; ``n_pad`` counts the padded samples."""
    m = genotypes.shape[0]
    if isinstance(genotypes, PackedBed):
        width = LANE_BYTES * d
        bps_pad = -(-genotypes.bytes_per_snp // width) * width
        raw = np.full((m_pad, bps_pad), 0x55, np.uint8)
        raw[:m, :genotypes.bytes_per_snp] = genotypes.raw
        return raw, 4 * bps_pad, True
    n = genotypes.shape[1]
    n_pad = -(-n // (4 * LANE_BYTES * d)) * 4 * LANE_BYTES * d
    g = np.full((m_pad, n_pad), -1, np.int8)
    g[:m, :n] = genotypes
    return g, n_pad, False


def scatter_columns(rows: np.ndarray, packed: bool, n_samples: int,
                    devices) -> list:
    """Each device's column slice of ``rows`` (:func:`host_rows`) as int8
    codes on it, packed bytes unpacked on the device."""
    w = rows.shape[1] // len(devices)
    parts = []
    for q, dev in enumerate(devices):
        x = torch.from_numpy(np.ascontiguousarray(rows[:, q * w:(q + 1) * w]))
        parts.append(unpack_columns(x.to(dev), q, n_samples) if packed
                     else x.to(dev))
    return parts


def unpack_columns(raw: torch.Tensor, q: int, n_samples: int):
    """Shard ``q``'s bytes (rows, w) unpacked: its samples start at column
    ``4·w·q``; columns past ``n_samples`` are missing."""
    w = raw.shape[1]
    return preprocess.unpack_bed(raw, n_samples=n_samples, n_pad=4 * w,
                                 pad_val=-1, col0=4 * w * q)


def sample_preprocess(parts: list, pos_ok: torch.Tensor, maf_thr: float,
                      n_samples: int, n_pad: int, has_missing: bool):
    """Per-shard code matrices and the per-SNP scalars of the whole
    samples (on ``pos_ok``'s device, the lead): ``(mats, pre)``, ``mats``
    one dict per shard (``g``, ``h`` and, with missing genotypes, ``m``),
    ``pre`` the dict of ``ld_int8.finish_preprocess_int8``."""
    lead = pos_ok.device
    mats, counts = [], None
    for q, x in enumerate(parts):
        mat, cnt = ld_int8.code_matrices(x, n_samples,
                                         materialize_m=has_missing)
        if not has_missing:
            mat.pop("m")
        mats.append(mat)
        c = torch.stack(cnt)
        counts = c if q == 0 else counts + send(c, lead)
    n_valid, c1, c2 = counts
    pre = ld_int8.finish_preprocess_int8(n_valid, c1, c2,
                                         float(n_pad) - n_valid, pos_ok,
                                         maf_thr, n_samples)
    return mats, pre


def summed_products(mats: list, lead: torch.device, has_missing: bool,
                    dot_dtype: str, symmetric: bool = False):
    """``dots(rows, cols)`` of ``ld_int8.tile_products`` summed over the
    shards' columns ``mats`` on ``lead`` (the first shard's device)."""
    fns = [ld_int8.tile_products(x["g"], x.get("m", x["g"]), x["h"],
                                 has_missing, dot_dtype, symmetric)
           for x in mats]

    def dots(rows, cols):
        out = fns[0](rows, cols)
        for fn in fns[1:]:
            for k, v in fn(rows, cols).items():
                out[k] = out[k] + send(v, lead)
        return out
    return dots


def ld_scores_sample_sharded(genotypes, positions: np.ndarray, config,
                             devices, annot=None) -> dict:
    """In-core LD scores with the samples split over ``devices``
    (``nldsc_tpu/parallel/sample_sharded.py:261``): the full-band integer
    pass with every tile's products summed over the shards, the epilogue
    on the first device.  The result contract of
    ``pipeline.compute_ld_scores``, equal bit for bit to the in-core full
    band (``ld_int8.ld_scores_int8``) at the same ``block_size``.

    ``genotypes``: int8 (M, N) codes, or a
    :class:`~nldsc_tpu_torch.io.plink.PackedBed` (each shard receives its
    byte columns only).  ``annot``: optional (M, p) annotation matrix,
    contracted on the first device after the sums."""
    devices = [torch.device(d) for d in devices]
    lead = devices[0]
    m, n = genotypes.shape
    B = config.block_size
    m_pad = -(-m // B) * B
    has_missing = (genotypes.has_missing if isinstance(genotypes, PackedBed)
                   else bool((np.asarray(genotypes) < 0).any()))
    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    blk_lo, _, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
    pad = m_pad - m
    win = torch.from_numpy(np.stack([
        np.concatenate([lo, np.full(pad, m_pad, np.int32)]),
        np.concatenate([hi, np.full(pad, -1, np.int32)])]).astype(np.int32)
    ).to(lead)
    ok = torch.from_numpy(np.concatenate([pos_ok, np.zeros(pad, bool)]))

    rows, n_pad, packed = host_rows(genotypes, m_pad, len(devices))
    dot_dtype = config.int8_dot_dtype
    ld_int8.check_dot_dtype(dot_dtype, n_pad)
    mats, pre = sample_preprocess(
        scatter_columns(rows, packed, n, devices), ok.to(lead),
        config.maf_thr, n, n_pad, has_missing)
    del rows
    dom_ok = pre["usable"] & (pre["rstd"] > ld_int8.f32(config.std_thr))
    for x in mats:
        ld_int8.to_operands(x, dot_dtype)
    tile = ld_int8.dots_tile(
        summed_products(mats, lead, has_missing, dot_dtype),
        ld_int8.stack_scalars(pre), n, n_pad, has_missing)
    a_host = annot_rows(annot, m, m_pad)
    a_dev = None if a_host is None else torch.from_numpy(a_host).to(lead)
    accs = ld_xla.band_pass(tile, win[0], win[1], pre["usable"], dom_ok,
                            pre["add_sd_zero"], blk_lo, config.rsq_thr,
                            a_dev, block_size=B, band_k=band_k, n_samples=n)
    return finish(accs, pre["usable"], pre["add_sd_zero"], pre["maf"],
                  pre["rstd"], a_dev, m)
