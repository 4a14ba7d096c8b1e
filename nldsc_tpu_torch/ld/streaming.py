"""Out-of-core (streaming) LD scores: chunked band recompute.

Port of ``nldsc_tpu/ld/streaming.py``, on one device or a ring of them
(``compute_ld_scores_streaming(devices=, sample_mesh=, grid=)``).  The
pivot rows go in chunks of ``chunk_rows``; each chunk is computed against
a band of rows read for it alone.  Two engines, picked as the reference
picks them (``symmetric = config.symmetric is not False and use_int8``):

symmetric (the integer engines by default): the band holds the chunk's
    pivots and the ``halo`` rows after them, as far as any window reaches.
    Per chunk:

      host (one prefetch thread): read the band's packed .bed rows into a
          page-locked staging buffer; with band-tail retention only the
          ``chunk_rows`` rows that the previous band did not hold
      device: unpack -> class counts and per-SNP scalars -> kernel K1 over
          the pivots, the halo rows being neighbours only -> on split
          chunks kernel K2's corrections for the pairs whose left member is
          a pivot -> one payload of credits and pivot statistics, copied
          back
      host: add the column credits that earlier chunks earned for these
          rows (a float64 carry), carry the halo's credits forward,
          finalize in float32, write the checkpoint shard

full band (``--no-symmetric``, and the f32 engine ``--engine f32``): the
    band holds ``halo`` rows before the pivots too, ``chunk_rows + 2·halo``
    rows, so every pair of a pivot is in its own chunk and no credit
    crosses chunks: no carry, no row scan, no band-tail retention.  The
    device unpacks the band and runs, per pivot block, the reference's
    ``_banded_chunk_int8`` (two integer products, six with missing
    genotypes in the band, on int8 or bf16 operands) or ``_banded_chunk``
    (``preprocess.preprocess_block`` on the band, two float32 products,
    TF32 off), then the tile epilogue with row credits only
    (``ld_xla.band_pass``): plain torch ops, as the reference's are XLA
    products; neither K1 nor K2 runs.

Device memory is bounded by the band, whatever M.  With ``resume_path``
each finished chunk is written once, atomically, as a shard file; a
restart skips the contiguous prefix of finished chunks on the symmetric
route (its credits flow forward), and every finished chunk on the full
band.  ``meta.json`` pins the engine and the operand type (``int8``,
``bf16`` or ``f32``), so a checkpoint of one refuses to resume another.

Under ``--dot-dtype bf16`` each band's code matrices become bf16
operands on the device (the same exact sums, so the same scores).

With ``annot`` (partitioned LD scores) the zero-padded annotation matrix
is sent once; each band's engine takes its rows and returns two
``(rows, p)`` accumulators more, which ride the same payload (on the
symmetric route with a second float64 carry ``(2, halo, p)`` and the
shard's ``tail_a``).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..core.errors import NLDSCParameterError
from ..core.logging import log
from ..core.timing import STAGE_TIMES, stage_add
from ..io.plink import BedReader, _packed_has_missing, scan_rowmiss
from ..parallel import mesh, sample_sharded
from ..parallel.mesh import on_device
from . import (ld_int8, ld_pallas_sym, ld_split, ld_xla, preprocess,
               windows)

#: credit quantities of a band, in payload order
CREDITS = ("l2", "ws", "poison", "l2d", "wsd", "wse")
#: per-pivot statistics of the payload, after the credits
STATS = ("usable", "add_sd_zero", "maf", "rstd")

_INT_KEYS = ("l2_ws", "l2d_ws", "l2d_wse")
_FLOAT_KEYS = ("l2", "l2d", "maf", "residuals_std")


@dataclass(frozen=True)
class Geometry:
    """Rows of the streaming pass.  ``unit`` divides every row count:
    ``block_size`` (the pivot block of the twins and of the full-band
    engines) on the CPU and on the full-band routes, and on the symmetric
    route on CUDA also ``ld_pallas_sym.ROW_ALIGN``, so that every chunk
    and halo is whole K1 tiles.  ``lead``: band rows before the pivots
    (``halo`` on the full band, 0 on the symmetric route)."""

    unit: int
    chunk_rows: int
    halo: int
    m_pad: int
    n_chunks: int
    lead: int = 0

    @property
    def band_rows(self) -> int:
        return self.chunk_rows + self.halo + self.lead

    @property
    def m_ext(self) -> int:
        return self.n_chunks * self.chunk_rows


def stream_geometry(m: int, lo: np.ndarray, hi: np.ndarray, chunk_rows: int,
                    block_size: int, device_type: str,
                    full_band: bool = False) -> Geometry:
    """Chunk and halo rows rounded as the reference rounds them
    (``streaming.py:484-504``), to ``unit``; the full band's lead halo
    (``:528-529``)."""
    unit = (block_size if device_type == "cpu" or full_band
            else math.lcm(block_size, ld_pallas_sym.ROW_ALIGN))
    chunk_rows = max(unit, (chunk_rows // unit) * unit)
    m_pad = -(-m // unit) * unit
    halo = -(-windows.max_halo_rows(lo, hi) // unit) * unit
    return Geometry(unit=unit, chunk_rows=chunk_rows, halo=halo, m_pad=m_pad,
                    n_chunks=-(-m_pad // chunk_rows),
                    lead=halo if full_band else 0)


def split_selected(rowmiss: np.ndarray,
                   split_missing: bool | None) -> tuple[bool, float]:
    """The streaming route's split choice and its fraction, as the
    reference makes it (``streaming.py:584-587``): the fraction is over the
    real rows of the .bed scan, which flags every row with a missing
    genotype, usable or not; split when ``split_missing``, or when it is
    None and ``0 < frac <= 0.25``; never without a contaminated row.  (The
    in-core rule differs: :func:`..pipeline.incore_route`.)"""
    frac = float(rowmiss.mean()) if len(rowmiss) else 0.0
    want = split_missing if split_missing is not None else 0.0 < frac <= 0.25
    return bool(want and rowmiss.any()), frac


def finalize_np(l2_acc, l2d_acc, ws, wsd, wse, poison, usable, add_sd_zero):
    """Host float32 copy of ``ld_xla.finalize_outputs``: the same IEEE
    float32 operations in the same order (reference
    ``streaming.py:370-383``)."""
    l2a = l2_acc.astype(np.float32)
    l2da = l2d_acc.astype(np.float32)
    nan = np.float32(np.nan)
    l2 = np.where(usable & (poison == 0), np.float32(1.0) + l2a, nan)
    l2d_bad = np.where(wsd > 0, nan, np.float32(0.0))
    l2d = np.where(usable, np.where(add_sd_zero, l2d_bad, l2da), nan)
    ws_o = np.where(usable, ws, -1).astype(np.int32)
    wsd_o = np.where(usable, wsd, -1).astype(np.int32)
    wse_o = np.where(usable, np.where(add_sd_zero, 0, wse),
                     -1).astype(np.int32)
    return l2, l2d, ws_o, wsd_o, wse_o


def bed_identity(path: str) -> dict:
    """The .bed fields that key the rowmiss cache and the checkpoint meta:
    path, size and modification time, so that a regenerated file of the
    same size is not taken for the old one."""
    st = os.stat(path)
    return {"bed_path": os.path.abspath(path), "bed_bytes": st.st_size,
            "bed_mtime_ns": st.st_mtime_ns}


def _save_npz(path: Path, **arrays) -> None:
    """Write ``path`` atomically (a temporary file, then a rename)."""
    tmp = path.with_name(".tmp_" + path.name)
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_rowmiss(bed: BedReader, ck_dir: Path | None) -> np.ndarray:
    """Per-row missing flags of the .bed: from the checkpoint's cache when
    it was written for this very file, else one scan (then cached)."""
    ident = bed_identity(bed.path)
    cache = ck_dir / "rowmiss.npz" if ck_dir is not None else None
    if cache is not None and cache.exists():
        with np.load(cache, allow_pickle=False) as d:
            if (set(ident) <= set(d.files)
                    and str(d["bed_path"]) == ident["bed_path"]
                    and int(d["bed_bytes"]) == ident["bed_bytes"]
                    and int(d["bed_mtime_ns"]) == ident["bed_mtime_ns"]
                    and d["rowmiss"].shape == (bed.n_snp,)):
                log.info("rowmiss: read the cached bitmap %s", cache)
                return d["rowmiss"]
    t0 = time.time()
    rowmiss = scan_rowmiss(bed)
    log.info("rowmiss: scanned %s in %.2f s", bed.path, time.time() - t0)
    if cache is not None:
        ck_dir.mkdir(parents=True, exist_ok=True)
        _save_npz(cache, rowmiss=rowmiss, **ident)
    return rowmiss


def open_checkpoint(ck_dir: Path, meta: dict) -> None:
    """Create ``ck_dir`` with ``meta.json``, or refuse a directory whose
    meta differs: its shards were computed with other parameters."""
    ck_dir.mkdir(parents=True, exist_ok=True)
    meta_path = ck_dir / "meta.json"
    if meta_path.exists():
        saved = json.loads(meta_path.read_text())
        diff = {k: (saved.get(k), v) for k, v in meta.items()
                if saved.get(k) != v}
        if diff:
            raise ValueError(
                f"checkpoint {ck_dir} was written with different parameters "
                f"— refusing to resume (mismatched: {diff}); use a fresh "
                "checkpoint directory")
    else:
        meta_path.write_text(json.dumps(meta))


def annot_digest(annot: np.ndarray) -> str:
    """A digest of the annotation matrix for the checkpoint meta: shards
    of another annotation file with as many columns are refused."""
    a = np.ascontiguousarray(annot, dtype=np.float64)
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def resume_shards(ck_dir: Path, geo: Geometry, out: dict,
                  carry: np.ndarray | None = None,
                  carry_a: np.ndarray | None = None) -> list[int]:
    """Load finished chunks into ``out``; returns their indices.

    With ``carry`` (the symmetric route) only the contiguous prefix of
    finished chunks: their stored tails fold into ``carry`` (and
    ``tail_a`` into ``carry_a``, the annotation carry), aligned at the
    first chunk still to run, in chunk order, as the uninterrupted run
    folded them; credits flow forward, so a shard after a gap is
    recomputed.  Without (the full band, whose chunks are independent)
    every finished chunk, contiguous or not (reference
    ``streaming.py:689-712``)."""
    shards = {int(f.stem.split("_")[1]): f
              for f in ck_dir.glob("chunk_*.npz")}
    if carry is None:
        done = sorted(ci for ci in shards if ci < geo.n_chunks)
    else:
        k = 0
        while k in shards:
            k += 1
        done = list(range(k))
    c, h = geo.chunk_rows, geo.halo
    for ci in done:
        with np.load(shards[ci]) as saved:
            for key in out:
                out[key][ci * c:(ci + 1) * c] = saved[key]
            offset = (len(done) - 1 - ci) * c
            if carry is not None and offset < h:
                carry[:, :h - offset] += saved["tail"][:, offset:]
                if carry_a is not None:
                    carry_a[:, :h - offset] += saved["tail_a"][:, offset:]
    return done


def fold_carry(local: np.ndarray, carry: np.ndarray,
               tail: np.ndarray) -> np.ndarray:
    """Add to ``local`` (credits of a chunk's rows, along axis 1) the
    column credits that earlier chunks earned for them, and return the
    carry moved on to the next chunk's first row, with ``tail`` (this
    chunk's credits for the rows after it) added."""
    c, h = local.shape[1], carry.shape[1]
    w = min(h, c)
    local[:, :w] += carry[:, :w]
    moved = np.zeros_like(carry)
    if h > c:
        moved[:, :h - c] = carry[:, c:]
    return moved + tail


@dataclass
class _Band:
    ci: int
    stage: torch.Tensor        # uint8 (rows, bytes_per_snp), host
    slot: int
    tail_only: bool
    has_missing: bool


class _BandReader:
    """Band reads of the streaming loop (run on the prefetch thread).

    On CUDA the rows go into one of two page-locked staging buffers, which
    the device copies from asynchronously; a buffer is refilled only
    after the event recorded behind its last copy has passed.  On the CPU
    every read gets a fresh array.
    """

    def __init__(self, bed: BedReader, geo: Geometry,
                 rowmiss: np.ndarray | None, device: torch.device):
        self.bed, self.geo, self.rowmiss = bed, geo, rowmiss
        self.pinned = device.type == "cuda"
        shape = (geo.band_rows, bed.bytes_per_snp)
        self.slots = ([torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                       for _ in range(2)] if self.pinned else [])
        self.events: list = [None, None]

    def read(self, ci: int, slot: int, tail_only: bool) -> _Band:
        """Chunk ``ci``'s band rows ``[p0 - lead, p0 - lead + band_rows)``,
        or with ``tail_only`` its last ``chunk_rows`` rows (the rows the
        previous band does not hold); rows before row 0 and past the .bed
        are 0x55, four missing bitpairs per byte."""
        t0 = time.time()
        geo, bed = self.geo, self.bed
        rows = geo.chunk_rows if tail_only else geo.band_rows
        band_lo = ci * geo.chunk_rows - geo.lead
        first = band_lo + geo.band_rows - rows
        if self.pinned:
            if self.events[slot] is not None:
                self.events[slot].synchronize()
            stage = self.slots[slot][:rows]
        else:
            stage = torch.empty((rows, bed.bytes_per_snp), dtype=torch.uint8)
        buf = stage.numpy()
        # buf[a:b] holds the .bed's rows; the rest is padding
        a = min(max(-first, 0), rows)
        b = max(a, min(rows, bed.n_snp - first))
        buf[:a] = 0x55
        if b > a:
            bed.read_into(first + a, buf[a:b])
        buf[b:] = 0x55
        # the band's missing state: from the row scan when there is one
        # (a tail-only read needs it), else from the rows just read
        has_missing = (
            bool(self.rowmiss[band_lo:band_lo + geo.band_rows].any())
            if self.rowmiss is not None
            else _packed_has_missing(buf[a:b], bed.n_samples))
        stage_add("stream_read_s", t0)
        return _Band(ci, stage, slot, tail_only, has_missing)


def compute_ld_scores_streaming(bed: BedReader, positions: np.ndarray,
                                config, *, chunk_rows: int = 8192,
                                resume_path: str | None = None,
                                annot: np.ndarray | None = None,
                                device="cuda", devices=None,
                                sample_mesh=None, grid=None) -> dict:
    """Streamed LD scores from a :class:`~..io.plink.BedReader`.

    Same result contract as :func:`..pipeline.compute_ld_scores`; the
    device holds one band of ``chunk_rows`` plus halo rows at a time
    (plus a lead halo on the full band).  The engine: symmetric unless
    ``config.symmetric`` is False or ``config.use_int8`` is False (the
    f32 engine), then full band.  ``resume_path``: a checkpoint directory
    (one shard file per finished chunk, ``meta.json`` pinning every
    parameter that changes a chunk, the engine, the device type and the
    rounded geometry included, and on the symmetric route the rowmiss
    cache).  ``annot``: optional (M, p) annotation matrix; adds
    ``l2_annot`` and ``l2d_annot``, float64 (M, p), to the result, and its
    column count and digest to ``meta.json``.  CUDA runs every product on
    the card (the kernels on the symmetric route); ``device="cpu"`` runs
    their plain versions.

    The dispatch ring (reference ``streaming.py:434-520``, ``:778-780``),
    of ``device``'s type: ``devices``, a list of devices, takes the chunks
    round-robin, each on one device (K1 per band and K2 per contaminated
    band there; band-tail retention only on one device); ``sample_mesh``,
    a list of devices, splits the samples of every chunk over them
    (``parallel.sample_sharded``: the symmetric pass in torch ops, its
    products summed over the shards, no split route); ``grid``, rows of
    devices, takes the chunks round-robin over its rows, each row
    sample-sharding its chunk.  The three are mutually exclusive; the
    sample-sharded rings need the symmetric integer engine.  Up to one
    chunk per ring entry is in flight; the host carry stays in chunk
    order.
    """
    from .pipeline import resolve_device  # noqa: PLC0415

    if config.rsq_thr is None:
        raise NLDSCParameterError("resolve rsq_thr first (LDConfig.resolve_rsq)")
    dev = resolve_device(device)
    # the dispatch ring: one entry, a list of devices (its first one
    # leads), per independent device resource
    if grid is not None:
        if sample_mesh is not None or devices:
            raise ValueError("grid is mutually exclusive with sample_mesh "
                             "and devices")
        ring = [[torch.device(d) for d in row] for row in grid]
    elif sample_mesh is not None:
        if devices:
            raise ValueError("sample_mesh and devices are mutually "
                             "exclusive — the mesh already uses its devices")
        ring = [[torch.device(d) for d in sample_mesh]]
    else:
        ring = [[torch.device(d)] for d in (devices or [dev])]
    if any(d.type != dev.type for grp in ring for d in grp):
        raise ValueError(f"the ring's devices must all be {dev.type} devices")
    samples = grid is not None or sample_mesh is not None
    mesh.exchange_bytes = 0
    t_enter = time.time()
    m, n = bed.n_snp, bed.n_samples
    n_pad = -(-n // 128) * 128
    use_int8 = config.use_int8 is not False
    # the reference's choice (streaming.py:512-513): the f32 engine and
    # --no-symmetric run the full band
    symmetric = config.symmetric is not False and use_int8
    if samples and not symmetric:
        raise ValueError(f"{'grid' if grid is not None else 'sample'}-sharded"
                         " streaming requires the symmetric integer engine "
                         "(use_int8, symmetric not disabled)")
    if samples:
        # whole 32-byte lanes per sample shard (sample_sharded.host_rows)
        width = sample_sharded.LANE_BYTES * len(ring[0])
        n_pad = 4 * (-(-bed.bytes_per_snp // width) * width)
    dot_dtype = config.int8_dot_dtype if use_int8 else "f32"
    if use_int8:
        ld_int8.check_dot_dtype(dot_dtype, n_pad)
    B = config.block_size
    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    geo = stream_geometry(m, lo, hi, chunk_rows, B, dev.type,
                          full_band=not symmetric)
    c, h, lead, band_rows = geo.chunk_rows, geo.halo, geo.lead, geo.band_rows
    ck_dir = Path(resume_path) if resume_path else None

    # global row r at index lead + r; rows before row 0 and past the .bed
    # (to the last band's end) have empty windows
    ext = lead + geo.m_ext + h
    lo_ext = np.full(ext, geo.m_pad, np.int32)
    hi_ext = np.full(ext, -1, np.int32)
    pos_ok_ext = np.zeros(ext, bool)
    lo_ext[lead:lead + m], hi_ext[lead:lead + m] = lo, hi
    pos_ok_ext[lead:lead + m] = pos_ok
    if not symmetric:
        # per pivot block, the first block its windows reach; padding
        # blocks their own (reference streaming.py:539-541)
        blk_lo, _, band_k = windows.band_blocks(lo, hi, B, geo.m_pad // B)
        blk_lo = np.concatenate([blk_lo, np.arange(
            len(blk_lo), geo.m_ext // B, dtype=np.int32)])

    # on the symmetric route one pass over the .bed bytes tells which rows
    # carry missing genotypes: the split choice, and each band's route
    # without a decode
    rowmiss = (load_rowmiss(bed, ck_dir)
               if symmetric and not samples
               and config.split_missing is not False else None)
    use_split = False
    if rowmiss is not None:
        use_split, frac = split_selected(rowmiss, config.split_missing)
        if use_split:
            log.info("Split-missing streaming engine: %.2f%% contaminated "
                     "rows", 100.0 * frac)
    rowmiss_ext = np.zeros(ext, bool)
    if rowmiss is not None:
        rowmiss_ext[:m] = rowmiss

    out = {k: np.full(geo.m_ext, np.nan) for k in _FLOAT_KEYS}
    out.update({k: np.full(geo.m_ext, -1, dtype=np.int64) for k in _INT_KEYS})
    # symmetric: column credits of rows of later chunks, aligned at the
    # next chunk's first row
    carry = np.zeros((len(CREDITS), h), dtype=np.float64) if symmetric else None
    p_annot, annot_ext, carry_a, a_dev = 0, None, None, None
    if annot is not None:
        if annot.ndim != 2 or annot.shape[0] != m or annot.shape[1] < 1:
            raise NLDSCParameterError(
                f"annot must be ({m}, p >= 1), got {annot.shape}")
        p_annot = annot.shape[1]
        annot_ext = np.zeros((ext, p_annot), dtype=np.float32)
        annot_ext[lead:lead + m] = annot
        for key in ("l2_annot", "l2d_annot"):
            out[key] = np.full((geo.m_ext, p_annot), np.nan)
        if symmetric:
            carry_a = np.zeros((2, h, p_annot), dtype=np.float64)
    done: list[int] = []
    if ck_dir is not None:
        open_checkpoint(ck_dir, {
            "m": m, "n": n, "chunk_rows": c, "halo": h, "row_unit": geo.unit,
            "block_size": B, "device": dev.type,
            "ld_wind": float(config.ld_wind),
            "wind_metric": config.wind_metric,
            "maf_thr": float(config.maf_thr),
            "std_thr": float(config.std_thr),
            "rsq_thr": float(config.rsq_thr),
            "engine": ("sym-split2" if use_split else "sym-samples" if
                       samples else "sym" if symmetric else "full"),
            "annot_p": p_annot if annot is not None else -1,
            "annot_sha256": None if annot is None else annot_digest(annot),
            "dot_dtype": dot_dtype,
            **bed_identity(bed.path)})
        done = resume_shards(ck_dir, geo, out, carry, carry_a)
        if done:
            log.info("Resuming: %d chunks already complete", len(done))

    thresholds = (ld_int8.f32(config.maf_thr), ld_int8.f32(config.std_thr))
    seg_rows = min(ld_split.SEG_ROWS_DEFAULT, band_rows)
    # band-tail retention: consecutive symmetric bands overlap by exactly
    # the halo, so while the previous band's packed rows stay on the
    # device only the chunk_rows new rows are read and sent; it needs the
    # row scan for a band's missing state, and one device (a ring places
    # consecutive chunks on different devices)
    retain = rowmiss is not None and len(ring) == 1
    retained: dict = {"ci": None, "raw": None}
    routes: Counter = Counter()
    reader = _BandReader(bed, geo, rowmiss, dev)
    todo = sorted(set(range(geo.n_chunks)) - set(done))
    if annot is not None and todo:
        # the annotation rows on each lead device of the ring, sent once
        a_dev = {}
        for grp in ring:
            if grp[0] not in a_dev:
                a_dev[grp[0]] = torch.from_numpy(annot_ext).to(grp[0])

    def put_band(band: _Band, dev: torch.device) -> torch.Tensor:
        """The band's packed rows on the device (with retention, the
        previous band's last halo rows and the new ones)."""
        ci = band.ci
        if band.tail_only:
            if retained["ci"] != ci - 1:
                raise RuntimeError(
                    f"band-tail retention: chunk {ci}'s band needs chunk "
                    f"{ci - 1}'s, but the device holds chunk "
                    f"{retained['ci']}'s")
            raw = torch.cat([retained["raw"][c:],
                             band.stage.to(dev, non_blocking=True)])
        else:
            raw = band.stage.to(dev, non_blocking=True)
        if reader.pinned:
            ev = torch.cuda.Event()
            ev.record()
            reader.events[band.slot] = ev
        STAGE_TIMES["stream_put_mb"] = (STAGE_TIMES.get("stream_put_mb", 0.0)
                                        + band.stage.nbytes / 1e6)
        if retain:
            retained["ci"], retained["raw"] = ci, raw
        return raw

    def to_host(payload: torch.Tensor):
        """The payload copied to page-locked host memory behind an event
        on CUDA; as it is on the CPU."""
        if not reader.pinned:
            return payload, None
        host = torch.empty(payload.shape, dtype=payload.dtype,
                           pin_memory=True)
        host.copy_(payload, non_blocking=True)
        done_ev = torch.cuda.Event()
        done_ev.record()
        return host, done_ev

    def dispatch_sym(band: _Band, grp: list):
        """Queue chunk ``band.ci``'s device work on the symmetric route,
        on the ring entry ``grp``'s device; returns its payload, being
        copied to the host, and the event behind the copy."""
        dev = grp[0]
        p0 = band.ci * c
        sl = slice(p0, p0 + band_rows)
        raw = put_band(band, dev)
        lo_b, hi_b = lo_ext[sl] - p0, hi_ext[sl] - p0
        win = torch.from_numpy(np.stack([lo_b, hi_b])).to(dev)
        lo_d, hi_d = win[0], win[1]
        g = preprocess.unpack_bed(raw, n_samples=n, n_pad=n_pad, pad_val=-1)
        split_c = use_split and bool(rowmiss_ext[sl].any())
        global_c = not use_split and band.has_missing
        pre = ld_int8.preprocess_int8(
            g, torch.from_numpy(pos_ok_ext[sl]).to(dev), thresholds[0],
            n_samples=n, materialize_m=global_c)
        dom_ok = pre["usable"] & (pre["rstd"] > thresholds[1])
        scal = ld_int8.stack_scalars(pre)
        # the band's annotations: rows [p0, p0 + band_rows) of the padded
        # matrix (a halo row's column credits weight by its pivot's row)
        annot_b = None if a_dev is None else a_dev[dev][sl]
        ops = {"g": pre.pop("g"), "m": pre.pop("m"), "h": pre.pop("h")}
        if split_c:
            rm_b = rowmiss_ext[sl]
            plan = ld_split.plan_split_v2(rm_b, lo_b, hi_b, seg_rows,
                                          band_rows)
            ops["m_c"] = ld_split.compact_missing_rows(g, plan["miss_idx"])
        del g
        ld_int8.to_operands(ops, dot_dtype)
        l2, ws, poi, l2d, wsd, wse, *acc_a = ld_pallas_sym.sym_credits(
            ops["g"], ops["m"], ops["h"], scal, lo_d, hi_d, pre["usable"],
            dom_ok, pre["add_sd_zero"], config.rsq_thr, n_samples=n,
            has_missing=global_c, block_size=B, pivot_rows=c, annot=annot_b)
        if split_c:
            # pairs owned by their left member: own_hi = chunk_rows
            l2_d, l2d_d, wse_d, *delta_a = ld_split.split_corrections(
                ops["g"], ops["m_c"], ops["h"], scal, lo_d, hi_d,
                pre["usable"], dom_ok, torch.from_numpy(rm_b).to(dev),
                config.rsq_thr, c, plan, annot_b, n_samples=n)
            l2, l2d, wse = l2 + l2_d, l2d + l2d_d, wse + wse_d
            acc_a = [a + d for a, d in zip(acc_a, delta_a)]
        routes["split" if split_c else "global" if global_c else "clean"] += 1
        return to_host(_payload((l2, ws, poi, l2d, wsd, wse), pre, 0, c,
                                acc_a))

    def dispatch_full(band: _Band, grp: list):
        """Queue chunk ``band.ci``'s device work on the full band
        (reference ``streaming.py:915-951``): as :func:`dispatch_sym`."""
        dev = grp[0]
        p0 = band.ci * c
        sl = slice(p0, p0 + band_rows)           # the band, in ext rows
        piv = slice(lead + p0, lead + p0 + c)    # its pivots
        raw = put_band(band, dev)
        win = torch.from_numpy(np.stack([lo_ext[piv], hi_ext[piv]])).to(dev)
        g = preprocess.unpack_bed(raw, n_samples=n, n_pad=n_pad, pad_val=-1)
        pos_b = torch.from_numpy(pos_ok_ext[sl]).to(dev)
        if use_int8:
            pre = ld_int8.preprocess_int8(g, pos_b, thresholds[0],
                                          n_samples=n,
                                          materialize_m=band.has_missing)
            ops = {"g": pre.pop("g"), "m": pre.pop("m"), "h": pre.pop("h")}
            del g
            ld_int8.to_operands(ops, dot_dtype)
            tile = ld_int8.int8_tile(ops["g"], ops["m"], ops["h"],
                                     ld_int8.stack_scalars(pre), n,
                                     band.has_missing, dot_dtype)
            routes["global" if band.has_missing else "clean"] += 1
        else:
            pre = preprocess.preprocess_block(g, pos_b, config.maf_thr, n)
            del g
            tile = ld_xla.f32_tile(pre.pop("add"), pre.pop("res"), n)
            routes["f32"] += 1
        dom_ok = pre["usable"] & (pre["rstd"] > thresholds[1])
        l2, l2d, ws, wsd, wse, poi, *acc_a = ld_xla.band_pass(
            tile, win[0], win[1], pre["usable"], dom_ok, pre["add_sd_zero"],
            blk_lo[p0 // B:(p0 + c) // B], config.rsq_thr,
            None if a_dev is None else a_dev[dev][sl], block_size=B,
            band_k=band_k, n_samples=n, n_pivots=c, g0=p0 - lead,
            piv_off=lead, m_pad=geo.m_pad)
        return to_host(_payload((l2, ws, poi, l2d, wsd, wse), pre, lead, c,
                                acc_a))

    def dispatch_samples(band: _Band, grp: list):
        """Queue chunk ``band.ci``'s device work with its samples split
        over ``grp`` (reference ``_banded_chunk_int8_sym(psum_axis=)``,
        ``streaming.py:115-192``): each device unpacks its lanes of the
        band, the class counts and every tile's products are summed on
        the first, which runs the symmetric pass over the pivots (the
        halo rows neighbours only); as :func:`dispatch_sym`."""
        lead_dev = grp[0]
        p0 = band.ci * c
        sl = slice(p0, p0 + band_rows)
        stage = band.stage.numpy()
        w = n_pad // 4 // len(grp)
        parts = []
        for q, d in enumerate(grp):
            part = np.full((band_rows, w), 0x55, np.uint8)
            cols = stage[:, q * w:(q + 1) * w]
            part[:, :cols.shape[1]] = cols
            parts.append(sample_sharded.unpack_columns(
                torch.from_numpy(part).to(d), q, n))
        reader.events[band.slot] = None        # the stage was copied
        STAGE_TIMES["stream_put_mb"] = (STAGE_TIMES.get("stream_put_mb", 0.0)
                                        + band.stage.nbytes / 1e6)
        lo_b, hi_b = lo_ext[sl] - p0, hi_ext[sl] - p0
        lo_b[c:], hi_b[c:] = band_rows, -1     # the halo: neighbours only
        win = torch.from_numpy(np.stack([lo_b, hi_b])).to(lead_dev)
        mats, pre = sample_sharded.sample_preprocess(
            parts, torch.from_numpy(pos_ok_ext[sl]).to(lead_dev),
            thresholds[0], n, n_pad, band.has_missing)
        del parts
        dom_ok = pre["usable"] & (pre["rstd"] > thresholds[1])
        for x in mats:
            ld_int8.to_operands(x, dot_dtype)
        l2, ws, poi, l2d, wsd, wse, *acc_a = ld_int8.sym_scan(
            sample_sharded.summed_products(mats, lead_dev, band.has_missing,
                                           dot_dtype, symmetric=True),
            ld_int8.stack_scalars(pre), win[0], win[1], pre["usable"],
            dom_ok, pre["add_sd_zero"], config.rsq_thr, 0,
            None if a_dev is None else a_dev[lead_dev][sl], block_size=B,
            right_k=ld_int8.band_extent(win[1], B)[1], n_samples=n,
            n_pad=n_pad, n_scan_blocks=-(-c // B),
            has_missing=band.has_missing)
        routes["global" if band.has_missing else "clean"] += 1
        return to_host(_payload((l2, ws, poi, l2d, wsd, wse), pre, 0, c,
                                acc_a))

    dispatch = (dispatch_samples if samples else dispatch_sym if symmetric
                else dispatch_full)
    # the payload's credits per quantity: the band's rows (symmetric: the
    # halo's are column credits for later chunks), or the pivots'
    width = band_rows if symmetric else c
    n_sums = len(CREDITS) * width
    n_run = 0

    def collect(ci: int, payload: torch.Tensor, done_ev) -> None:
        """Finalize chunk ``ci`` on the host and write its shard."""
        nonlocal carry, carry_a, n_run
        if done_ev is not None:
            done_ev.synchronize()
        pp = payload.numpy()
        sums = pp[:n_sums].reshape(len(CREDITS), width)
        local = sums[:, :c].copy()
        stats = pp[n_sums:n_sums + len(STATS) * c].reshape(len(STATS), c)
        tails = {}
        if symmetric:
            # credits earned by earlier chunks, then the carry moved on to
            # the next chunk's first row
            tails["tail"] = sums[:, c:]
            carry = fold_carry(local, carry, tails["tail"])
        l2a, ws_c, poi_c, l2da, wsd_c, wse_c = local
        usable, sd_zero = stats[0] > 0, stats[1] > 0
        l2, l2d, ws, wsd, wse = finalize_np(
            l2a, l2da, ws_c.astype(np.int32), wsd_c.astype(np.int32),
            wse_c.astype(np.int32), poi_c.astype(np.int32), usable, sd_zero)
        rows = slice(ci * c, (ci + 1) * c)
        for key, val in (("l2", l2), ("l2d", l2d), ("maf", stats[2]),
                         ("residuals_std", stats[3]), ("l2_ws", ws),
                         ("l2d_ws", wsd), ("l2d_wse", wse)):
            out[key][rows] = val
        if annot is not None:
            # the annotation accumulators (carried like the credits on the
            # symmetric route), then the sentinels of
            # ld_int8.finalize_annot in float64 (reference
            # streaming.py:985-1003, 1061-1075)
            sums_a = pp[n_sums + len(STATS) * c:].reshape(2, width, p_annot)
            local_a = sums_a[:, :c].copy()
            if symmetric:
                tails["tail_a"] = sums_a[:, c:]
                carry_a = fold_carry(local_a, carry_a, tails["tail_a"])
            good = (usable & (poi_c == 0))[:, None]
            out["l2_annot"][rows] = np.where(
                good, annot_ext[lead:][rows].astype(np.float64) + local_a[0],
                np.nan)
            l2d_bad = np.where(wsd_c > 0, np.nan, 0.0)[:, None]
            out["l2d_annot"][rows] = np.where(
                usable[:, None],
                np.where(sd_zero[:, None], l2d_bad, local_a[1]), np.nan)
        if ck_dir is not None:
            _save_npz(ck_dir / f"chunk_{ci:06d}.npz",
                      **{k: v[rows] for k, v in out.items()}, **tails)
        n_run += 1
        n_done = len(done) + n_run
        elapsed = time.time() - t_start
        log.info("chunk %d/%d done (%.0f%%, rows %d..%d) | elapsed %.1fs "
                 "| ETA %.1fs", ci + 1, geo.n_chunks,
                 100.0 * n_done / geo.n_chunks, rows.start, rows.stop,
                 elapsed, elapsed * (geo.n_chunks - n_done) / n_run)

    t_start = time.time()
    log.info("streaming setup %.1fs (windows, rowmiss, checkpoint); %d "
             "chunks of %d rows (halo %d) to run", t_start - t_enter,
             len(todo), c, h)
    in_flight: deque = deque()
    with ThreadPoolExecutor(max_workers=1) as pool:
        prefetch = pool.submit(reader.read, todo[0], 0, False) if todo else None
        for idx, ci in enumerate(todo):
            t0 = time.time()
            band = prefetch.result()
            stage_add("stream_read_wait_s", t0)
            if idx + 1 < len(todo):
                # a tail-only read when the next chunk follows this one:
                # its band is then this band's last halo rows plus new ones
                prefetch = pool.submit(reader.read, todo[idx + 1],
                                       (idx + 1) % 2, retain)
            t0 = time.time()
            grp = ring[idx % len(ring)]
            with on_device(grp[0]):
                in_flight.append((ci, *dispatch(band, grp)))
            stage_add("stream_dispatch_s", t0)
            # collect the oldest chunk while the ring works on the newer
            # ones (one in flight per ring entry)
            while len(in_flight) > (len(ring) if idx + 1 < len(todo) else 0):
                t0 = time.time()
                collect(*in_flight.popleft())
                stage_add("stream_collect_s", t0)
    parts = [] if symmetric else ["full band"]
    if len(ring) > 1 or samples:
        parts.append(f"{len(ring)}x{len(ring[0])} grid" if grid is not None
                     else f"samples over {len(ring[0])} devices" if samples
                     else f"{len(ring)} devices")
    parts += [f"{k} {v}" for k, v in sorted(routes.items())]
    if done:
        parts.append(f"resumed {len(done)}")
    if samples:
        STAGE_TIMES["exchange_mb"] = mesh.exchange_bytes / 1e6
    log.info("LD route: streaming (%d chunks of %d rows, halo %d: %s)",
             geo.n_chunks, c, h, ", ".join(parts) or "none")
    return {k: v[:m] for k, v in out.items()}


def _payload(credits, pre: dict, lead: int, c: int, acc_a) -> torch.Tensor:
    """One float64 vector of a chunk's results: the credits (in
    :data:`CREDITS` order), the pivot rows' :data:`STATS` (band rows
    ``[lead, lead + c)``), then the annotation accumulators."""
    stats = torch.stack([pre["usable"], pre["add_sd_zero"], pre["maf"],
                         pre["rstd"]])[:, lead:lead + c]
    return torch.cat([torch.stack(credits).double().reshape(-1),
                      stats.double().reshape(-1),
                      *(a.double().reshape(-1) for a in acc_a)])
