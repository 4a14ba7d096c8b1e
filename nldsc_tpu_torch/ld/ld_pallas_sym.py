"""Fused symmetric int8 LD pass: the wrapper of the hand-written kernel.

The kernel (``csrc/ld_sym.cu``) is the Hopper port of
``nldsc_tpu/ld/ld_pallas_sym.py::_kernel``.  One CTA takes a pivot tile
and one neighbour tile of its right half-band, accumulates the exact
int8 products over all samples with ``wgmma`` on operands that a TMA
ring brings into shared memory, and keeps the whole adjusted-r²
epilogue in registers; it writes only per-tile row and mirrored-column
partial sums, which :func:`_fold` reduces in a fixed order
(bitwise-reproducible, no float atomics).

Geometry: pivot and neighbour tiles are :data:`TILE_CLEAN` rows on the
clean (3-product) branch and :data:`TILE_MISSING` rows on the missing
(8-product) branch.  Each pivot tile's right extent comes from its rows'
window ends (``hi``), not from a static band depth.  Callers pad the
rows to :data:`ROW_ALIGN`, a multiple of both tiles, before they know
which branch runs, and the samples to a multiple of 128 (one ring
stage), as the pipeline does.

With ``annot`` (partitioned LD scores) the kernel's annotation epilogue
also contracts each tile's masked values with the neighbours' annotation
rows and writes per-tile ``(T, p)`` partials, which :func:`_fold_annot`
reduces the same way.  The reference computes those contractions outside
its Pallas kernel; here they are part of the hand-written one.

bf16 operand tensors (``--dot-dtype bf16``, the reference's bf16 branch
of the kernel: one ``.to`` of the int8 codes on the device,
``ld_int8.to_operands``) run the kernel's bf16 instantiations: the same
products on bf16 ``wgmma`` with float32 accumulators, which hold the
int8 branch's sums exactly, so every output equals the int8 launch's bit
for bit.  The operands' dtype picks the instantiation.

A pass runs in one launch (:func:`sym_credits`) or in launches over
ranges of pivot tiles with the whole pass's band
(:func:`range_partials`), whose unfolded partials, put together in tile
order and folded once, are bitwise the one launch's: the SNP shards of
``parallel.sharded`` and the segments of a pass with progress
(:func:`sym_credits_segmented`) run so.

On a CPU tensor the wrapper runs the plain twin
(:func:`nldsc_tpu_torch.ld.ld_int8.sym_scan_segment`, with the
contraction of the operands' dtype); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from .. import _build
from . import ld_int8

#: pivot and neighbour rows per CTA of the kernel's clean and missing
#: branches, and the row alignment that serves both
TILE_CLEAN = 128
TILE_MISSING = 64
ROW_ALIGN = math.lcm(TILE_CLEAN, TILE_MISSING)

#: kernel launches made by :func:`sym_credits` and :func:`sym_partials`
#: (CUDA tensors only), how many of them ran the 8-product (missing-data)
#: branch, how many the annotation epilogue and how many the bf16
#: operands
launches = 0
missing_launches = 0
annot_launches = 0
bf16_launches = 0
#: the launches per device (``str(device)``)
device_launches: Counter = Counter()

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 14 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [
    ctypes.c_int, ctypes.c_int, _P]


def _library() -> ctypes.CDLL:
    lib = _build.load("ld_sym")
    if lib.ld_sym_launch.argtypes is None:
        lib.ld_sym_launch.argtypes = _ARGTYPES
        lib.ld_sym_launch.restype = ctypes.c_int
        lib.ld_sym_tile.argtypes = [ctypes.c_int]
        lib.ld_sym_tile.restype = ctypes.c_int
    if (lib.ld_sym_tile(0), lib.ld_sym_tile(1)) != (TILE_CLEAN, TILE_MISSING):
        raise RuntimeError("ld_sym.cu and ld_pallas_sym's tiles disagree")
    return lib


def tile(has_missing: bool) -> int:
    """Pivot (and neighbour) rows per CTA of the branch that runs."""
    return TILE_MISSING if has_missing else TILE_CLEAN


def _check_inputs(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                  has_missing: bool, annot=None) -> None:
    m_pad, n_pad = g.shape
    mats = (g, h, m) if has_missing else (g, h)
    op = g.dtype
    if op not in ld_int8.OPERAND_DTYPES.values():
        raise ValueError(f"g must be int8 or bf16, got {op}")
    ld_int8.check_annot(annot, g)
    vecs = {"lo": (lo, torch.int32), "hi": (hi, torch.int32),
            "usable": (usable, torch.bool), "dom_ok": (dom_ok, torch.bool),
            "add_sd_zero": (add_sd_zero, torch.bool)}
    for x in (*mats, scal, *(v for v, _ in vecs.values())):
        if x.device != g.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    for x in mats:
        if x.dtype != op or tuple(x.shape) != (m_pad, n_pad):
            raise ValueError(f"g/m/h must be {op} ({m_pad}, {n_pad})")
        if x.data_ptr() % 16:
            raise ValueError("g/m/h must be 16-byte aligned")
    if scal.dtype != torch.float32 or tuple(scal.shape) != (
            m_pad, len(ld_int8.SCAL_FIELDS)):
        raise ValueError(f"scal must be float32 ({m_pad}, 9)")
    for name, (v, dtype) in vecs.items():
        if v.dtype != dtype or tuple(v.shape) != (m_pad,):
            raise ValueError(f"{name} must be {dtype} ({m_pad},)")
    T = tile(has_missing)
    if m_pad % T or n_pad % 128:
        raise ValueError(f"rows must be padded to a multiple of {T} and "
                         f"samples to a multiple of 128, got {g.shape}")
    if n_pad > (1 << 22) or m_pad // T > 65535:
        raise ValueError(f"shape {tuple(g.shape)} exceeds the kernel's range")


def _fold(fpart, ipart):
    """Sum the per-tile partials in a fixed order.

    ``fpart``/``ipart`` are ``(n_tiles, band, 2, 2 or 4, T)`` for the
    branch's tile T.  Row credits of tile x are its own band slots;
    column credits come from slot ``(x - k, k)`` of every pivot tile
    whose band reaches x.  Returns ``(l2, ws, poison, l2d, wsd, wse)``,
    full length.
    """
    nt, band = fpart.shape[:2]
    dev = fpart.device
    x = torch.arange(nt, device=dev)[:, None]
    k = torch.arange(band, device=dev)[None, :]
    src = x - k
    ok = (src >= 0)[:, :, None, None]
    src = src.clamp(min=0)
    col_f = torch.where(ok, fpart[src, k, 1], 0.0).sum(dim=1)
    col_i = torch.where(ok, ipart[src, k, 1], 0).sum(dim=1, dtype=torch.int32)
    tot_f = fpart[:, :, 0].sum(dim=1) + col_f                # (nt, 2, T)
    tot_i = ipart[:, :, 0].sum(dim=1, dtype=torch.int32) + col_i
    l2, l2d = (tot_f[:, q].reshape(-1) for q in range(2))
    ws, wsd, wse, poi = (tot_i[:, q].reshape(-1) for q in range(4))
    return l2, ws, poi, l2d, wsd, wse


def _fold_annot(apart):
    """The annotation partials ``(n_tiles, band, 2, 2, T, p)`` summed in
    the order of :func:`_fold`: a tile's row credits over its band slots,
    then the column credits of slot ``(x - k, k)`` for k ascending.
    Returns ``(l2_annot, l2d_annot)``, each ``(n_tiles * T, p)``."""
    nt, band = apart.shape[:2]
    tot = apart[:, :, 0].sum(dim=1)                          # (nt, 2, T, p)
    for k in range(band):
        tot[k:] += apart[:nt - k, k, 1]
    p = apart.shape[-1]
    return tot[:, 0].reshape(-1, p), tot[:, 1].reshape(-1, p)


def _launch_partials(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                     rsq_thr: float, n_samples: int, has_missing: bool,
                     annot=None, band: int | None = None):
    """One kernel launch: the unfolded partials ``(fpart, ipart, apart)``
    (``apart`` None without ``annot``) of :func:`_fold`'s layout.  The
    launch runs with the tensors' device current, whichever is current
    in the caller.  ``band``: the slots per pivot tile, at least the
    rows' own right half-band depth (default: that depth)."""
    global launches, missing_launches, annot_launches, bf16_launches
    _check_inputs(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                  has_missing, annot)
    bf16 = g.dtype == torch.bfloat16
    m_pad, n_pad = g.shape
    T = tile(has_missing)
    nt = m_pad // T
    with torch.cuda.device(g.device):
        tile_hi, depth = ld_int8.band_extent(hi, T)
        if band is None:
            band = depth
        elif band < depth:
            raise ValueError(f"band {band} is below the rows' depth {depth}")
        fpart = torch.zeros((nt, band, 2, 2, T), dtype=torch.float32,
                            device=g.device)
        ipart = torch.zeros((nt, band, 2, 4, T), dtype=torch.int32,
                            device=g.device)
        apart = None
        if annot is not None:
            # zero-filled: the tiles outside the band, and the column
            # credits of the pivot tiles, are never written
            apart = torch.zeros((nt, band, 2, 2, T, annot.shape[1]),
                                dtype=torch.float32, device=g.device)
        lib = _library()
        stream = torch.cuda.current_stream(g.device).cuda_stream
        mm = m if has_missing else g                # clean: never read
        err = lib.ld_sym_launch(
            g.data_ptr(), mm.data_ptr(), h.data_ptr(), scal.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), usable.data_ptr(),
            dom_ok.data_ptr(), add_sd_zero.data_ptr(), tile_hi.data_ptr(),
            fpart.data_ptr(), ipart.data_ptr(),
            None if annot is None else annot.data_ptr(),
            None if annot is None else apart.data_ptr(),
            0 if annot is None else annot.shape[1], nt, band, n_pad,
            float(n_samples), float(n_pad),
            ld_int8.adj_constant(n_samples), ld_int8.f32(rsq_thr),
            int(has_missing), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"ld_sym kernel launch failed: CUDA error {err}")
    launches += 1
    device_launches[str(g.device)] += 1
    missing_launches += int(has_missing)
    bf16_launches += int(bf16)
    annot_launches += int(annot is not None)
    return fpart, ipart, apart


def fold_partials(fpart, ipart, apart=None):
    """The un-finalized credit vectors of a run's unfolded partials:
    ``(l2, ws, poison, l2d, wsd, wse)`` (:func:`_fold`), and with
    ``apart`` also ``(l2_annot, l2d_annot)`` (:func:`_fold_annot`)."""
    if apart is None:
        return _fold(fpart, ipart)
    return (*_fold(fpart, ipart), *_fold_annot(apart))


def _launch(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
            rsq_thr: float, n_samples: int, has_missing: bool, annot=None):
    return fold_partials(*_launch_partials(
        g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr,
        n_samples, has_missing, annot))


def sym_partials(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                 rsq_thr: float, *, n_samples: int, has_missing: bool,
                 band: int, block_size: int, annot=None):
    """The symmetric pass's unfolded per-tile partials ``(fpart, ipart,
    apart)`` (``apart`` None without ``annot``): for pivot tile x and slot
    k < ``band``, the row credits that tile x + k gives tile x's rows and
    the column credits that tile x gives tile x + k's rows (the layout of
    :func:`_fold`, which reduces them).  One SNP shard's pass: every
    shard of a run gets the run's ``band``, so that the shards' pivot
    tiles, put together in order, fold as one run's.

    CUDA tensors launch the kernel (tile :func:`tile` of the branch) or
    raise; CPU tensors run the twin
    (:func:`nldsc_tpu_torch.ld.ld_int8.sym_tile_partials`) with tiles of
    ``block_size`` rows.  Rows whose windows are empty (lo past hi) are
    neighbours only: their tiles give nothing."""
    if g.device.type == "cpu":
        return ld_int8.sym_tile_partials(
            g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr,
            annot, tile=block_size, band=band, n_samples=n_samples,
            has_missing=has_missing, dot_dtype=ld_int8.dot_dtype_of(g))
    if g.device.type != "cuda":
        raise ValueError(f"no LD kernel for device {g.device}")
    return _launch_partials(g, m, h, scal, lo, hi, usable, dom_ok,
                            add_sd_zero, rsq_thr, n_samples, has_missing,
                            annot, band)


def range_partials(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                   rsq_thr: float, x0: int, x1: int, *, n_samples: int,
                   has_missing: bool, band: int, block_size: int,
                   annot=None):
    """:func:`sym_partials` of the pivot tiles ``[x0, x1)`` alone: the
    rows ``[x0·T, min(x1·T + halo, rows))`` (``halo`` = ``(band - 1)·T``,
    T the kernel's tile on CUDA, ``block_size`` on the CPU), the halo
    rows' windows emptied (they are neighbours only: their tiles give
    nothing and the kernel's CTAs of them exit at once), and the first
    ``x1 - x0`` tiles' unfolded partials returned.  ``lo``/``hi`` index
    the given rows.  Every slot is computed from the rows of its two
    tiles, so the partials of consecutive ranges, put together in tile
    order, are those of one launch over all the tiles."""
    T = tile(has_missing) if g.device.type == "cuda" else block_size
    r0, r1 = x0 * T, min((x1 + band - 1) * T, g.shape[0])
    lo, hi = lo[r0:r1] - r0, hi[r0:r1] - r0
    lo[(x1 - x0) * T:], hi[(x1 - x0) * T:] = r1 - r0, -1

    def rows(x):
        return None if x is None else x[r0:r1]

    out = sym_partials(
        rows(g), rows(m), rows(h), rows(scal), lo, hi, rows(usable),
        rows(dom_ok), rows(add_sd_zero), rsq_thr, n_samples=n_samples,
        has_missing=has_missing, band=band, block_size=block_size,
        annot=rows(annot))
    return tuple(None if x is None else x[:x1 - x0] for x in out)


#: the most segments of a symmetric pass run with progress, as the
#: reference runs it (``nldsc_tpu/ld/pipeline.py:346-359``)
MAX_SEGMENTS = 16


def segments(m: int, block_size: int, progress: bool) -> list:
    """The ``(first block, blocks)`` segments of a symmetric pass over
    ``m`` rows in pivot blocks of ``block_size``: with ``progress``
    ``min(16, n_blocks)`` segments of ``ceil(n_blocks / n_seg)`` blocks
    (the last one shorter), else one."""
    n_blocks = -(-m // block_size)
    n_seg = min(MAX_SEGMENTS, n_blocks) if progress else 1
    step = -(-n_blocks // n_seg)
    return [(s0, min(step, n_blocks - s0))
            for s0 in range(0, n_blocks, step)]


def sym_credits_segmented(g, m, h, scal, lo, hi, usable, dom_ok,
                          add_sd_zero, rsq_thr: float, *, n_samples: int,
                          has_missing: bool, block_size: int, n_rows: int,
                          progress=None, annot=None):
    """:func:`sym_credits` over all the rows, run in the segments of
    :func:`segments` when ``progress`` is given and the pass has more
    than one block of ``block_size``: ``progress(0, n_rows)`` first, then
    after each segment, once the device has finished it,
    ``progress(rows done, n_rows)``, the ticks of the reference
    (``nldsc_tpu/ld/pipeline.py:346-359``).  ``n_rows``: the real rows
    (the padding rows after them are not counted).

    CUDA tensors launch the kernel once per segment
    (:func:`range_partials`, the segment's bounds rounded to the kernel's
    tile, the whole pass's band) and fold all the segments' partials once:
    the result equals one launch's bit for bit.  CPU tensors run the twin
    (``ld_int8.sym_scan_segment``) per segment and add the segments'
    credit vectors in order, as the reference adds its segments'."""
    segs = segments(n_rows, block_size, progress is not None)
    if len(segs) == 1:
        return sym_credits(g, m, h, scal, lo, hi, usable, dom_ok,
                           add_sd_zero, rsq_thr, n_samples=n_samples,
                           has_missing=has_missing, block_size=block_size,
                           annot=annot)
    args = (g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr)
    kw = dict(n_samples=n_samples, has_missing=has_missing)
    cuda = g.device.type == "cuda"
    B = block_size
    if cuda:
        T = tile(has_missing)
        nt = g.shape[0] // T
        band = ld_int8.band_extent(hi, T)[1]
        # segment i's pivot tiles [edges[i], edges[i + 1])
        edges = [0, *(min(-(-s0 * B // T), nt) for s0, _ in segs[1:]), nt]
        parts = None
    else:
        right_k = ld_int8.band_extent(hi, B)[1]
        totals = None
    progress(0, n_rows)
    done = 0
    for i, (s0, nb) in enumerate(segs):
        if cuda:
            x0, x1 = edges[i], edges[i + 1]
            if x1 > x0:
                seg = range_partials(*args, x0, x1, band=band, block_size=B,
                                     annot=annot, **kw)
                if parts is None:       # the whole pass's partials
                    parts = [None if x is None else
                             x.new_zeros((nt, *x.shape[1:])) for x in seg]
                for whole, x in zip(parts, seg):
                    if x is not None:
                        whole[x0:x1] = x
                del seg
            torch.cuda.current_stream(g.device).synchronize()
        else:
            accs = ld_int8.sym_scan_segment(
                *args, s0, annot, block_size=B, right_k=right_k,
                n_scan_blocks=nb, dot_dtype=ld_int8.dot_dtype_of(g), **kw)
            totals = accs if totals is None else tuple(
                a + b for a, b in zip(totals, accs))
        done = min(done + nb * B, n_rows)
        progress(done, n_rows)
    return fold_partials(*parts) if cuda else totals


def sym_credits(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                rsq_thr: float, *, n_samples: int, has_missing: bool,
                block_size: int, pivot_rows: int | None = None, annot=None):
    """Un-finalized credit vectors ``(l2, ws, poison, l2d, wsd, wse)`` of
    the symmetric pass over all pivot rows; with ``annot``, float32
    ``(rows, p)``, also the two ``(rows, p)`` per-annotation accumulators
    ``(l2_annot, l2d_annot)``: each pair's credit weighted by its
    neighbour's annotation row.

    CPU tensors run the twin with ``block_size`` pivot blocks; CUDA
    tensors run the kernel, whose tile is :func:`tile` of the branch, on
    the operands' type (int8, or bf16 tensors for ``--dot-dtype bf16``).

    ``pivot_rows`` (one band of the streaming route): only the first
    ``pivot_rows`` rows are pivots.  The rows after them, the halo, are
    neighbours only; their windows are emptied, so the kernel's CTAs of
    halo pivot tiles exit at once and the twin scans the pivot blocks
    only.  Every pair is then credited once, by the band that holds its
    left member: entries ``[:pivot_rows]`` are the pivots' credits and
    ``[pivot_rows:]`` the halo rows' column credits.
    """
    rows = g.shape[0]
    if pivot_rows is not None:
        lo, hi = lo.clone(), hi.clone()
        lo[pivot_rows:] = rows
        hi[pivot_rows:] = -1
    if g.device.type == "cpu":
        _, right_k = ld_int8.band_extent(hi, block_size)
        scan = rows if pivot_rows is None else pivot_rows
        return ld_int8.sym_scan_segment(
            g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr, 0,
            block_size=block_size, right_k=right_k, n_samples=n_samples,
            n_scan_blocks=-(-scan // block_size), has_missing=has_missing,
            annot=annot, dot_dtype=ld_int8.dot_dtype_of(g))
    if g.device.type != "cuda":
        raise ValueError(f"no LD kernel for device {g.device}")
    return _launch(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                   rsq_thr, n_samples, has_missing, annot)
