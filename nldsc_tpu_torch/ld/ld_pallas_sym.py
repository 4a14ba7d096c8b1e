"""Fused symmetric int8 LD pass: the wrapper of the hand-written kernel.

The kernel (``csrc/ld_sym.cu``) is the Hopper port of
``nldsc_tpu/ld/ld_pallas_sym.py::_kernel``.  One CTA takes a pivot tile
and one neighbour tile of its right half-band, accumulates the exact
int8 products over all samples with ``wgmma`` on operands that a TMA
ring brings into shared memory, and keeps the whole adjusted-r²
epilogue in registers; it writes only per-tile row and mirrored-column
partial sums, which :func:`_fold` reduces in a fixed order
(bitwise-reproducible, no float atomics).  On rows of at least
:data:`CLUSTER_MIN_STAGES` ring stages (UK Biobank widths) the CTAs run
in thread-block clusters of :data:`CLUSTER` (two pivot tiles by two
neighbour tiles) that multicast each shared tile's loads to the CTAs that
use it and stream the samples in step; narrower rows run the plain launch
(:func:`cluster_shape`).

Geometry: pivot and neighbour tiles are :data:`TILE_CLEAN` rows on the
clean (3-product) branch and :data:`TILE_MISSING` rows on the missing
(8-product) branch.  Each pivot tile's right extent comes from its rows'
window ends (``hi``), not from a static band depth.  Callers pad the
rows to :data:`ROW_ALIGN`, a multiple of both tiles, before they know
which branch runs, and the samples to a multiple of 128 (one ring
stage), as the pipeline does.

With ``annot`` (partitioned LD scores) the kernel's annotation epilogue
also contracts each tile's masked values with the neighbours' annotation
rows, on the tensor cores (tf32 hi + lo, three products, float32
accumulators), and writes per-tile ``(T, p)`` partials once, which
:func:`_fold_annot` reduces the same way.  The reference computes those
contractions outside its Pallas kernel; here they are part of the
hand-written one.  A clean-branch launch takes at most
:func:`annot_max` annotations (its row credits stay in registers); the
wrapper launches once per group of them.

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
(:func:`sym_credits_segmented`) run so.  The segments write straight into
the whole pass's partials (``out=``): the plain ones zero-filled once,
the annotation ones never (the kernel writes every slot), no copy.

On a CPU tensor the wrapper runs the plain twin
(:func:`nldsc_tpu_torch.ld.ld_int8.sym_scan_segment`, with the
contraction of the operands' dtype); on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import bisect
import ctypes
import itertools
import math
from collections import Counter

import torch

from .. import _build
from ..core.numerics import recip_f32
from . import ld_int8

#: pivot and neighbour rows per CTA of the kernel's clean and missing
#: branches, and the row alignment that serves both
TILE_CLEAN = 128
TILE_MISSING = 64
ROW_ALIGN = math.lcm(TILE_CLEAN, TILE_MISSING)
#: pivot tiles x neighbour tiles of one thread-block cluster of a
#: clustered launch (``ld_sym.cu``'s CP x CN): the CTAs that share a tile
#: load it once between them
CLUSTER = (2, 2)
#: the ring stages of a row (N_pad over the samples a stage holds: 128
#: int8, 64 bf16) from which a launch of the clean (False) or missing
#: (True) branch runs in clusters: the clean branch from 131,072 int8 or
#: 65,536 bf16 samples, the missing one from 32,768 or 16,384.  On
#: narrower rows L2 serves the shared tiles to CTAs that run apart, and
#: the clusters' costs (120 of the 132 multiprocessors hold clusters of
#: four; a pivot pair's clusters carry dead members) match or outweigh the
#: halved loads (measured on the H100 in turns: PERF.md §6)
CLUSTER_MIN_STAGES = {False: 1024, True: 256}

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
#: the sets of partials buffers allocated by :func:`new_partials`
partials_allocs = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 14 + [ctypes.c_int] * 6 + [ctypes.c_float] * 5 + [
    ctypes.c_int] * 3 + [_P]


def _library() -> ctypes.CDLL:
    lib = _build.load("ld_sym")
    if lib.ld_sym_launch.argtypes is None:
        # the library's geometry is checked once, when it is first bound:
        # a launch of the pass with progress is 16 calls of this
        for f in (lib.ld_sym_tile, lib.ld_sym_annot_max, lib.ld_sym_cluster):
            f.argtypes = [ctypes.c_int]
            f.restype = ctypes.c_int
        lib.ld_sym_max_clusters.argtypes = [ctypes.c_int] * 4
        lib.ld_sym_max_clusters.restype = ctypes.c_int
        if (lib.ld_sym_tile(0), lib.ld_sym_tile(1)) != (TILE_CLEAN,
                                                        TILE_MISSING):
            raise RuntimeError("ld_sym.cu and ld_pallas_sym's tiles disagree")
        if (lib.ld_sym_cluster(1), lib.ld_sym_cluster(0)) != CLUSTER:
            raise RuntimeError("ld_sym.cu and ld_pallas_sym's clusters "
                               "disagree")
        lib.ld_sym_launch.restype = ctypes.c_int
        lib.ld_sym_launch.argtypes = _ARGTYPES
    return lib


def tile(has_missing: bool) -> int:
    """Pivot (and neighbour) rows per CTA of the branch that runs."""
    return TILE_MISSING if has_missing else TILE_CLEAN


def annot_max(has_missing: bool) -> int:
    """The most annotations one launch of the branch takes (the kernel's
    ``ld_sym_annot_max``)."""
    return _library().ld_sym_annot_max(int(has_missing))


def cluster_shape(n_pad: int, has_missing: bool, bf16: bool) -> tuple:
    """The cluster a launch on rows of ``n_pad`` samples runs in:
    :data:`CLUSTER` from :data:`CLUSTER_MIN_STAGES` ring stages of a row
    on, else ``(1, 1)``."""
    stages = n_pad // (64 if bf16 else 128)
    return CLUSTER if stages >= CLUSTER_MIN_STAGES[has_missing] else (1, 1)


#: (device index, has_missing, annot, bf16, clustered) -> the kernel's
#: clusters resident at once on that device
_max_clusters: dict = {}


def max_active_clusters(device, has_missing: bool, annot: bool, bf16: bool,
                        clustered: bool = True) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the instantiation on
    ``device``: the clusters of :data:`CLUSTER` (of one CTA when not
    ``clustered``) that run at once (a cluster's CTAs share a GPC, so
    their CTAs may be fewer than the multiprocessors), queried once per
    device and instantiation."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), has_missing, annot, bf16,
           clustered)
    if key not in _max_clusters:
        with torch.cuda.device(key[0]):
            n = _library().ld_sym_max_clusters(int(has_missing), int(annot),
                                               int(bf16), int(clustered))
        if n <= 0:
            raise RuntimeError("ld_sym cluster occupancy query failed: "
                               f"CUDA error {-n}")
        _max_clusters[key] = n
    return _max_clusters[key]


def cluster_tile_ctas(tile_hi: list, n_piv: int, n_tiles: int, band: int,
                      cluster: tuple = CLUSTER) -> list:
    """Per pivot tile below ``n_piv``, the CTAs of the running clusters
    of ``cluster`` that take it, dead members included: the CTAs
    :func:`wave_bounds` shares out.  ``tile_hi[x]`` (a list) is the last
    neighbour tile of pivot tile x (:func:`ld_int8.block_hi`).

    ``ld_sym.cu``'s grid: CTA (b, j) of a cluster takes pivot tile b and
    neighbour tile t = b0 + j, b0 = b rounded down to a multiple of CP,
    and owns slot t - b of tile b when that is in ``[0, band)``.  Pivot
    tile ``b0 + i`` is live against j in ``[i, i + e]``, e = min(tile_hi,
    n_tiles - 1, b + band - 1) - b; a pivot group's clusters that run
    are the CN-wide groups of j that meet the union of those intervals
    (one interval: CP <= 2), and a cluster with no live member exits at
    once."""
    cp, cn = cluster
    ext = [min(x_hi, n_tiles - 1, x + band - 1) - x
           for x, x_hi in enumerate(tile_hi[:n_piv])]
    if cp == 1:
        return [cn * (e // cn + 1) if e >= 0 else 0 for e in ext]
    out = []
    for b0 in range(0, n_piv, cp):
        spans = [(i, i + e) for i, e in enumerate(ext[b0:b0 + cp]) if e >= 0]
        n = 0
        if spans:
            lo = min(s for s, _ in spans)
            top = max(t for _, t in spans)
            n = cn * (top // cn - lo // cn + 1)
        out += [n] * min(cp, n_piv - b0)
    return out


def partials_shapes(n_tiles: int, band: int, T: int, p: int = 0) -> list:
    """The shapes of ``(fpart, ipart, apart)`` for ``n_tiles`` pivot
    tiles of ``T`` rows, ``band`` slots and ``p`` annotations (``apart``
    None without them)."""
    return [(n_tiles, band, 2, 2, T), (n_tiles, band, 2, 4, T),
            (n_tiles, band, 2, 2, T, p) if p else None]


def new_partials(n_tiles: int, band: int, T: int, p: int, device) -> tuple:
    """``(fpart, ipart, apart)`` (:func:`partials_shapes`): the plain
    partials zero-filled (a launch leaves the slots past a tile's window
    ends unwritten), the annotation partials not (a launch writes every
    slot of its pivot tiles, zeros included)."""
    global partials_allocs
    partials_allocs += 1
    fshape, ishape, ashape = partials_shapes(n_tiles, band, T, p)
    return (torch.zeros(fshape, dtype=torch.float32, device=device),
            torch.zeros(ishape, dtype=torch.int32, device=device),
            None if ashape is None else torch.empty(
                ashape, dtype=torch.float32, device=device))


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
                     annot=None, band: int | None = None, out=None,
                     out_tiles: int | None = None, check_band: bool = True,
                     clustered: bool | None = None):
    """One kernel launch (one per group of :func:`annot_max` annotations):
    the unfolded partials ``(fpart, ipart, apart)`` (``apart`` None
    without ``annot``) of :func:`_fold`'s layout.  The launch runs with
    the tensors' device current, whichever is current in the caller.
    ``band``: the slots per pivot tile, at least the rows' own right
    half-band depth (default: that depth; ``check_band=False`` trusts a
    given band, since the check waits for the device).  ``out``:
    partials to write into (:func:`new_partials`, or views of a larger
    set), of at least ``out_tiles`` pivot tiles (default: all the rows'),
    whose slots the launch writes; the pivot tiles past them write
    nothing (their windows must be empty).  Else new ones.
    ``clustered``: launch in clusters of :data:`CLUSTER` or plainly
    (default: :func:`cluster_shape`'s rule)."""
    global launches, missing_launches, annot_launches, bf16_launches
    _check_inputs(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                  has_missing, annot)
    bf16 = g.dtype == torch.bfloat16
    m_pad, n_pad = g.shape
    T = tile(has_missing)
    nt = m_pad // T
    p = 0 if annot is None else annot.shape[1]
    if clustered is None:
        clustered = cluster_shape(n_pad, has_missing, bf16) != (1, 1)
    with torch.cuda.device(g.device):
        if band is None or check_band:
            tile_hi, depth = ld_int8.band_extent(hi, T)
            if band is None:
                band = depth
            elif band < depth:
                raise ValueError(f"band {band} is below the rows' depth "
                                 f"{depth}")
        else:
            tile_hi = ld_int8.block_hi(hi, T)
        if out is None:
            out = new_partials(nt, band, T, p, g.device)
        else:
            _check_out(out, nt if out_tiles is None else out_tiles, band, T,
                       p, g.device)
        fpart, ipart, apart = out
        lib = _library()
        stream = torch.cuda.current_stream(g.device).cuda_stream
        mm = m if has_missing else g                # clean: never read
        step = p if annot is None else min(p, annot_max(has_missing))
        for q0 in range(0, max(p, 1), max(step, 1)):
            q = min(step, p - q0)
            err = lib.ld_sym_launch(
                g.data_ptr(), mm.data_ptr(), h.data_ptr(), scal.data_ptr(),
                lo.data_ptr(), hi.data_ptr(), usable.data_ptr(),
                dom_ok.data_ptr(), add_sd_zero.data_ptr(), tile_hi.data_ptr(),
                fpart.data_ptr(), ipart.data_ptr(),
                None if annot is None else annot.data_ptr() + 4 * q0,
                None if annot is None else apart.data_ptr() + 4 * q0,
                q, p, nt if out_tiles is None else out_tiles, nt, band, n_pad,
                float(n_samples), recip_f32(n_samples), float(n_pad),
                ld_int8.adj_constant(n_samples), ld_int8.f32(rsq_thr),
                int(has_missing), int(bf16), int(clustered), stream)
            if err != 0:
                raise RuntimeError(
                    f"ld_sym kernel launch failed: CUDA error {err}")
            launches += 1
            device_launches[str(g.device)] += 1
            missing_launches += int(has_missing)
            bf16_launches += int(bf16)
            annot_launches += int(annot is not None)
    return fpart, ipart, apart


def _check_out(out, n_tiles: int, band: int, T: int, p: int,
               device) -> None:
    """Raise unless ``out`` can take a launch's partials: the layouts of
    :func:`partials_shapes`, at least ``n_tiles`` tiles, contiguous, on
    ``device``."""
    for i, (x, sh) in enumerate(zip(out, partials_shapes(n_tiles, band, T,
                                                           p))):
        if sh is None:
            if x is not None:
                raise ValueError("out holds annotation partials without "
                                 "annot")
            continue
        dtype = torch.int32 if i == 1 else torch.float32
        if (x is None or tuple(x.shape[1:]) != sh[1:] or x.shape[0] < sh[0]
                or x.dtype != dtype or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"out must hold {dtype} {sh} partials on "
                             f"{device}")


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
                 band: int, block_size: int, annot=None, out=None,
                 out_tiles: int | None = None):
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
    neighbours only: their tiles give nothing.

    ``out`` (with ``out_tiles``): the partials to write the first
    ``out_tiles`` tiles' slots into, as :func:`_launch_partials` takes
    them; on the CPU the twin's are copied there.  Returns the partials
    written."""
    if g.device.type == "cpu":
        parts = ld_int8.sym_tile_partials(
            g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr,
            annot, tile=block_size, band=band, n_samples=n_samples,
            has_missing=has_missing, dot_dtype=ld_int8.dot_dtype_of(g))
        if out is None:
            return parts
        n = parts[0].shape[0] if out_tiles is None else out_tiles
        _check_out(out, n, band, block_size,
                   0 if annot is None else annot.shape[1], g.device)
        for dst, src in zip(out, parts):
            if src is not None:
                dst[:n] = src[:n]
        return out
    if g.device.type != "cuda":
        raise ValueError(f"no LD kernel for device {g.device}")
    return _launch_partials(g, m, h, scal, lo, hi, usable, dom_ok,
                            add_sd_zero, rsq_thr, n_samples, has_missing,
                            annot, band, out, out_tiles)


def range_partials(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                   rsq_thr: float, x0: int, x1: int, *, n_samples: int,
                   has_missing: bool, band: int, block_size: int,
                   annot=None, out=None, clustered: bool | None = None):
    """:func:`sym_partials` of the pivot tiles ``[x0, x1)`` alone: the
    rows ``[x0·T, min(x1·T + halo, rows))`` (``halo`` = ``(band - 1)·T``,
    T the kernel's tile on CUDA, ``block_size`` on the CPU), the halo
    rows' windows emptied (they are neighbours only: their tiles give
    nothing and the kernel's CTAs of them exit at once), and the first
    ``x1 - x0`` tiles' unfolded partials returned.  ``lo``/``hi`` index
    the given rows.  Every slot is computed from the rows of its two
    tiles, so the partials of consecutive ranges, put together in tile
    order, are those of one launch over all the tiles.

    ``band`` is the whole pass's (its depth bounds every range's), and on
    CUDA is not checked against the range's rows: checking would wait
    for the device.  ``out``: partials of at least ``x1 - x0`` tiles
    (views of tiles ``[x0, x1)`` of the whole pass's,
    :func:`new_partials`) that the range's slots are written into and
    returned, as the segments of :func:`sym_credits_segmented` do.
    ``clustered``: on CUDA, as :func:`_launch_partials` takes it."""
    T = tile(has_missing) if g.device.type == "cuda" else block_size
    r0, r1 = x0 * T, min((x1 + band - 1) * T, g.shape[0])
    lo, hi = lo[r0:r1] - r0, hi[r0:r1] - r0
    lo[(x1 - x0) * T:], hi[(x1 - x0) * T:] = r1 - r0, -1

    def rows(x):
        return None if x is None else x[r0:r1]

    sub = (rows(g), rows(m), rows(h), rows(scal), lo, hi, rows(usable),
           rows(dom_ok), rows(add_sd_zero), rsq_thr)
    if g.device.type == "cuda":
        got = _launch_partials(*sub, n_samples, has_missing, rows(annot),
                               band, out, x1 - x0, check_band=False,
                               clustered=clustered)
    else:
        got = sym_partials(*sub, n_samples=n_samples,
                           has_missing=has_missing, band=band,
                           block_size=block_size, annot=rows(annot),
                           out=out, out_tiles=x1 - x0)
    return tuple(None if x is None else x[:x1 - x0] for x in got)


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


def wave_bounds(ctas: list, n: int, sms: int, align: int = 1) -> list:
    """Tile boundaries ``[0, b_1, ..., b_{n-1}, n_tiles]`` of ``n``
    launches over pivot tiles of ``ctas[x]`` CTAs each (``n`` at most
    the tiles).  The waves of one launch over all the tiles (``sms``
    CTAs a wave) are shared out evenly, and launch i takes the most tiles
    whose CTAs fit in its waves (at least one, leaving one for each later
    launch; the last takes the rest).  So no launch but the last leaves
    most multiprocessors idle while a last wave of a few CTAs runs, and
    the launches take about the waves of one launch.  With ``align`` (the
    cluster's pivot tiles) the launches take whole groups of ``align``
    tiles, where there are at least ``n`` groups."""
    nt = len(ctas)
    if align > 1 and -(-nt // align) >= n:
        units = [sum(ctas[x:x + align]) for x in range(0, nt, align)]
        return [min(align * x, nt) for x in wave_bounds(units, n, sms)]
    cum = list(itertools.accumulate(ctas, initial=0))
    waves = -(-cum[-1] // sms)
    bounds = [0]
    for i in range(1, n):
        share = round(i * waves / n) - round((i - 1) * waves / n)
        x = bisect.bisect_right(cum, cum[bounds[-1]] + share * sms) - 1
        bounds.append(min(max(x, bounds[-1] + 1), nt - (n - i)))
    return bounds + [nt]


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

    CUDA tensors launch the kernel once per segment that holds a pivot
    tile of the kernel (:func:`range_partials`, the whole pass's band),
    each writing its pivot tiles' slots straight into the whole pass's
    partials (:func:`new_partials`), all enqueued before the first wait:
    an event after each launch, and a segment's tick once the launch
    that holds its last tile has completed.  The launches' tiles are cut
    at whole waves of the kernel's clusters (:func:`wave_bounds` over the
    CTAs of :func:`cluster_tile_ctas`, :func:`max_active_clusters`
    clusters a wave), at whole clusters where it can, not at the
    segments' edges.  The clean branch's launches run plainly at any
    width (launches of about a wave keep their CTAs in step without
    clusters); the missing branch's follow :func:`cluster_shape`.  One fold of all the partials: the result equals one
    launch's bit for bit.  CPU tensors
    run the twin (``ld_int8.sym_scan_segment``) per segment and add the
    segments' credit vectors in order, as the reference adds its
    segments'."""
    segs = segments(n_rows, block_size, progress is not None)
    if len(segs) == 1:
        return sym_credits(g, m, h, scal, lo, hi, usable, dom_ok,
                           add_sd_zero, rsq_thr, n_samples=n_samples,
                           has_missing=has_missing, block_size=block_size,
                           annot=annot)
    args = (g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr)
    kw = dict(n_samples=n_samples, has_missing=has_missing)
    B = block_size
    rows_done = [min(sum(nb for _, nb in segs[:i + 1]) * B, n_rows)
                 for i in range(len(segs))]
    if g.device.type != "cuda":
        right_k = ld_int8.band_extent(hi, B)[1]
        totals = None
        progress(0, n_rows)
        for (s0, nb), done in zip(segs, rows_done):
            accs = ld_int8.sym_scan_segment(
                *args, s0, annot, block_size=B, right_k=right_k,
                n_scan_blocks=nb, dot_dtype=ld_int8.dot_dtype_of(g), **kw)
            totals = accs if totals is None else tuple(
                a + b for a, b in zip(totals, accs))
            progress(done, n_rows)
        return totals
    T = tile(has_missing)
    nt = g.shape[0] // T
    tile_hi, band = ld_int8.band_extent(hi, T)
    # segment i's last pivot tile ends at edges[i + 1]
    edges = [0, *(min(-(-s0 * B // T), nt) for s0, _ in segs[1:]), nt]
    n_launch = sum(x1 > x0 for x0, x1 in zip(edges, edges[1:]))
    bf16 = g.dtype == torch.bfloat16
    # a launch of about a wave runs its CTAs in step: on the clean branch
    # multicast then saves nothing the clusters' costs do not outweigh
    # (measured on the H100 in turns: PERF.md §6), so its segments launch
    # plainly
    shape = cluster_shape(g.shape[1], has_missing, bf16) if has_missing \
        else (1, 1)
    cp, cn = shape
    wave = cp * cn * max_active_clusters(g.device, has_missing,
                                         annot is not None, bf16,
                                         shape != (1, 1))
    bounds = wave_bounds(
        cluster_tile_ctas(tile_hi.tolist(), nt, nt, band, shape), n_launch,
        wave, cp)
    parts = new_partials(nt, band, T, 0 if annot is None else annot.shape[1],
                         g.device)
    stream = torch.cuda.current_stream(g.device)
    progress(0, n_rows)
    events = []
    for x0, x1 in zip(bounds, bounds[1:]):
        range_partials(*args, x0, x1, band=band, block_size=B, annot=annot,
                       out=tuple(None if x is None else x[x0:x1]
                                 for x in parts),
                       clustered=shape != (1, 1), **kw)
        events.append(torch.cuda.Event())
        events[-1].record(stream)
    for end, done in zip(edges[1:], rows_done):
        events[max(bisect.bisect_left(bounds, end) - 1, 0)].synchronize()
        progress(done, n_rows)
    return fold_partials(*parts)


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
