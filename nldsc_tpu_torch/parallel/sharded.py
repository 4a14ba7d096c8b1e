"""SNP-sharded LD scores: each shard owns a contiguous range of rows.

Port of ``nldsc_tpu/parallel/sharded.py`` on a list of devices driven by
one process (:mod:`.mesh`), or by the ranks of a process group, each
holding its contiguous range of the shards.  Each shard holds ``rows``
rows, a multiple of
the row unit (``block_size``, and on the kernel's route
``lcm(block_size, ROW_ALIGN)``, so that no kernel tile straddles two
shards), preprocesses them where they lie (packed rows are sent as bytes
and unpacked on the shard), and receives the rows of its neighbours that
its windows reach, copied by :func:`.mesh.send` (several shards deep when
a window is wider than a shard).  Every output row is computed by the
shard that owns it.

Bodies:

symmetric (the integer engine, by default): each shard runs kernel K1
    (its plain twin on the CPU) on its rows and the first rows of its
    successors (the right halo), the halo rows' windows emptied, so that
    every pair is computed once, by the shard of its left member; every
    shard gets the run's global ``band`` (``ld_int8.band_extent`` over the
    global ``hi``).  The kernel's unfolded partials of the shard's own
    pivot tiles go to the first device: a pivot tile's slot ``(x, k)``
    holds its row credits and the column credits it gives tile x + k,
    halo tiles included, so nothing else has to move.  Put together in
    shard order they are the run's ``(n_tiles, band, …)`` partials, folded
    once (``ld_pallas_sym.fold_partials``): the reference ships unfolded
    per-pivot-block vectors and folds them in ascending block order
    (``sharded.py:311-340``).  The fold covers the in-core run's tiles,
    so the result is bitwise invariant in the device count and, on the
    card, equal to the in-core kernel run of the same branch.  Missing
    genotypes run the 8-product branch on every shard (the reference's
    sharded path has no split route); ``annot`` the annotation
    instantiation (on CUDA: the port's kernels are always symmetric).
full band (``--no-symmetric``, ``--engine f32``, and on the CPU
    partitioned runs, the reference's rule, ``sharded.py:424-426``):
    each shard runs ``ld_xla.band_pass`` on its rows with ``halo`` rows
    of its neighbours on each side, zero rows past the ends, and enough
    zero rows after them that no pivot block's band is clamped, so that
    every block sums the same columns on any device count.  The grid
    (``grid_sharded.py``) runs this body with a sample-sharded tile.

Across processes (``distributed.estimate_lds_mesh``) the bodies take the
global list of shards with only this rank's present: before the pass
each rank receives the rows of other ranks' shards that its windows
reach and sends its own that theirs reach (:func:`fetch_rows`), and
after it rank 0 gathers every shard's partials or accumulators and
per-row statistics (:func:`gather_first`) and folds once, as one process
does: the result is bitwise invariant in the process count too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import NLDSCParameterError
from ..io.plink import PackedBed
from ..ld import ld_int8, ld_pallas_sym, ld_xla, preprocess, windows
from . import mesh
from .mesh import send


@dataclass(frozen=True)
class ShardGeometry:
    """Rows of a SNP-sharded run: ``n_shards`` shards of ``rows`` rows
    (``m_pad`` in all), ``lo``/``hi``/``pos_ok`` over the padded rows
    (padding rows have empty windows).  Symmetric body: kernel ``tile``
    rows, ``band`` slots per pivot tile, ``halo`` rows after each shard,
    and the fold over the first ``fold_rows`` rows.  Full band:
    ``blk_lo``/``band_k`` of the pivot blocks, ``halo`` rows on each side
    and ``tail_rows`` zero rows after the right halo."""

    m: int
    n: int
    n_shards: int
    rows: int
    m_pad: int
    n_pad: int
    lo: np.ndarray
    hi: np.ndarray
    pos_ok: np.ndarray
    use_int8: bool
    symmetric: bool
    has_missing: bool
    pad_val: int
    tile: int
    band: int
    fold_rows: int
    blk_lo: np.ndarray | None
    band_k: int
    halo: int
    tail_rows: int


def sharded_geometry(m: int, n: int, positions: np.ndarray, config,
                     n_shards: int, device_type: str,
                     has_missing: bool = False,
                     annot: bool = False) -> ShardGeometry:
    """The geometry of ``n_shards`` SNP shards of an (m, n) matrix
    (``nldsc_tpu/parallel/sharded.py:472``).  The body: symmetric unless
    ``config.symmetric`` is False, the engine is f32 or, on the CPU,
    ``annot`` is set; the kernel's row unit on CUDA's symmetric body."""
    B = config.block_size
    use_int8 = config.use_int8 is not False
    symmetric = (config.symmetric is not False and use_int8
                 and not (annot and device_type == "cpu"))
    kernels = symmetric and device_type == "cuda"
    unit = math.lcm(B, ld_pallas_sym.ROW_ALIGN) if kernels else B
    m_pad = -(-m // (unit * n_shards)) * unit * n_shards
    lo, hi, pos_ok = windows.window_bounds(positions, config.ld_wind)
    pad = m_pad - m
    lo_p = np.concatenate([lo, np.full(pad, m_pad, np.int32)])
    hi_p = np.concatenate([hi, np.full(pad, -1, np.int32)])
    ok_p = np.concatenate([pos_ok, np.zeros(pad, bool)])
    blk_lo, band_k, tail = None, 0, 0
    if symmetric:
        T = ld_pallas_sym.tile(has_missing) if kernels else B
        band = ld_int8.band_extent(torch.from_numpy(hi_p), T)[1]
        halo = (band - 1) * T
        # the in-core run's rows: the kernel's alignment, or block_size
        row = ld_pallas_sym.ROW_ALIGN if kernels else B
        fold_rows = -(-m // row) * row
    else:
        T, band, fold_rows = B, 0, m_pad
        blk_lo, _, band_k = windows.band_blocks(lo, hi, B, m_pad // B)
        halo = -(-windows.max_halo_rows(lo, hi) // B) * B
        # a pivot block's band starts at most halo rows before the block
        # and spans band_k blocks: rows after the right halo so that no
        # band is clamped
        tail = max(0, band_k * B - B - halo)
    return ShardGeometry(
        m=m, n=n, n_shards=n_shards, rows=m_pad // n_shards, m_pad=m_pad,
        n_pad=-(-n // 128) * 128, lo=lo_p.astype(np.int32),
        hi=hi_p.astype(np.int32), pos_ok=ok_p, use_int8=use_int8,
        symmetric=symmetric, has_missing=has_missing,
        pad_val=-1 if has_missing or not use_int8 else 0, tile=T, band=band,
        fold_rows=fold_rows, blk_lo=blk_lo, band_k=band_k, halo=halo,
        tail_rows=tail)


def row_window(parts: list, s: int, a: int, b: int, dst: torch.device,
               received: dict | None = None) -> torch.Tensor:
    """Rows ``[a, b)`` of the row-sharded tensors ``parts`` (shard t holds
    rows ``[t·L, (t+1)·L)``) on ``dst``, for shard ``s``: its own rows as
    they are, the other shards' rows sent (:func:`.mesh.send`), zero rows
    outside ``[0, len(parts)·L)``.  ``parts[t]`` is None for another
    rank's shard: its rows in ``[a, b)`` are ``received[t]``, already on
    ``dst`` (:func:`fetch_rows`)."""
    like = parts[s]
    L = like.shape[0]
    total = L * len(parts)
    pieces = []
    if a < 0:
        pieces.append(like.new_zeros((min(b, 0) - a, *like.shape[1:])))
    for t, x in enumerate(parts):
        t0, t1 = max(a, t * L), min(b, (t + 1) * L)
        if t1 <= t0:
            continue
        if x is None:
            pieces.append(received[t])
            continue
        x = x[t0 - t * L:t1 - t * L]
        pieces.append(x if t == s else send(x, dst))
    if b > total:
        pieces.append(like.new_zeros((b - max(a, total), *like.shape[1:])))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def process_layout(shards: list) -> tuple[int, int]:
    """``(rank, k)`` of a global list of shards in which only this
    process's entries are present (the others None): the process holds
    shards ``[rank·k, (rank+1)·k)`` and rank r the r-th such range
    (``distributed.shard_rows_for_process``).  ``(0, len(shards))`` in
    one process."""
    local = [s for s, sh in enumerate(shards) if sh is not None]
    k = len(local)
    rank = local[0] // k
    if local != list(range(rank * k, (rank + 1) * k)):
        raise ValueError(f"this process's shards {local} are not a rank's "
                         "contiguous range")
    return rank, k


def _per_row(sh: dict) -> dict:
    """A shard's row-sharded tensors by name: its matrices and its per-row
    inputs, one device's."""
    if len(sh["mats"]) != 1:
        raise ValueError("a shard over several devices runs in one process")
    return {**sh["mats"][0], **sh["rows"]}


def fetch_rows(shards: list, geo: ShardGeometry, spans: list) -> dict:
    """The rows of other ranks' shards in this process's windows: for each
    of its shards s, ``{t: {name: rows [a, b) of shard t}}`` on s's
    device, where ``spans[s] = (a, b)`` is shard s's window; and the rows
    of its own shards in other ranks' windows, sent to them.  Every rank
    plans the moves from the geometry they share, one message per pair of
    ranks (:func:`.mesh.exchange`); nothing in one process."""
    rank, k = process_layout(shards)
    if k == len(shards):
        return {}
    L = geo.rows
    like = _per_row(shards[rank * k])
    outgoing, incoming, order = {}, {}, {}
    for s, (a, b) in enumerate(spans):
        for t in range(len(shards)):
            t0, t1 = max(a, t * L), min(b, (t + 1) * L)
            if t1 <= t0 or s // k == t // k:
                continue
            if t // k == rank:
                outgoing.setdefault(s // k, []).extend(
                    x[t0 - t * L:t1 - t * L]
                    for x in _per_row(shards[t]).values())
            elif s // k == rank:
                incoming.setdefault(t // k, []).extend(
                    ((t1 - t0, *x.shape[1:]), x.dtype) for x in like.values())
                order.setdefault(t // k, []).append((s, t))
    got = mesh.exchange(outgoing, incoming, shards[rank * k]["devices"][0])
    out = {}
    for r, pairs in order.items():
        flat = iter(got[r])
        for s, t in pairs:
            dev = shards[s]["devices"][0]
            out.setdefault(s, {})[t] = {name: next(flat).to(dev)
                                        for name in like}
    return out


def gather_first(outs: list, shards: list) -> list | None:
    """Every shard's list of tensors ``outs[s]`` on the first shard's first
    device, in shard order: the first shard's as they are, the others
    sent (:func:`.mesh.send`).  Another rank's shards (None) send theirs
    to rank 0, which receives them (:func:`.mesh.exchange`; each shard's
    list shaped as the first shard's) and returns the whole list; the
    other ranks return None."""
    rank, k = process_layout(shards)
    if rank:
        mesh.exchange({0: [x for o in outs if o is not None for x in o]},
                      {}, shards[rank * k]["devices"][0])
        return None
    first = shards[0]["devices"][0]
    specs = [(tuple(x.shape), x.dtype) for x in outs[0]]
    got = mesh.exchange({}, {r: specs * k for r in range(1, len(shards) // k)},
                        first)
    gathered = []
    for s, o in enumerate(outs):
        if o is None:
            j = s % k * len(specs)
            gathered.append(got[s // k][j:j + len(specs)])
        else:
            gathered.append([x if s == 0 else send(x, first) for x in o])
    return gathered


def annot_rows(annot, m: int, m_pad: int) -> np.ndarray | None:
    """The (m, p) annotation matrix as float32 rows padded with zeros to
    ``m_pad``; None without ``annot``."""
    if annot is None:
        return None
    annot = np.asarray(annot, dtype=np.float32)
    if annot.ndim != 2 or annot.shape[0] != m or annot.shape[1] < 1:
        raise NLDSCParameterError(f"annot must be ({m}, p >= 1), got "
                                  f"{annot.shape}")
    out = np.zeros((m_pad, annot.shape[1]), np.float32)
    out[:annot.shape[0]] = annot
    return out


def scatter_rows(genotypes, geo: ShardGeometry, devices) -> list:
    """Each shard's int8 ``(rows, n_pad)`` codes on its device: packed
    rows go as bytes and are unpacked on the shard
    (``nldsc_tpu/parallel/sharded.py:597-606``)."""
    L, m = geo.rows, geo.m
    if isinstance(genotypes, PackedBed):
        raw = np.full((geo.m_pad, genotypes.bytes_per_snp),
                      0x55 if geo.pad_val == -1 else 0x00, np.uint8)
        raw[:m] = genotypes.raw
        return [preprocess.unpack_bed(
            torch.from_numpy(raw[s * L:(s + 1) * L]).to(dev), geo.n,
            geo.n_pad, geo.pad_val) for s, dev in enumerate(devices)]
    g = np.full((geo.m_pad, geo.n_pad), geo.pad_val, np.int8)
    g[:m, :geo.n] = genotypes
    return [torch.from_numpy(g[s * L:(s + 1) * L]).to(dev)
            for s, dev in enumerate(devices)]


def preprocess_shard(codes: torch.Tensor, geo: ShardGeometry, config,
                     s: int, a_host=None) -> dict:
    """Shard ``s``'s preprocessed rows on the codes' device: ``mats`` (one
    dict per device of the shard: the integer engine's ``g``, ``h`` and,
    with missing genotypes, ``m``; the f32 engine's ``add``, ``res``),
    ``rows`` (the per-row inputs of the pass, exchanged with the halos)
    and ``stats`` (maf, rstd)."""
    dev = codes.device
    L = geo.rows
    ok = torch.from_numpy(geo.pos_ok[s * L:(s + 1) * L]).to(dev)
    rows = {}
    if geo.use_int8:
        pre = ld_int8.preprocess_int8(
            codes, ok, config.maf_thr, geo.n,
            assume_no_missing=not geo.has_missing,
            materialize_m=geo.has_missing)
        keys = ("g", "h", "m") if geo.has_missing else ("g", "h")
        mats = {k: pre.pop(k) for k in keys}
        rows["scal"] = ld_int8.stack_scalars(pre)
    else:
        pre = preprocess.preprocess_block(codes, ok, config.maf_thr, geo.n)
        mats = {k: pre.pop(k) for k in ("add", "res")}
    rows.update(usable=pre["usable"],
                dom_ok=pre["usable"] & (pre["rstd"]
                                        > ld_int8.f32(config.std_thr)),
                add_sd_zero=pre["add_sd_zero"])
    if a_host is not None:
        rows["annot"] = torch.from_numpy(a_host[s * L:(s + 1) * L]).to(dev)
    return {"devices": [dev], "mats": [mats], "rows": rows,
            "stats": (pre["maf"], pre["rstd"])}


def _windows(shards: list, s: int, a: int, b: int, received: dict,
             q: int | None, dst: torch.device) -> dict:
    """Rows ``[a, b)`` for shard s of each of the shards' matrices on
    their device q, or with ``q`` None of their per-row inputs, on
    ``dst`` (:func:`row_window`)."""
    def group(sh):
        return sh["rows"] if q is None else sh["mats"][q]

    return {name: row_window(
        [None if t is None else group(t)[name] for t in shards], s, a, b,
        dst, {u: r[name] for u, r in received.items()})
        for name in group(shards[s])}


def symmetric_pass(shards: list, geo: ShardGeometry, config) -> list | None:
    """The symmetric body: K1 (or its twin) per shard on its rows and
    right halo (``ld_pallas_sym.range_partials``), the partials of its
    pivot tiles gathered on the first device (:func:`gather_first`) and
    folded once.  Returns the per-row accumulators ``(l2, l2d, ws, wsd,
    wse, poison[, l2_annot, l2d_annot])`` of the ``m_pad`` rows on the
    first device; None on a rank other than 0 of a process group
    (``shards`` holds only this rank's entries; the halo rows of other
    ranks' shards come through :func:`fetch_rows`)."""
    L, T = geo.rows, geo.tile
    spans = [(s * L, min(s * L + L + geo.halo, geo.m_pad))
             for s in range(len(shards))]
    received = fetch_rows(shards, geo, spans)
    parts = []
    for s, sh in enumerate(shards):
        if sh is None:
            parts.append(None)
            continue
        dev = sh["devices"][0]
        a, b = spans[s]
        got = received.get(s, {})
        mats = _windows(shards, s, a, b, got, 0, dev)
        rows = _windows(shards, s, a, b, got, None, dev)
        win = torch.from_numpy(np.stack([geo.lo[a:b], geo.hi[a:b]]) - a
                               ).to(dev)
        ops = {"g": mats["g"], "m": mats.get("m", mats["g"]),
               "h": mats["h"]}
        del mats
        ld_int8.to_operands(ops, config.int8_dot_dtype)
        out = ld_pallas_sym.range_partials(
            ops["g"], ops["m"], ops["h"], rows["scal"], win[0], win[1],
            rows["usable"], rows["dom_ok"], rows["add_sd_zero"],
            config.rsq_thr, 0, L // T, n_samples=geo.n,
            has_missing=geo.has_missing, band=geo.band, block_size=T,
            annot=rows.get("annot"))
        del ops, rows
        parts.append([x for x in out if x is not None])
    gathered = gather_first(parts, shards)
    del parts
    if gathered is None:
        return None
    nf = geo.fold_rows // T
    folded = ld_pallas_sym.fold_partials(
        *(torch.cat(x)[:nf] for x in zip(*gathered)))
    del gathered
    pad = geo.m_pad - geo.fold_rows
    l2, ws, poi, l2d, wsd, wse, *acc_a = (
        F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)) for x in folded)
    return [l2, l2d, ws, wsd, wse, poi, *acc_a]


def full_band_pass(shards: list, geo: ShardGeometry, config,
                   make_tile) -> list | None:
    """The full-band body: per shard ``ld_xla.band_pass`` over its pivot
    rows with ``geo.halo`` neighbour rows on each side (and
    ``geo.tail_rows`` zero rows), the tile ``make_tile(mats, rows, lead)``
    of its extended rows (``mats`` one dict per device of the shard, as
    :func:`preprocess_shard` gives them; ``rows`` on the shard's first
    device, ``lead``).  Returns ``band_pass``'s per-row accumulators of
    the ``m_pad`` rows on the first shard's first device; in a process
    group, as :func:`symmetric_pass` does."""
    L, H, B = geo.rows, geo.halo, config.block_size
    spans = [(s * L - H, s * L + L + H + geo.tail_rows)
             for s in range(len(shards))]
    received = fetch_rows(shards, geo, spans)
    outs = []
    for s, sh in enumerate(shards):
        if sh is None:
            outs.append(None)
            continue
        lead = sh["devices"][0]
        r0 = s * L
        a, b = spans[s]
        got = received.get(s, {})
        mats = [_windows(shards, s, a, b, got, q, dev)
                for q, dev in enumerate(sh["devices"])]
        rows = _windows(shards, s, a, b, got, None, lead)
        win = torch.from_numpy(np.stack([geo.lo[r0:r0 + L],
                                         geo.hi[r0:r0 + L]])).to(lead)
        accs = ld_xla.band_pass(
            make_tile(mats, rows, lead), win[0], win[1], rows["usable"],
            rows["dom_ok"], rows["add_sd_zero"],
            geo.blk_lo[r0 // B:(r0 + L) // B], config.rsq_thr,
            rows.get("annot"), block_size=B, band_k=geo.band_k,
            n_samples=geo.n, n_pivots=L, g0=a, piv_off=H, m_pad=geo.m_pad)
        del mats, rows
        outs.append(list(accs))
    gathered = gather_first(outs, shards)
    return None if gathered is None else [torch.cat(x)
                                          for x in zip(*gathered)]


def finish(accs: list, usable, add_sd_zero, maf, rstd, annot, m: int
           ) -> dict:
    """The host result of per-row accumulators ``(l2, l2d, ws, wsd, wse,
    poison[, l2_annot, l2d_annot])``: the sentinels of
    ``ld_xla.finalize_outputs`` (and ``ld_int8.finalize_annot`` with
    ``annot``, the padded annotation rows), the first ``m`` rows."""
    from ..ld.pipeline import to_host_result  # noqa: PLC0415

    l2, l2d, ws, wsd, wse, poi, *acc_a = accs
    fin = ld_xla.finalize_outputs(l2, l2d, ws, wsd, wse, poi, usable,
                                  add_sd_zero)
    out = to_host_result(*fin, maf, rstd, m)
    if acc_a:
        l2_a, l2d_a = ld_int8.finalize_annot(*acc_a, annot, usable,
                                             add_sd_zero, poi, wsd)
        out["l2_annot"] = l2_a[:m].cpu().numpy().astype(np.float64)
        out["l2d_annot"] = l2d_a[:m].cpu().numpy().astype(np.float64)
    return out


def finish_shards(accs: list | None, shards: list, a_host, m: int
                  ) -> dict | None:
    """:func:`finish` with the shards' per-row flags and statistics
    gathered on the first device (:func:`gather_first`); None on a rank
    other than 0 of a process group, which sends its shards' to rank 0."""
    stats = gather_first(
        [None if sh is None else [sh["rows"]["usable"],
                                  sh["rows"]["add_sd_zero"], *sh["stats"]]
         for sh in shards], shards)
    if stats is None:
        return None
    first = shards[0]["devices"][0]
    usable, add_sd_zero, maf, rstd = (torch.cat(x) for x in zip(*stats))
    annot = None if a_host is None else torch.from_numpy(a_host).to(first)
    return finish(accs, usable, add_sd_zero, maf, rstd, annot, m)


def ld_scores_sharded_global(codes: list, positions: np.ndarray, config,
                             m: int, n: int, has_missing: bool,
                             annot=None) -> dict | None:
    """Sharded LD scores on rows already placed: ``codes[s]`` is shard
    s's int8 ``(rows, n_pad)`` codes on its device, padded as
    :func:`sharded_geometry` pads them (``pad_val``).  The entry point of
    ``distributed.estimate_lds_mesh``, whose shards read their own byte
    ranges of the .bed; each entry of ``codes`` is released (set to None)
    once its shard is preprocessed.  ``annot``: optional (M, p)
    annotation matrix.

    Across the processes of a process group, ``codes`` lists every
    shard of the run and holds this rank's (:func:`process_layout`), the
    others None: the halo rows cross the ranks (:func:`fetch_rows`), rank
    0 gathers every shard's partials or accumulators, folds and returns
    the result, and the other ranks return None.  Every rank must pass
    the same ``has_missing``."""
    if config.rsq_thr is None:
        raise NLDSCParameterError("resolve rsq_thr first (LDConfig.resolve_rsq)")
    local = [c for c in codes if c is not None]
    geo = sharded_geometry(m, n, positions, config, len(codes),
                           local[0].device.type, has_missing,
                           annot is not None)
    for c in local:
        if tuple(c.shape) != (geo.rows, geo.n_pad):
            raise ValueError(f"shard codes {tuple(c.shape)} != "
                             f"({geo.rows}, {geo.n_pad})")
    if geo.use_int8:
        ld_int8.check_dot_dtype(config.int8_dot_dtype, geo.n_pad)
    a_host = annot_rows(annot, m, geo.m_pad)
    shards = []
    for s in range(len(codes)):
        shards.append(None if codes[s] is None else
                      preprocess_shard(codes[s], geo, config, s, a_host))
        codes[s] = None                 # preprocessed: free the raw codes
    if geo.symmetric:
        accs = symmetric_pass(shards, geo, config)
    elif geo.use_int8:
        dot_dtype = config.int8_dot_dtype

        def int8_tile(mats, rows, lead):
            x = mats[0]
            ld_int8.to_operands(x, dot_dtype)
            return ld_int8.int8_tile(x["g"], x.get("m", x["g"]), x["h"],
                                     rows["scal"], n, has_missing, dot_dtype)
        accs = full_band_pass(shards, geo, config, int8_tile)
    else:
        accs = full_band_pass(
            shards, geo, config, lambda mats, rows, lead: ld_xla.f32_tile(
                mats[0]["add"], mats[0]["res"], n))
    return finish_shards(accs, shards, a_host, m)


def ld_scores_sharded(genotypes, positions: np.ndarray, config, devices,
                      annot=None) -> dict:
    """SNP-sharded in-core LD scores over ``devices`` (one shard each;
    ``mesh.snp_devices``): the result contract of
    ``pipeline.compute_ld_scores`` (``nldsc_tpu/parallel/sharded.py:565``).

    ``genotypes``: int8 (M, N) codes, or a
    :class:`~nldsc_tpu_torch.io.plink.PackedBed` whose bytes are sent to
    the shards and unpacked there.  ``annot``: optional (M, p) annotation
    matrix; adds ``l2_annot`` and ``l2d_annot``.  On CUDA every shard runs
    K1 (or raises), on the CPU its plain twin."""
    m, n = genotypes.shape
    packed = isinstance(genotypes, PackedBed)
    has_missing = (genotypes.has_missing if packed
                   else bool((np.asarray(genotypes) < 0).any()))
    geo = sharded_geometry(m, n, positions, config, len(devices),
                           torch.device(devices[0]).type, has_missing,
                           annot is not None)
    codes = scatter_rows(genotypes, geo, [torch.device(d) for d in devices])
    return ld_scores_sharded_global(codes, positions, config, m, n,
                                    has_missing, annot)
