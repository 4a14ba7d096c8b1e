"""Split-missing symmetric integer engine: clean-rate LD with sparse missing.

Port of ``nldsc_tpu/ld/ld_split.py`` (the algebra and its exactness
argument are documented there).  The global engine pays the 8-product
missing epilogue on every tile once any genotype is missing; this engine
makes the missing cost proportional to the contaminated rows:

  pass 1 — the clean symmetric pass over all pairs (kernel K1,
      ``ld_pallas_sym.sym_credits(has_missing=False)``);
  pass 2 — :func:`split_corrections`: exact corrections
      ``δ = adj(r_exact) − adj(r_clean)`` for every pair with a
      contaminated member, x swept in row segments against the compact
      operand ``cat3 = [g_c; m_c; h_c]`` of the contaminated rows in reach.

On a CUDA tensor the corrections run in kernel K2 (``csrc/split_corr.cu``,
the Hopper port of ``scripts/pallas_corr_probe.py::kernel``): one launch
of its products mode computes the contaminated x rows' ``d = m_xc·cat3ᵀ``
for every segment, and one launch of its fused mode computes the x rows'
products on ``wgmma`` and turns them into δ-credits in registers, through
K1's per-pair function (``csrc/pair_epilogue.cuh``) so the clean baseline
cancels pass 1 bit for bit.  Neither ``cat3`` nor the (S, 3P) and (S, 2P)
products are ever built: the kernel reads g and the compact rows
``g_c``, ``m_c``, ``h_c`` through tensor maps at the coordinates of a
per-segment table (:func:`segment_table`).  On a CPU tensor the whole
computation is the plain torch twin :func:`split_corrections_plain`.

bf16 operands (g, h and ``m_c`` as bf16 tensors, ``--dot-dtype bf16``)
run K2's bf16 instantiations: the same exact products on bf16 ``wgmma``,
so every output equals the int8 run's bit for bit.  The operands' dtype
picks the instantiation, and on the CPU the twin's contraction
(``dot_dtype``, ``ld_int8.make_idot``).

With ``annot`` (partitioned LD scores) the corrections also return the
per-annotation δ-credits ``(l2a_δ, l2da_δ)``, each ``(M_pad, p)``: every
corrected pair's δ weighted by its neighbour's annotation row, in both
directions.  On the card the fused launch's annotation epilogue contracts
each live tile on the tensor cores (tf32 hi + lo) into one slot of
partials; a small kernel first finds the live tiles by the fused launch's
own rule (:func:`live_tiles`), whose count sizes the partials, and
another folds them in a fixed order (:func:`fold_annot`).  The twin
computes four skinny float32 contractions per segment.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

from .. import _build
from ..core.numerics import recip_f32
from . import ld_int8, ld_pallas_sym
from .ld_xla import finalize_outputs

#: default row-segment width of the corrections sweep (callers clamp to
#: the row count: ``min(SEG_ROWS_DEFAULT, m_pad)``)
SEG_ROWS_DEFAULT = 4096

#: launches of K2 in either mode, how many of them ran the fused δ
#: epilogue, how many of those its annotation epilogue too, and how many
#: launches of either mode ran on bf16 operands, made by
#: :func:`corr_products`, :func:`segment_products` and
#: :func:`split_corrections` (CUDA only)
corr_launches = 0
fused_launches = 0
annot_launches = 0
bf16_launches = 0
#: K2's launches (either mode) per device (``str(device)``)
device_launches: Counter = Counter()
#: the live tiles of the last fused launch with annotations and the bytes
#: of annotation partials that call allocated (one slot of row and column
#: partials per live tile, :func:`live_tiles`); launches of the kernels
#: that find the live tiles (:func:`live_tiles`) and fold the partials
#: (:func:`fold_annot`)
annot_tiles = 0
annot_partial_bytes = 0
reach_launches = 0
fold_launches = 0

#: x rows and compact columns of one CTA of K2, checked against the library
TILE_X = 128
TILE_C = 32


def annot_ld(p: int) -> int:
    """Floats per row of K2's annotation partials for ``p`` annotations:
    ``p`` rounded up to 8, so that each row starts on a 32-byte sector
    (checked against the library)."""
    return -(-p // 8) * 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def plan_split_v2(rowmiss: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  seg_rows: int, m_pad: int, pad_to: int = 8) -> dict:
    """Host-side plan for :func:`split_corrections` (v2 segmented form):
    the contaminated rows in order (``miss_idx``, padded with ``m_pad − 1``)
    and, per segment of x rows, the compact range of contaminated rows in
    its windows (``cs``, ``c_cnt``) and among its own rows (``xs``,
    ``x_cnt``); ``p_band``/``p_x`` pad those counts to ``pad_to``."""
    miss = np.flatnonzero(rowmiss).astype(np.int32)
    n_segs = max(1, -(-m_pad // seg_rows))
    cs = np.zeros(n_segs, np.int32)
    ce = np.zeros(n_segs, np.int32)
    xs = np.zeros(n_segs, np.int32)
    xe = np.zeros(n_segs, np.int32)
    for s in range(n_segs):
        s0, s1 = s * seg_rows, min((s + 1) * seg_rows, m_pad)
        cl = int(lo[s0:s1].min()) if s1 > s0 else m_pad
        ch = int(hi[s0:s1].max()) if s1 > s0 else -1
        cs[s] = np.searchsorted(miss, cl)
        ce[s] = np.searchsorted(miss, ch + 1)
        xs[s] = np.searchsorted(miss, s0)
        xe[s] = np.searchsorted(miss, s1)

    def pad_dim(count):
        p = int(count.max()) if len(count) else 0
        return max(pad_to, -(-p // pad_to) * pad_to)

    p_band = pad_dim(ce - cs)
    p_x = pad_dim(xe - xs)
    mm_pad = len(miss) + max(p_band, p_x)
    miss_idx = np.full(mm_pad, m_pad - 1, dtype=np.int32)
    miss_idx[: len(miss)] = miss
    return {"miss_idx": miss_idx, "cs": cs, "c_cnt": (ce - cs).astype(np.int32),
            "xs": xs, "x_cnt": (xe - xs).astype(np.int32),
            "p_band": p_band, "p_x": p_x, "mm_pad": mm_pad,
            "n_miss": len(miss), "n_segs": n_segs, "seg_rows": seg_rows}


def segment_table(plan: dict, m_pad: int) -> dict:
    """Per segment of ``plan``'s x rows, int32 numpy arrays of length
    ``n_segs``: ``s0``, its first row (clamped: the last segment overlaps
    the one before it); ``seg_lo``, the first row it owns (``s·S``);
    ``c0``/``c_cnt``, its compact columns in reach; ``x0``/``x_cnt``, its
    own contaminated rows in compact order; and ``drow`` (n_segs, S), the
    row of ``m_c[x0:x0 + p_x]`` that holds each of its x rows, or −1.

    Every real contaminated row lies in the owned rows of exactly one
    segment, so one scatter fills ``drow``.
    """
    S, n_segs, n_miss = plan["seg_rows"], plan["n_segs"], plan["n_miss"]
    if not 0 < S <= m_pad:
        raise ValueError(f"segment rows {S} out of range for {m_pad} rows")
    seg_lo = np.arange(n_segs, dtype=np.int64) * S
    s0 = np.minimum(seg_lo, m_pad - S)
    rows = np.asarray(plan["miss_idx"][:n_miss], dtype=np.int64)
    owner = rows // S
    drow = np.full((n_segs, S), -1, np.int32)
    drow[owner, rows - s0[owner]] = np.arange(n_miss) - plan["xs"][owner]
    return {"s0": s0.astype(np.int32), "seg_lo": seg_lo.astype(np.int32),
            "c0": np.asarray(plan["cs"], np.int32),
            "c_cnt": np.asarray(plan["c_cnt"], np.int32),
            "x0": np.asarray(plan["xs"], np.int32),
            "x_cnt": np.asarray(plan["x_cnt"], np.int32), "drow": drow}


def compact_missing_rows(g_raw: torch.Tensor, miss_idx) -> torch.Tensor:
    """(mm_pad, N) int8 missing indicators of the contaminated rows only.

    Built from the raw (pre-mask) codes, so the split route never holds a
    full-M indicator matrix: the gathered rows equal ``m[miss_idx]`` of
    ``preprocess_int8(materialize_m=True)`` bitwise (the padding entries,
    ``m_pad − 1``, gather a row that the plan's counts mask).
    """
    idx = torch.as_tensor(np.asarray(miss_idx), dtype=torch.long,
                          device=g_raw.device)
    return (g_raw.index_select(0, idx) < 0).view(torch.int8)


def _library() -> ctypes.CDLL:
    lib = _build.load("split_corr")
    if lib.split_corr_products_launch.argtypes is None:
        lib.split_corr_products_launch.argtypes = (
            [_P, _I] + [_P] * 3 + [_I] * 4 + [_P] + [_I] * 4
            + [_P, _I, _P, _I, _I, _P])
        lib.split_corr_products_launch.restype = _I
        lib.split_corr_fused_launch.argtypes = (
            [_P, _I] + [_P] * 3 + [_I, _P] + [_I] * 4 + [_P, _I]
            + [_P] * 20 + [_I] * 2 + [_F] * 6 + [_I, _P])
        lib.split_corr_fused_launch.restype = _I
        lib.split_annot_fold_launch.argtypes = (
            [_P] * 5 + [_I] * 6 + [_P] * 2)
        lib.split_annot_fold_launch.restype = _I
        lib.split_tile_reach_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P] * 2
        lib.split_tile_reach_launch.restype = _I
        lib.split_annot_ld.argtypes = [_I]
        lib.split_annot_ld.restype = _I
        lib.split_corr_tiles.argtypes = [ctypes.POINTER(_I)] * 2
        lib.split_corr_tiles.restype = _I
    tm, tc = _I(), _I()
    lib.split_corr_tiles(ctypes.byref(tm), ctypes.byref(tc))
    if (tm.value, tc.value) != (TILE_X, TILE_C) or any(
            lib.split_annot_ld(p) != annot_ld(p) for p in (1, 8, 53)):
        raise RuntimeError("split_corr.cu and ld_split's tiles disagree")
    return lib


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"split_corr {what} launch failed: CUDA error "
                           f"{err}")


def _products(x, blocks, boffs, seg, n_segs: int, rows_seg: int, P: int,
              out_a, ld_a: int, out_b=None, ld_b: int = 0) -> None:
    """One launch of K2's products mode (see ``split_corr.cu``), on the
    operand type of ``x`` (int8 or bf16, as every block)."""
    global corr_launches, bf16_launches
    bf16 = x.dtype == torch.bfloat16
    if -(-rows_seg // TILE_X) > 65535 or n_segs > 65535:
        raise ValueError(f"{rows_seg} rows in {n_segs} segments exceed the "
                         "kernel's grid")
    with torch.cuda.device(x.device):       # launch on the tensors' device
        err = _library().split_corr_products_launch(
            x.data_ptr(), x.shape[0], *(b.data_ptr() for b in blocks),
            blocks[0].shape[0], *boffs,
            None if seg is None else seg.data_ptr(), n_segs, rows_seg, P,
            x.shape[1], out_a.data_ptr(), ld_a,
            None if out_b is None else out_b.data_ptr(), ld_b, int(bf16),
            _stream(x))
    _check_launch(err, "products")
    corr_launches += 1
    device_launches[str(x.device)] += 1
    bf16_launches += int(bf16)


def corr_products_plain(x: torch.Tensor, cat: torch.Tensor, p2: int,
                        dot_dtype: str = "int8"):
    """Exact int32 ``x·catᵀ`` and, when ``p2``, ``h(x)·cat[:p2]ᵀ``, in
    plain torch: int8 matrix products on the CPU; on a GPU float32 products
    (exact: codes ≤ 2, so every sum stays below 2²⁴ while N_pad ≤ 2²²;
    TF32 must be off); under ``dot_dtype="bf16"`` the bf16 contraction
    ``ld_int8.bdot`` on either device."""
    def mm(u, v):
        if dot_dtype == "bf16":
            return ld_int8.bdot(u, v).to(torch.int32)
        if u.device.type == "cpu":
            return torch._int_mm(u, v.t().contiguous())
        return (u.float() @ v.float().t()).to(torch.int32)

    a = mm(x, cat)
    b = mm(2 * torch.clamp(x, max=1), cat[:p2]) if p2 else None
    return a, b


def _check_operand(name: str, t: torch.Tensor, n_pad: int,
                dtype=torch.int8) -> None:
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] != n_pad:
        raise ValueError(f"{name} must be {dtype} (rows, {n_pad})")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def corr_products(x: torch.Tensor, cat: torch.Tensor, p2: int = 0):
    """``(a, b)``: exact int32 ``a = x·catᵀ`` and, when ``p2 > 0``,
    ``b = h(x)·cat[:p2]ᵀ`` with ``h(x) = 2·min(x, 1)`` (else ``b`` is None).

    ``x`` (rows_x, N_pad) and ``cat`` (rows_cat, N_pad) are int8 (or both
    bf16) codes in {0, 1, 2}.  On a CUDA tensor this launches kernel K2's
    products mode once, on that operand type; on a CPU tensor it runs the
    plain products.
    """
    if x.device.type == "cpu":
        return corr_products_plain(x, cat, p2, ld_int8.dot_dtype_of(x))
    if x.device.type != "cuda":
        raise ValueError(f"no split-corrections kernel for device {x.device}")
    n_pad = x.shape[1]
    _check_operand("x", x, n_pad, x.dtype)
    _check_operand("cat", cat, n_pad, x.dtype)
    if cat.device != x.device:
        raise ValueError("x and cat must be on one device")
    rows_x, rows_cat = x.shape[0], cat.shape[0]
    if n_pad % 128 or not 0 <= p2 <= rows_cat or rows_x < 1 or rows_cat < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, cat "
                         f"{tuple(cat.shape)}, p2 {p2}")
    # cat as three blocks of P rows, the kernel's stacked operand: block q
    # starts at row q·P, and its columns past the end of cat are not kept
    P = max(-(-rows_cat // 3), -(-p2 // 2))
    a = torch.empty((rows_x, rows_cat), dtype=torch.int32, device=x.device)
    b = (torch.empty((rows_x, p2), dtype=torch.int32, device=x.device)
         if p2 else None)
    _products(x, (cat, cat, cat), (0, P, 2 * P), None, 1, rows_x, P, a,
              rows_cat, b, p2)
    return a, b


def segments(g, m_c, h, plan: dict):
    """Per segment of x rows, its bounds and the operands of its products:
    ``(s, s0, c0, c_cnt, x0, x_cnt, x, cat3, m_xc)``.

    ``s0`` is the clamped first row (the last segment overlaps the one
    before it; the overlap is masked), ``x = g[s0:s0 + S]``, ``cat3`` the
    compact rows ``[g_c; m_c; h_c]`` in reach of the segment's windows
    (``c0`` on, ``p_band`` of them, ``c_cnt`` real) and ``m_xc`` the
    compact indicators of the segment's own contaminated rows (``x0`` on,
    ``p_x`` of them, ``x_cnt`` real).  The row gathers are data movement.
    These are the plain twin's operands; the kernel builds none of them.
    """
    S, P, p_x = plan["seg_rows"], plan["p_band"], plan["p_x"]
    tab = segment_table(plan, g.shape[0])
    idx = torch.as_tensor(plan["miss_idx"], dtype=torch.long, device=g.device)
    g_c, h_c = g.index_select(0, idx), h.index_select(0, idx)
    for s in range(plan["n_segs"]):
        s0, c0, c_cnt, x0, x_cnt = (int(tab[k][s]) for k in (
            "s0", "c0", "c_cnt", "x0", "x_cnt"))
        crange = slice(c0, c0 + P)
        cat3 = torch.cat([g_c[crange], m_c[crange], h_c[crange]])
        yield (s, s0, c0, c_cnt, x0, x_cnt, g[s0:s0 + S], cat3,
               m_c[x0:x0 + p_x])


def _compact(scal, usable, dom_ok, miss_idx):
    idx = torch.as_tensor(miss_idx, dtype=torch.long, device=scal.device)
    return idx, scal.index_select(0, idx).contiguous(), usable[idx], dom_ok[idx]


def split_corrections_plain(g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss,
                            rsq_thr: float, own_hi: int, plan: dict,
                            annot=None, *, n_samples: int,
                            dot_dtype: str = "int8"):
    """The plain torch twin of :func:`split_corrections`, on any device.

    Mirrors ``nldsc_tpu/ld/ld_split.py:137-321``: the two big products and
    the compact product per segment, the four ``corr_from_dots``
    evaluations (exact and clean, x as i and c as i), the orientation
    selection, the masks and the threshold counts; with ``annot`` the four
    skinny contractions of the δ values with the compact rows' and the x
    rows' annotations.  ``dot_dtype``: the products' contraction
    (``corr_products_plain``).
    """
    m_pad, n_pad = g.shape
    ld_int8.check_dot_dtype(dot_dtype, n_pad)
    dev = g.device
    S, P, p_x = plan["seg_rows"], plan["p_band"], plan["p_x"]
    n, n_padf = float(n_samples), float(n_pad)
    adj_c = ld_int8.adj_constant(n_samples)
    rsq = ld_int8.f32(rsq_thr)
    pad_const = ld_int8.f32(n_padf - n)       # smm of a clean x: padding
    idx, scal_c, usable_c, dom_ok_c = _compact(scal, usable, dom_ok,
                                               plan["miss_idx"])
    i32 = torch.int32
    (l2_f, l2d_f, wse_f), (l2_cf, l2d_cf, wse_cf) = _zero_credits(
        m_pad, idx.shape[0], dev)
    if annot is not None:
        a_c = annot.index_select(0, idx)
        (l2a_f, l2da_f), (l2a_cf, l2da_cf) = (
            tuple(torch.zeros((rows_, annot.shape[1]), dtype=torch.float32,
                              device=dev) for _ in range(2))
            for rows_ in (m_pad, idx.shape[0]))

    def adj(r):
        return ld_int8.adj_r2(r, adj_c)

    for s, s0, c0, c_cnt, x0, x_cnt, x, cat3, m_xc in segments(
            g, m_c, h, plan):
        rows = slice(s0, s0 + S)
        xidx = torch.arange(s0, s0 + S, device=dev)
        xvalid = (xidx >= s * S)[:, None]
        lo_x, hi_x = lo[rows][:, None], hi[rows][:, None]
        usable_x, dom_ok_x = usable[rows][:, None], dom_ok[rows][:, None]
        cln_x = ~rowmiss[rows][:, None]
        sc_x = ld_int8.scal_views(scal[rows], "col")

        crange = slice(c0, c0 + P)
        cidx = idx[crange]
        vc = (torch.arange(P, device=dev) < c_cnt)[None, :]
        sc_c = ld_int8.scal_views(scal_c[crange], "row")
        usable_cc = usable_c[crange][None, :]
        dom_ok_cc = dom_ok_c[crange][None, :]

        a_i, b_i = corr_products_plain(x, cat3, 2 * P, dot_dtype)
        a_t, b_t = a_i.float(), b_i.float()
        xcid = idx[x0:x0 + p_x]
        vx = (torch.arange(p_x, device=dev) < x_cnt) & (xcid >= s0) & (
            xcid < s0 + S)
        d_t = corr_products_plain(m_xc, cat3, 0, dot_dtype)[0].float()
        locs = torch.clamp(xcid - s0, 0, S - 1)
        d_full = torch.zeros((S, 3 * P), dtype=torch.float32, device=dev)
        d_full.index_add_(0, locs, torch.where(vx[:, None], d_t, 0.0))

        dots_x = {"sgg": a_t[:, :P], "sgm": a_t[:, P:2 * P],
                  "sgh": a_t[:, 2 * P:], "shg": b_t[:, :P],
                  "shm": b_t[:, P:2 * P], "smg": d_full[:, :P],
                  "smm": torch.where(cln_x, pad_const, d_full[:, P:2 * P]),
                  "smh": d_full[:, 2 * P:]}
        rAx, rDax, rDbx = ld_int8.corr_from_dots(
            dots_x, sc_x, sc_c, n, n_padf, True, symmetric=True)
        rA0, rDa0, rDb0 = ld_int8.corr_from_dots(
            dots_x, sc_x, sc_c, n, n_padf, False, symmetric=True)
        # pass 1 evaluated each pair with its left member as i: entries
        # with c < x re-evaluate on the role-swapped dots and select
        dots_s = {"sgg": dots_x["sgg"], "sgh": dots_x["shg"],
                  "shg": dots_x["sgh"], "sgm": dots_x["smg"],
                  "smg": dots_x["sgm"], "smm": dots_x["smm"],
                  "smh": dots_x["shm"], "shm": dots_x["smh"]}
        rAxs, rDaxs, rDbxs = ld_int8.corr_from_dots(
            dots_s, sc_c, sc_x, n, n_padf, True, symmetric=True)
        rA0s, rDa0s, rDb0s = ld_int8.corr_from_dots(
            dots_s, sc_c, sc_x, n, n_padf, False, symmetric=True)
        swap = cidx[None, :] < xidx[:, None]

        def sel(direct, swapped):
            return torch.where(swap, swapped, direct)

        d_add = sel(adj(rAx) - adj(rA0), adj(rAxs) - adj(rA0s))
        aDax, aDa0 = sel(adj(rDax), adj(rDbxs)), sel(adj(rDa0), adj(rDb0s))
        aDbx, aDb0 = sel(adj(rDbx), adj(rDaxs)), sel(adj(rDb0), adj(rDa0s))

        in_win = (cidx[None, :] >= lo_x) & (cidx[None, :] <= hi_x)
        own = torch.minimum(xidx[:, None], cidx[None, :]) < own_hi
        pair = (in_win & usable_cc & usable_x & vc & xvalid & own
                & (cidx[None, :] != xidx[:, None]))
        dmA = pair & dom_ok_cc
        mirror = pair & cln_x
        dmB = mirror & dom_ok_x
        cnt_a = (aDax > rsq).to(i32) - (aDa0 > rsq).to(i32)
        cnt_b = (aDbx > rsq).to(i32) - (aDb0 > rsq).to(i32)

        l2_f[rows] += (d_add * pair).sum(dim=1)
        l2d_f[rows] += ((aDax - aDa0) * dmA).sum(dim=1)
        wse_f[rows] += torch.where(dmA, cnt_a, 0).sum(dim=1, dtype=i32)
        l2_cf[crange] += (d_add * mirror).sum(dim=0)
        l2d_cf[crange] += ((aDbx - aDb0) * dmB).sum(dim=0)
        wse_cf[crange] += torch.where(dmB, cnt_b, 0).sum(dim=0, dtype=i32)
        if annot is not None:
            dot = ld_int8.annot_dot
            a_x, a_cc = annot[rows], a_c[crange]
            l2a_f[rows] += dot(d_add * pair, a_cc)
            l2da_f[rows] += dot((aDax - aDa0) * dmA, a_cc)
            l2a_cf[crange] += dot((d_add * mirror).t(), a_x)
            l2da_cf[crange] += dot(((aDbx - aDb0) * dmB).t(), a_x)
    if annot is None:
        return _scatter_columns(idx, (l2_f, l2d_f, wse_f),
                                (l2_cf, l2d_cf, wse_cf))
    return _scatter_columns(idx, (l2_f, l2d_f, wse_f, l2a_f, l2da_f),
                            (l2_cf, l2d_cf, wse_cf, l2a_cf, l2da_cf))


def _zero_credits(m_pad: int, mm_pad: int, dev):
    """Zeroed (l2, l2d, wse) accumulators: full length and compact."""
    def three(size):
        return (torch.zeros(size, dtype=torch.float32, device=dev),
                torch.zeros(size, dtype=torch.float32, device=dev),
                torch.zeros(size, dtype=torch.int32, device=dev))

    return three(m_pad), three(mm_pad)


def _scatter_columns(idx, full, compact):
    # the real entries of miss_idx are unique rows; its padding entries
    # all point at row m_pad − 1 and carry credits that are exactly zero
    # (no pair is ever counted for them), so scattering them is harmless
    # and the result does not depend on the order of the additions
    return tuple(f.index_put_((idx,), c, accumulate=True)
                 for f, c in zip(full, compact))


def _operands(g, m_c, h, plan: dict) -> dict:
    """The device-side inputs of K2's launches: the compact blocks
    ``(g_c, m_c, h_c)`` and, from one host-to-device copy of
    :func:`segment_table` (a pageable copy waits for the stream), the
    compact rows' global indices (``cidx``, and ``idx`` as int64) and the
    table's rows as the kernel's (first x row, c0, c_cnt, seg_lo) fields,
    with the segments' own x rows (``seg_x``) or their contaminated rows
    in compact order (``seg_d``) as the first x row, and ``drow``."""
    tab = segment_table(plan, g.shape[0])
    mm_pad, n_segs, S = len(plan["miss_idx"]), plan["n_segs"], plan["seg_rows"]
    fields = [np.stack([tab[first], tab["c0"], tab["c_cnt"], tab["seg_lo"]],
                       axis=1).ravel() for first in ("s0", "x0")]
    host = np.concatenate([np.asarray(plan["miss_idx"], np.int32), *fields,
                           tab["drow"].ravel()])
    cidx, seg_x, seg_d, drow = torch.from_numpy(host).to(g.device).split(
        [mm_pad, 4 * n_segs, 4 * n_segs, n_segs * S])
    idx = cidx.long()
    return {"idx": idx, "cidx": cidx,
            "seg_x": seg_x.view(n_segs, 4), "seg_d": seg_d.view(n_segs, 4),
            "drow": drow.view(n_segs, S),
            "blocks": (g.index_select(0, idx), m_c, h.index_select(0, idx))}


def _d_products(m_c, ops: dict, plan: dict):
    """d (n_segs, p_x, 3P): each segment's ``m_xc·cat3ᵀ``, one launch."""
    P, p_x, n_segs = plan["p_band"], plan["p_x"], plan["n_segs"]
    d = torch.empty((n_segs, p_x, 3 * P), dtype=torch.int32, device=m_c.device)
    _products(m_c, ops["blocks"], (0, 0, 0), ops["seg_d"], n_segs, p_x, P, d,
              3 * P)
    return d


def segment_products(g, m_c, h, plan: dict):
    """K2's products mode over every segment of ``plan``, in two launches:

    * ``a`` (n_segs, S, 3P) and ``b`` (n_segs, S, 2P): the products of
      :func:`segments`' ``x`` with its ``cat3`` and ``cat3[:2P]`` (b with
      ``h(x)``);
    * ``d`` (n_segs, p_x, 3P): the products of its ``m_xc`` with ``cat3``.

    CUDA tensors only.  The split route computes only ``d`` this way; its
    ``a`` and ``b`` stay in the fused kernel's registers.
    """
    if g.device.type != "cuda":
        raise ValueError(f"no split-corrections kernel for device {g.device}")
    ops = _operands(g, m_c, h, plan)
    S, P, n_segs = plan["seg_rows"], plan["p_band"], plan["n_segs"]
    d = _d_products(m_c, ops, plan)
    a = torch.empty((n_segs, S, 3 * P), dtype=torch.int32, device=g.device)
    b = torch.empty((n_segs, S, 2 * P), dtype=torch.int32, device=g.device)
    _products(g, ops["blocks"], (0, 0, 0), ops["seg_x"], n_segs, S, P, a,
              3 * P, b, 2 * P)
    return a, b, d


def _fold(rpart_f, rpart_i, cpart_f, cpart_i, c0, mm_pad: int):
    """The fused kernel's partials summed in a fixed order: row credits
    over the compact-column tiles (each row is written by the one segment
    that owns it), column credits over the x tiles, then each segment's at
    its compact rows ``c0`` on by one scatter into a padded
    ``[n_segs, mm_pad]`` tensor and a sum over segments.  No atomics."""
    l2_f, l2d_f = rpart_f.sum(dim=0)
    wse_f = rpart_i.sum(dim=0, dtype=torch.int32)
    n_segs, _, _, P = cpart_f.shape
    cols = c0.long()[:, None] + torch.arange(P, device=c0.device)
    pad_f = torch.zeros((n_segs, 2, mm_pad), dtype=torch.float32,
                        device=c0.device).scatter_(
        2, cols[:, None].expand(n_segs, 2, P), cpart_f.sum(dim=1))
    pad_i = torch.zeros((n_segs, mm_pad), dtype=torch.int32,
                        device=c0.device).scatter_(
        1, cols, cpart_i.sum(dim=1, dtype=torch.int32))
    l2_c, l2d_c = pad_f.sum(dim=0)
    return (l2_f, l2d_f, wse_f), (l2_c, l2d_c,
                                  pad_i.sum(dim=0, dtype=torch.int32))


def live_tiles(seg, lo, hi, cidx, S: int, P: int) -> torch.Tensor:
    """(n_segs, n_xt, n_ct) bool: the tiles of the fused launch that
    compute, by the kernel's own rule (``split_corr.cu``, ``reaches``):
    an x row the segment owns whose window ``[lo, hi]`` reaches the span
    of the tile's real compact columns, ``lo <= cidx[last]`` and ``hi >=
    cidx[first]``.  ``seg`` (n_segs, 4) int32: each segment's first x
    row, first compact row, compact count and first owned row (the
    kernel's fields); ``lo``, ``hi``, ``cidx`` (the compact rows' global
    indices, sorted) int32.  On CUDA tensors one launch of
    ``split_corr.cu``'s reach kernel (that rule's own code), on CPU
    tensors :func:`live_tiles_plain`."""
    global reach_launches
    if seg.device.type == "cpu":
        return live_tiles_plain(seg, lo, hi, cidx, S, P)
    shape = (seg.shape[0], -(-S // TILE_X), -(-P // TILE_C))
    live = torch.empty(shape, dtype=torch.int32, device=seg.device)
    with torch.cuda.device(seg.device):
        err = _library().split_tile_reach_launch(
            seg.data_ptr(), lo.data_ptr(), hi.data_ptr(), cidx.data_ptr(),
            shape[0], S, P, live.data_ptr(), _stream(seg))
    _check_launch(err, "tile reach")
    reach_launches += 1
    return live.bool()


def live_tiles_plain(seg, lo, hi, cidx, S: int, P: int) -> torch.Tensor:
    """The plain version of :func:`live_tiles`, on any device.  A row's
    rule holds for the column tiles from the one holding the first
    compact column at or past ``lo`` to the one holding the last at or
    before ``hi``, so each row adds one interval to its x tile, summed as
    a difference array: integer work linear in the rows."""
    dev = seg.device
    n_segs, n_xt, n_ct = seg.shape[0], -(-S // TILE_X), -(-P // TILE_C)
    s0, c0, c_cnt, seg_lo = (f[:, None] for f in seg.long().unbind(1))
    gx = s0 + torch.arange(S, device=dev)                    # (n_segs, S)
    a = torch.searchsorted(cidx, lo[gx]) - c0                # first >= lo
    b = torch.searchsorted(cidx, hi[gx], right=True) - 1 - c0  # last <= hi
    first = torch.div(a, TILE_C, rounding_mode="floor").clamp(min=0)
    last = torch.minimum(torch.div(b, TILE_C, rounding_mode="floor"),
                         (c_cnt + TILE_C - 1) // TILE_C - 1)
    ok = (gx >= seg_lo) & (a < c_cnt) & (first <= last)
    tile = (torch.arange(n_segs, device=dev)[:, None] * n_xt
            + torch.arange(S, device=dev) // TILE_X) * (n_ct + 1)
    diff = torch.zeros(n_segs * n_xt * (n_ct + 1), dtype=torch.int32,
                       device=dev)
    one = ok.to(torch.int32).view(-1)
    diff.scatter_add_(0, torch.where(ok, tile + first, 0).view(-1), one)
    diff.scatter_add_(0, torch.where(ok, tile + last + 1, 0).view(-1), -one)
    return (diff.view(n_segs * n_xt, n_ct + 1).cumsum(1)[:, :n_ct] > 0).view(
        n_segs, n_xt, n_ct)


def tile_counts(plan: dict, lo: torch.Tensor,
                hi: torch.Tensor) -> tuple[int, int]:
    """The tiles of the fused launch of ``plan`` and those that compute,
    by :func:`live_tiles_plain` on host copies of the launch's inputs (the
    arrays :func:`_operands` uploads, and the windows ``lo``, ``hi``): no
    kernel on the device."""
    lo, hi = lo.cpu(), hi.cpu()
    tab = segment_table(plan, hi.shape[0])
    seg = np.stack([tab["s0"], tab["c0"], tab["c_cnt"], tab["seg_lo"]],
                   axis=1)
    live = live_tiles_plain(
        torch.from_numpy(seg), lo, hi,
        torch.from_numpy(np.asarray(plan["miss_idx"], np.int32)),
        plan["seg_rows"], plan["p_band"])
    return live.numel(), int(live.sum())


def tile_slots(live: torch.Tensor) -> torch.Tensor:
    """int32 of ``live``'s shape: each live tile's slot, numbered in
    (segment, x tile, column tile) order, else −1."""
    slot = live.view(-1).cumsum(0, dtype=torch.int32).view(live.shape) - 1
    return torch.where(live, slot, -1).to(torch.int32)


def fold_annot(rpart_a, cpart_a, slot, seg, cidx, S: int, m_pad: int,
               p: int):
    """The fused kernel's annotation partials folded in a fixed order into
    the full-length ``(l2a_δ, l2da_δ)``, each ``(m_pad, p)``
    (:func:`fold_annot_plain` says how): on CUDA tensors one launch of
    ``split_corr.cu``'s fold kernel, on CPU tensors the plain version.
    The two are bitwise equal: each sum runs from zero in one order."""
    global fold_launches
    if rpart_a.device.type == "cpu":
        return fold_annot_plain(rpart_a, cpart_a, slot, seg, cidx, S, m_pad,
                                p)
    n_segs, n_xt, n_ct = slot.shape
    if rpart_a.shape[-1] != annot_ld(p) or cpart_a.shape[-1] != annot_ld(p):
        raise ValueError(f"partials of {p} annotations have rows of "
                         f"{annot_ld(p)} floats")
    for t in (rpart_a, cpart_a, slot, seg, cidx):
        if not t.is_contiguous() or t.device != rpart_a.device:
            raise ValueError("the fold's inputs must be contiguous, on one "
                             "device")
    dev = rpart_a.device
    cmap = torch.full((m_pad,), -1, dtype=torch.int32, device=dev)
    cmap[cidx.long()] = torch.arange(cidx.shape[0], dtype=torch.int32,
                                     device=dev)
    out = torch.empty((2, m_pad, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library().split_annot_fold_launch(
            rpart_a.data_ptr(), cpart_a.data_ptr(), slot.data_ptr(),
            seg.data_ptr(), cmap.data_ptr(), n_segs, n_xt, n_ct, S, m_pad,
            p, out.data_ptr(), _stream(rpart_a))
    _check_launch(err, "annotation fold")
    fold_launches += 1
    return tuple(out)


def fold_annot_plain(rpart_a, cpart_a, slot, seg, cidx, S: int,
                     m_pad: int, p: int):
    """The plain version of :func:`fold_annot`, on any device.  The
    partials hold one slot per live tile (``slot``, :func:`tile_slots`):
    ``rpart_a`` (n_live, 2, TILE_X, annot_ld(p)), the credits to the x
    rows, and ``cpart_a`` (n_live, TILE_C, 2, annot_ld(p)), the mirrored
    credits to the compact columns; annotations [0, p) of each row.  Each x tile's row slots are consecutive: summed over
    its live column tiles in order; each compact row's column slots over
    the segments, then the x tiles, in order; both by
    ``torch.segment_reduce`` (one sequential sum per output element, from
    zero), so every sum has a fixed order: no atomics, and nothing is read
    that no tile wrote.  A contaminated row (``cidx``: the real compact
    rows' global indices, sorted) then gains its compact row's sum."""
    dev = rpart_a.device
    n_segs, n_xt, n_ct = slot.shape
    n_live, n_miss = rpart_a.shape[0], cidx.shape[0]
    TM, TC = TILE_X, TILE_C
    rpart_a, cpart_a = (t[..., :p].contiguous() for t in (rpart_a, cpart_a))
    rows = torch.segment_reduce(
        rpart_a.view(n_live, 2 * TM * p), "sum",
        lengths=(slot >= 0).sum(dim=2).view(-1),
        unsafe=True, initial=0.0).view(n_segs * n_xt * 2 * TM, p)
    # row gx belongs to segment gx // S, at gx - s0 in it
    s0 = seg[:, 0].long()
    gx = torch.arange(m_pad, device=dev)
    sg = gx // S
    xl = gx - s0[sg]
    at = ((sg * n_xt + xl // TM) * 2) * TM + xl % TM
    full = rows.index_select(0, (at + torch.arange(2, device=dev)[:, None]
                                 * TM).view(-1)).view(2, m_pad, p)
    # the live tiles' coordinates, by slot
    flat = slot.view(-1).long()
    tiles = torch.empty(n_live + 1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(flat >= 0, flat, n_live),
        torch.arange(flat.shape[0], device=dev))[:n_live]
    t_sx, ct = tiles // n_ct, tiles % n_ct
    t_s = t_sx // n_xt
    # each slot column's compact row (n_miss: past the segment's real
    # columns, not summed), sorted by compact row, then segment and x tile
    c_loc = ct[:, None] * TC + torch.arange(TC, device=dev)
    c = torch.where(c_loc < seg[t_s, 2].long()[:, None],
                    seg[t_s, 1].long()[:, None] + c_loc, n_miss)
    key = (c * (n_segs * n_xt) + t_sx[:, None]) * TC + torch.arange(
        TC, device=dev)
    order = torch.argsort(key.view(-1))
    lengths = torch.zeros(n_miss + 1, dtype=torch.int64, device=dev)
    lengths.scatter_add_(0, c.view(-1), torch.ones_like(c.view(-1)))
    compact = torch.segment_reduce(
        cpart_a.view(n_live * TC, 2 * p).index_select(0, order), "sum",
        lengths=lengths, unsafe=True, initial=0.0)[:n_miss].view(
            n_miss, 2, p).transpose(0, 1)
    rows_c = cidx.long()
    full[:, rows_c] = full[:, rows_c] + compact
    return tuple(full)


def _kernel_corrections(g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss,
                        rsq_thr: float, own_hi: int, plan: dict, annot=None,
                        *, n_samples: int):
    global corr_launches, fused_launches, annot_launches, bf16_launches
    global annot_tiles, annot_partial_bytes
    m_pad, n_pad = g.shape
    dev = g.device
    S, P, p_x, n_segs = (plan["seg_rows"], plan["p_band"], plan["p_x"],
                         plan["n_segs"])
    op = g.dtype
    if op not in ld_int8.OPERAND_DTYPES.values():
        raise ValueError(f"g must be int8 or bf16, got {op}")
    bf16 = op == torch.bfloat16
    for name, t in (("g", g), ("h", h), ("m_c", m_c)):
        _check_operand(name, t, n_pad, op)
    if scal.dtype != torch.float32 or tuple(scal.shape) != (
            m_pad, len(ld_int8.SCAL_FIELDS)) or not scal.is_contiguous():
        raise ValueError(f"scal must be contiguous float32 ({m_pad}, 9)")
    vecs = {"lo": (lo, torch.int32), "hi": (hi, torch.int32),
            "usable": (usable, torch.bool), "dom_ok": (dom_ok, torch.bool),
            "rowmiss": (rowmiss, torch.bool)}
    for name, (v, dtype) in vecs.items():
        if v.dtype != dtype or tuple(v.shape) != (m_pad,) or (
                not v.is_contiguous() or v.device != dev):
            raise ValueError(f"{name} must be contiguous {dtype} ({m_pad},)")
    if m_c.shape[0] != len(plan["miss_idx"]) or S > m_pad:
        raise ValueError("m_c and the plan disagree with g")
    if n_pad % 128 or -(-S // TILE_X) > 65535 or n_segs > 65535:
        raise ValueError(f"shape {tuple(g.shape)} with {n_segs} segments of "
                         f"{S} rows exceeds the kernel's range")

    ops = _operands(g, m_c, h, plan)
    if annot is not None:
        # the live tiles and their count, which sizes the annotation
        # partials: the one wait on the device, while it has nothing else
        # queued (the table's copy has just waited)
        slot = tile_slots(live_tiles(ops["seg_x"], lo, hi, ops["cidx"], S,
                                     P))
        n_live = int(slot.max()) + 1
    idx = ops["idx"]
    _, scal_c, usable_c, dom_ok_c = _compact(scal, usable, dom_ok, idx)
    d = _d_products(m_c, ops, plan)
    n_ct, n_xt = -(-P // TILE_C), -(-S // TILE_X)
    f32, i32 = torch.float32, torch.int32
    rpf = torch.empty((n_ct, 2, m_pad), dtype=f32, device=dev)
    rpi = torch.empty((n_ct, m_pad), dtype=i32, device=dev)
    cpf = torch.empty((n_segs, n_xt, 2, P), dtype=f32, device=dev)
    cpi = torch.empty((n_segs, n_xt, P), dtype=i32, device=dev)
    n = float(n_samples)
    ptrs = [t.data_ptr() for t in (
        scal, lo, hi, usable, dom_ok, rowmiss, scal_c, ops["cidx"], usable_c,
        dom_ok_c, rpf, rpi, cpf, cpi)]
    if annot is None:
        a_ptrs, p = [None] * 5, 0
    else:
        # one slot of row and column partials per live tile, each written
        # whole by its tile
        p = annot.shape[1]
        a_c = annot.index_select(0, idx)
        rpa = torch.empty((n_live, 2, TILE_X, annot_ld(p)), dtype=f32,
                          device=dev)
        cpa = torch.empty((n_live, TILE_C, 2, annot_ld(p)), dtype=f32,
                          device=dev)
        annot_tiles = n_live
        annot_partial_bytes = rpa.nbytes + cpa.nbytes
        a_ptrs = [t.data_ptr() for t in (annot, a_c, rpa, cpa, slot)]
    g_c, _, h_c = ops["blocks"]
    err = _library().split_corr_fused_launch(
        g.data_ptr(), m_pad, g_c.data_ptr(), m_c.data_ptr(), h_c.data_ptr(),
        m_c.shape[0], ops["seg_x"].data_ptr(), n_segs, S, P, n_pad,
        d.data_ptr(), p_x, ops["drow"].data_ptr(), *ptrs, *a_ptrs, p,
        int(own_hi), n, recip_f32(n_samples),
        float(n_pad), ld_int8.f32(float(n_pad) - n),
        ld_int8.adj_constant(n_samples), ld_int8.f32(rsq_thr),
        int(bf16), _stream(g))
    _check_launch(err, "fused")
    corr_launches += 1
    device_launches[str(dev)] += 1
    fused_launches += 1
    bf16_launches += int(bf16)
    full, compact = _fold(rpf, rpi, cpf, cpi,
                          ops["seg_x"][:, 1], m_c.shape[0])
    deltas = _scatter_columns(idx, full, compact)
    if annot is None:
        return deltas
    annot_launches += 1
    return deltas + fold_annot(rpa, cpa, slot, ops["seg_x"],
                               ops["cidx"][:plan["n_miss"]], S, m_pad, p)


def split_corrections(g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss,
                      rsq_thr: float, own_hi: int, plan: dict, annot=None, *,
                      n_samples: int):
    """δ-credit vectors ``(l2_δ f32, l2d_δ f32, wse_δ int32)``, full
    length, to add to the clean pass's un-finalized credits; with
    ``annot``, float32 ``(M_pad, p)``, also ``(l2a_δ, l2da_δ)``, each
    ``(M_pad, p)``, to add to the clean pass's annotation accumulators.

    ``m_c`` is the compact (mm_pad, N_pad) missing-indicator matrix of the
    contaminated rows in ``plan["miss_idx"]`` order
    (:func:`compact_missing_rows`); ``plan`` comes from
    :func:`plan_split_v2`.  ``own_hi`` credits a pair only when its left
    member is below it (in core: ``m_pad``).  CPU tensors run the plain
    twin (with the contraction of the operands' dtype); CUDA tensors run K2
    (two launches) on the operands' type (g, h and ``m_c`` int8, or bf16
    for ``--dot-dtype bf16``), or raise.
    """
    ld_int8.check_annot(annot, g)
    args = (g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss, rsq_thr,
            own_hi, plan, annot)
    if g.device.type == "cpu":
        return split_corrections_plain(*args, n_samples=n_samples,
                                       dot_dtype=ld_int8.dot_dtype_of(g))
    if g.device.type != "cuda":
        raise ValueError(f"no split-corrections engine for device {g.device}")
    # both launches run with the tensors' device current
    with torch.cuda.device(g.device):
        return _kernel_corrections(*args, n_samples=n_samples)


def ld_scores_split(g, m_c, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                    rowmiss, rsq_thr: float, plan: dict, *, block_size: int,
                    n_samples: int):
    """Finalized clean pass + segmented corrections: the split route of
    ``compute_ld_scores`` as one call."""
    l2_c, ws_c, poi_c, l2d_c, wsd_c, wse_c = ld_pallas_sym.sym_credits(
        g, g, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr,
        n_samples=n_samples, has_missing=False, block_size=block_size)
    l2_d, l2d_d, wse_d = split_corrections(
        g, m_c, h, scal, lo, hi, usable, dom_ok, rowmiss, rsq_thr,
        g.shape[0], plan, n_samples=n_samples)
    return finalize_outputs(l2_c + l2_d, l2d_c + l2d_d, ws_c, wsd_c,
                            wse_c + wse_d, poi_c, usable, add_sd_zero)
