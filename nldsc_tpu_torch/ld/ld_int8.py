"""Integer-exact banded LD engine: preprocessing and the plain twin (torch).

Genotypes are small integers, so every pairwise dot product the LD pass
needs is an int8×int8→int32 matrix product plus analytic corrections
(the algebra is documented in ``nldsc_tpu/ld/ld_int8.py``).  With ``g``
the additive codes (0 at missing), ``m`` the missing indicator and
``h = 2·min(g, 1)``, the products Sgg, Sgh, Shg (and Sgm, Smg, Smm, Smh,
Shm when genotypes are missing) are exact, and :func:`corr_from_dots`
turns them into the additive and both dominance correlations.

:func:`sym_scan_segment` is the plain PyTorch twin of the hand-written
CUDA kernel (``csrc/ld_sym.cu``): the same pair algebra, one pivot block
at a time, in f32 operations in the same order as the kernel's epilogue.

``dot_dtype`` picks the contraction, as ``make_idot`` does in the JAX
package: ``"int8"`` (int8 x int8 -> int32) or ``"bf16"`` (the codes as
bf16, float32 sums).  Both are exact: the codes are exact in bf16 and
every partial sum is an integer below 2^24 while N_pad <= 2^22
(:data:`BF16_MAX_SAMPLES`), so the two give the same floats.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import NLDSCParameterError
from ..core.numerics import fma_rn, recip_f32, sqrt_rn

#: per-SNP f32 scalar fields the engines consume, in stacking order
SCAL_FIELDS = ("am", "inv_sd", "inv_rstd", "v0", "v1", "v2",
               "gsum", "hsum", "cm")


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float.

    Thresholds and constants pass through this so that comparing or
    multiplying a float32 tensor with them gives the float32 result
    whatever precision torch computes the scalar operation in.
    """
    return float(np.float32(x))


def adj_constant(n_samples: int) -> float:
    """(n−1)/(n−2) in float32: the adjusted-r² factor."""
    n = np.float32(n_samples)
    return float((n - np.float32(1.0)) / (n - np.float32(2.0)))


def adj_r2(r, adj_c: float) -> torch.Tensor:
    """The adjusted r² ``1 - (1 - r²)·adj_c`` of float32 correlations as
    XLA compiles it: ``fma(-fma(-r, r, 1), adj_c, 1)``."""
    return fma_rn(-fma_rn(-r, r, 1.0), adj_c, 1.0)


def dom_class_stats(c0, c1, c2):
    """Exact closed forms of the dominance statistics in class counts.

    c0/c1/c2 : f32 exact-integer counts of genotype codes 0/1/2 among the
    valid samples of each SNP.  Returns ``(va, slope, rvar_sum, v0, v1,
    v2)``: ``va = n_valid²·var(a)``, ``rvar_sum = Σ residual²`` and the
    residual values at codes 0/1/2.
    """
    # XLA keeps 4·c0·c2 as one value (v1 reads it too) and contracts the
    # other two products: fma(c1, c2, fma(c0, c1, 4·c0·c2))
    c02 = 4.0 * c0 * c2
    va = fma_rn(c1, c2, fma_rn(c0, c1, c02))
    inv = 1.0 / torch.where(va > 0, va, torch.ones_like(va))
    v0 = -2.0 * c1 * c2 * inv
    v1 = c02 * inv
    v2 = -2.0 * c0 * c1 * inv
    rvar_sum = 4.0 * c0 * c1 * c2 * inv
    slope = 2.0 * c0 * (c1 + 2.0 * c2) * inv
    return va, slope, rvar_sum, v0, v1, v2


def finish_preprocess_int8(n_valid_raw, c1, c2, cm, pos_ok, maf_thr: float,
                           n_samples: int, constant_n_valid: bool = False
                           ) -> dict[str, torch.Tensor]:
    """Per-SNP scalar statistics from the three class counts.

    ``constant_n_valid``: the reference's ``n_valid_raw`` is the constant
    n (its in-core ``assume_no_missing`` preprocess), so XLA divides by it
    as a multiplication by ``f32(1/n)`` and folds ``va / n_valid / n``
    into one product by ``f32(f32(1/n)²)``.  Otherwise ``n_valid`` is a
    runtime divisor, and only the division by n becomes ``· f32(1/n)``.
    """
    inv_n = recip_f32(n_samples)
    maf_thr = f32(maf_thr)
    # an all-missing SNP has a NaN mean in the reference, so the MAF drop
    # test is false: it stays usable, as an additive-sum poison
    all_missing = n_valid_raw == 0
    n_valid = torch.clamp(n_valid_raw, min=1.0)
    c0 = n_valid - c1 - c2
    gsum = c1 + 2.0 * c2
    hsum = 2.0 * (c1 + c2)
    am = gsum * inv_n if constant_n_valid else gsum / n_valid

    f2 = am * 0.5
    maf = torch.minimum(f2, 1.0 - f2)
    usable = pos_ok & ((maf > maf_thr) | all_missing)

    va, _slope, rvar_sum, v0, v1, v2 = dom_class_stats(c0, c1, c2)
    if constant_n_valid:
        add_sd = sqrt_rn(va * f32(inv_n * inv_n))
    else:
        add_sd = sqrt_rn(va / n_valid * inv_n)
    add_sd_zero = usable & ((va <= 0.0) | all_missing)
    rstd = sqrt_rn(rvar_sum * inv_n)

    zero = torch.zeros_like(am)
    one = torch.ones_like(am)
    inv_sd = torch.where((add_sd > 0) & usable,
                         1.0 / torch.where(add_sd > 0, add_sd, one), zero)
    inv_rstd = torch.where((rstd > 0) & usable & ~add_sd_zero,
                           1.0 / torch.where(rstd > 0, rstd, one), zero)

    nan = torch.full_like(am, float("nan"))
    return {
        "am": am, "inv_sd": inv_sd, "inv_rstd": inv_rstd,
        "v0": v0, "v1": v1, "v2": v2,
        "gsum": gsum, "hsum": hsum, "cm": cm,
        "maf": torch.where(pos_ok & ~all_missing, maf, nan),
        "rstd": torch.where(usable & ~add_sd_zero, rstd, nan),
        "usable": usable, "add_sd_zero": add_sd_zero,
    }


#: genotypes per step of the per-row counts (4,096 rows at N = 16,384):
#: ``sum(dtype=float32)`` of a bool matrix first casts the whole of it to
#: float32, so the rows go in steps that bound that temporary to 256 MB at
#: any width (ROADMAP F5)
COUNT_GENOTYPES = 4096 * 16384


def step_rows(n_cols: int, genotypes: int) -> int:
    """Rows of one step over rows of ``n_cols`` columns that holds at most
    ``genotypes`` of them (at least one row)."""
    return max(1, genotypes // max(n_cols, 1))


def _row_counts(g: torch.Tensor, pred) -> torch.Tensor:
    """Exact float32 count, per row of ``g``, of the samples where
    ``pred(rows)`` holds."""
    step = step_rows(g.shape[1], COUNT_GENOTYPES)
    return torch.cat([pred(g[r:r + step]).sum(dim=1, dtype=torch.float32)
                      for r in range(0, g.shape[0], step)])


def code_matrices(genotypes: torch.Tensor, n_samples: int,
                  assume_no_missing: bool = False,
                  materialize_m: bool = True):
    """The int8 ``g``/``m``/``h`` matrices of int8 codes and their exact
    per-row class counts ``(n_valid_raw, c1, c2)`` (float32): the
    per-shard half of :func:`preprocess_int8`, whose counts add up
    exactly over shards of the samples."""
    g = genotypes
    n_pad = g.shape[1]
    if assume_no_missing:
        gq = g
        n_valid_raw = torch.full((g.shape[0],), float(n_samples),
                                 dtype=torch.float32, device=g.device)
    else:
        # codes are {-1, 0, 1, 2}: clamping at 0 masks the missing ones
        gq = torch.clamp(g, min=0)
        n_valid_raw = float(n_pad) - _row_counts(g, lambda x: x < 0)
    missing_m = materialize_m and not assume_no_missing
    mq = materialize_missing(g) if missing_m else gq   # alias: never read
    hq = torch.clamp(gq, max=1).mul_(2)      # in place: one M·N buffer
    c1 = _row_counts(gq, lambda x: x == 1)
    c2 = _row_counts(gq, lambda x: x == 2)
    return {"g": gq, "m": mq, "h": hq}, (n_valid_raw, c1, c2)


def preprocess_int8(genotypes: torch.Tensor, pos_ok: torch.Tensor,
                    maf_thr: float, n_samples: int,
                    assume_no_missing: bool = False,
                    materialize_m: bool = True,
                    constant_n_valid: bool | None = None
                    ) -> dict[str, torch.Tensor]:
    """int8 ``g``/``m``/``h`` matrices plus per-SNP f32 scalars.

    ``genotypes``: int8 (M_pad, N_pad) codes.  Sample padding must be
    negative (missing) unless ``assume_no_missing``, where the caller
    guarantees no negative code anywhere (zero padding): ``g`` is then
    used as it is and ``m`` aliases it — the clean kernels never read it.

    ``materialize_m=False`` skips the O(M·N) missing-indicator matrix on
    the missing path too (``m`` aliases ``g`` and is never read): the
    split engine reads the indicators only through the contaminated rows
    (:func:`nldsc_tpu_torch.ld.ld_split.compact_missing_rows`), and the
    global route builds them later with :func:`materialize_missing`.  The
    per-SNP statistics do not depend on it.

    ``constant_n_valid`` (default: ``assume_no_missing``): compute the
    scalars as the reference's in-core clean preprocess, whose valid count
    is a constant (:func:`finish_preprocess_int8`); its sharded and
    streamed routes count the valid samples at run time.
    """
    if constant_n_valid is None:
        constant_n_valid = assume_no_missing
    mats, (n_valid_raw, c1, c2) = code_matrices(
        genotypes, n_samples, assume_no_missing, materialize_m)
    # cm counts the missing codes, the sample padding included
    out = finish_preprocess_int8(n_valid_raw, c1, c2,
                                 float(genotypes.shape[1]) - n_valid_raw,
                                 pos_ok, maf_thr, n_samples,
                                 constant_n_valid=constant_n_valid)
    out.update(mats)
    return out


def materialize_missing(genotypes: torch.Tensor) -> torch.Tensor:
    """Full (M, N) int8 missing-indicator matrix from the raw codes: the
    deferred ``m`` of ``preprocess_int8(materialize_m=False)``, built only
    when the global 8-product epilogue is selected."""
    return (genotypes < 0).view(torch.int8)      # bool bytes are 0 or 1


def stack_scalars(pre: dict) -> torch.Tensor:
    """Stack the per-SNP engine scalars into one (M, 9) f32 matrix."""
    return torch.stack([pre[k] for k in SCAL_FIELDS], dim=1).contiguous()


def scal_views(mat: torch.Tensor, orient: str) -> dict[str, torch.Tensor]:
    """Broadcastable per-field views of a (rows, 9) scalar matrix:
    ``'col'`` gives (rows, 1) pivot-side vectors, ``'row'`` (1, rows)."""
    if orient == "row":
        return {k: mat[:, i][None, :] for i, k in enumerate(SCAL_FIELDS)}
    return {k: mat[:, i][:, None] for i, k in enumerate(SCAL_FIELDS)}


def idot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x · yᵀ over the sample axis: int8×int8→int32, exact, then f32."""
    return torch._int_mm(x, y.t()).to(torch.float32)


#: the tensor-core operand type of each ``dot_dtype``
OPERAND_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}
#: the most samples (N_pad) for which bf16 operands with float32 sums are
#: exact: every partial sum of codes <= 2 stays at or below 2^24
#: (``nldsc_tpu/ld/ld_int8.py:343``)
BF16_MAX_SAMPLES = 1 << 22


def bdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x · yᵀ over the sample axis with the codes as bf16 and float32 sums,
    exact (the JAX package's bf16 ``idot``).  A bf16 ``matmul`` would round
    its sums to bf16, so the product runs in full float32 (TF32 off) on the
    bf16-valued operands: every partial sum is an integer below 2^24."""
    return annot_dot(x.to(torch.bfloat16).float(),
                     y.to(torch.bfloat16).float().t())


def dot_dtype_of(x: torch.Tensor) -> str:
    """The ``dot_dtype`` of operand tensors: ``"bf16"`` for bf16 codes,
    else ``"int8"``."""
    return "bf16" if x.dtype == torch.bfloat16 else "int8"


def make_idot(dot_dtype: str):
    """The contraction of ``dot_dtype``: :func:`idot` or :func:`bdot`."""
    if dot_dtype not in OPERAND_DTYPES:
        raise ValueError(f"dot_dtype must be 'int8' or 'bf16', got "
                         f"{dot_dtype!r}")
    return idot if dot_dtype == "int8" else bdot


def check_dot_dtype(dot_dtype: str, n_pad: int) -> None:
    """Refuse bf16 operands past :data:`BF16_MAX_SAMPLES` samples, where
    their float32 sums would round."""
    make_idot(dot_dtype)
    if dot_dtype == "bf16" and n_pad > BF16_MAX_SAMPLES:
        raise NLDSCParameterError(
            f"--dot-dtype bf16 is exact only up to {BF16_MAX_SAMPLES} "
            f"padded samples, got {n_pad}; use --dot-dtype int8")


def to_operands(mats: dict, dot_dtype: str) -> None:
    """Replace the int8 code matrices of ``mats`` in place by the
    tensor-core operands of ``dot_dtype`` (bf16 copies made on their
    device; nothing for int8), one at a time so that each int8 matrix is
    freed once nothing refers to it; entries that alias one matrix keep
    aliasing its copy."""
    dtype = OPERAND_DTYPES[dot_dtype]
    copies: dict[int, torch.Tensor] = {}
    for key in list(mats):
        src = mats[key]
        if id(src) not in copies:
            copies[id(src)] = src.to(dtype)
        mats[key] = copies[id(src)]


def _dom_dot(sgg, sgh, sgu, sug, suh, suu, am_i, v0_j, v1_j, v2_j):
    """dot(a_c_i, r_j) over the genotype classes of j, with the products
    contracted as XLA contracts them (``core/numerics.py``)."""
    a1 = fma_rn(-am_i, suh - sug, sgh - sgg)
    a2 = fma_rn(-am_i, sug - 0.5 * suh, sgg - 0.5 * sgh)
    a0 = fma_rn(-am_i, suu - 0.5 * suh, sgu - 0.5 * sgh)
    return fma_rn(v2_j, a2, fma_rn(v0_j, a0, v1_j * a1))


def corr_from_dots(dots: dict, sc_i: dict, sc_j: dict, n: float,
                   n_padf: float, has_missing: bool, symmetric: bool = False):
    """(r_add, r_domA[, r_domB]) tiles from exact integer S-matrices.

    ``dots`` needs sgg, sgh (+ shg when symmetric; + sgm, smg, smm, smh
    (+ shm when symmetric) when has_missing), as f32.  r_domA pairs the
    additive of pivot i with the residual of neighbour j (reference
    orientation, ldscalc.h:38-41); r_domB the mirror.  The float32
    operations are those XLA compiles the reference into: the products
    contracted into their sums, and n's division a product by
    ``f32(1/n)``.
    """
    inv_n = recip_f32(n)
    sgg, sgh = dots["sgg"], dots["sgh"]
    am_i, am_j = sc_i["am"], sc_j["am"]
    if has_missing:
        sgu = sc_i["gsum"] - dots["sgm"]
        sug = sc_j["gsum"] - dots["smg"]
        suh = sc_j["hsum"] - dots["smh"]
        suu = n_padf - sc_i["cm"] - sc_j["cm"] + dots["smm"]
    else:
        sgu = sc_i["gsum"]
        sug = sc_j["gsum"]
        suh = sc_j["hsum"]
        suu = n

    ac = fma_rn(am_i * am_j, suu,
                fma_rn(-am_j, sgu, fma_rn(-am_i, sug, sgg)))
    r_add = ac * sc_i["inv_sd"] * sc_j["inv_sd"] * inv_n
    dom_a = _dom_dot(sgg, sgh, sgu, sug, suh, suu, am_i,
                     sc_j["v0"], sc_j["v1"], sc_j["v2"])
    r_dom_a = dom_a * sc_i["inv_sd"] * sc_j["inv_rstd"] * inv_n
    if not symmetric:
        return r_add, r_dom_a

    shg = dots["shg"]
    shu = (sc_i["hsum"] - dots["shm"]) if has_missing else sc_i["hsum"]
    dom_b = _dom_dot(sgg, shg, sug, sgu, shu, suu, am_j,
                     sc_i["v0"], sc_i["v1"], sc_i["v2"])
    r_dom_b = dom_b * sc_i["inv_rstd"] * sc_j["inv_sd"] * inv_n
    return r_add, r_dom_a, r_dom_b


def tile_products(g, m, h, has_missing: bool, dot_dtype: str,
                  symmetric: bool = False):
    """``dots(rows, cols)``: the exact products of the pivot rows ``rows``
    of ``g``/``m``/``h`` with their band rows ``cols`` that
    :func:`corr_from_dots` reads, float32 tiles: sgg, sgh (+ shg when
    ``symmetric``; + sgm, smg, smm, smh (+ shm) when ``has_missing``),
    contracted as ``dot_dtype`` says (:func:`make_idot`)."""
    idot = make_idot(dot_dtype)

    def dots(rows, cols):
        g_i, g_j, h_j = g[rows], g[cols], h[cols]
        out = {"sgg": idot(g_i, g_j), "sgh": idot(g_i, h_j)}
        if symmetric:
            out["shg"] = idot(h[rows], g_j)
        if has_missing:
            m_i, m_j = m[rows], m[cols]
            out.update(sgm=idot(g_i, m_j), smg=idot(m_i, g_j),
                       smm=idot(m_i, m_j), smh=idot(m_i, h_j))
            if symmetric:
                out["shm"] = idot(h[rows], m_j)
        return out
    return dots


def dots_tile(dots, scal, n_samples: int, n_pad: int, has_missing: bool):
    """The full-band engines' ``tile`` (``ld_xla.band_pass``) on a
    products function ``dots`` (:func:`tile_products`, or a sum over
    shards of the samples) and the rows' scalars: ``(r_add, r_dom)`` of
    the pivot rows ``rows`` against their band rows ``cols``
    (:func:`corr_from_dots`, not symmetric)."""
    n, n_padf = float(n_samples), float(n_pad)

    def tile(rows, cols):
        return corr_from_dots(dots(rows, cols), scal_views(scal[rows], "col"),
                              scal_views(scal[cols], "row"), n, n_padf,
                              has_missing)
    return tile


def int8_tile(g, m, h, scal, n_samples: int, has_missing: bool,
              dot_dtype: str):
    """The full-band engines' ``tile`` (``ld_xla.band_pass``) on the codes
    ``g``/``m``/``h`` and their scalars: two products (six with missing
    genotypes) and :func:`corr_from_dots` (the reference's
    ``corr_tiles``, not symmetric)."""
    return dots_tile(tile_products(g, m, h, has_missing, dot_dtype), scal,
                     n_samples, g.shape[1], has_missing)


def block_hi(hi: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per pivot block, the last block its rows' windows reach (int32;
    -1 for padding blocks, whose rows carry hi = -1), without waiting for
    the device."""
    nb = hi.shape[0] // block_size
    return torch.div(hi.view(nb, block_size).amax(dim=1), block_size,
                     rounding_mode="floor").to(torch.int32).contiguous()


def band_extent(hi: torch.Tensor, block_size: int) -> tuple[torch.Tensor, int]:
    """:func:`block_hi`, and the right half-band depth in blocks (at least
    1, at most the block count)."""
    nb = hi.shape[0] // block_size
    blk_hi = block_hi(hi, block_size)
    reach = blk_hi - torch.arange(nb, device=hi.device, dtype=torch.int32)
    return blk_hi, min(max(int(reach.max().item()) + 1, 1), nb)


def finalize_annot(l2_a, l2d_a, annot, usable, add_sd_zero, poison, wsd):
    """Sentinels of the partitioned accumulators: the self term added
    where the row is usable and its window holds no zero-additive-sd SNP,
    else NaN; ``l2d_annot`` NaN for unusable rows, and for a
    zero-additive-sd pivot NaN if a neighbour passed the dominance filter,
    else 0 (``nldsc_tpu/ld/ld_int8.py::finalize_annot``)."""
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=l2_a.device)
    good = (usable & (poison == 0))[:, None]
    l2_a = torch.where(good, annot + l2_a, nan)
    l2d_bad = torch.where(wsd > 0, nan, torch.zeros_like(nan))[:, None]
    l2d_a = torch.where(usable[:, None],
                        torch.where(add_sd_zero[:, None], l2d_bad, l2d_a),
                        nan)
    return l2_a, l2d_a


def check_annot(annot, g: torch.Tensor) -> None:
    """Raise unless ``annot`` is None or what the engines contract with
    the codes ``g``: a contiguous float32 ``(g.shape[0], p >= 1)`` tensor
    on ``g``'s device."""
    if annot is not None and not (
            isinstance(annot, torch.Tensor) and annot.dtype == torch.float32
            and annot.dim() == 2 and annot.shape[0] == g.shape[0]
            and annot.shape[1] >= 1 and annot.device == g.device
            and annot.is_contiguous()):
        raise ValueError(f"annot must be a contiguous float32 ({g.shape[0]}, "
                         "p >= 1) tensor on the genotypes' device")


def annot_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` in full float32: TF32 off for the call, whatever the
    process-wide setting."""
    if x.device.type != "cuda":
        return x @ y
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ y
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def ld_scores_int8(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                   blk_lo, blk_hi, rsq_thr: float, annot=None, *,
                   block_size: int, band_k: int, n_samples: int,
                   has_missing: bool, dot_dtype: str = "int8"):
    """Full-band LD pass in plain torch ops, on any device: each pivot
    block against its whole band (both sides), two int8 products per tile
    (six with missing data), row credits only (``ld_xla.band_pass`` with
    :func:`int8_tile`).  The engine of ``--no-symmetric``, and on the CPU
    of clean partitioned runs; the reference runs it outside any Pallas
    kernel (``nldsc_tpu/ld/ld_int8.py::ld_scores_int8``).

    ``blk_lo``: per pivot block, the first block its rows' windows reach
    (``windows.band_blocks``), on the host.  ``blk_hi`` is not read: the
    reference masks the band at its last block, which no window passes.
    Returns finalized ``(l2, l2d, ws, wsd, wse)``; with ``annot`` float32
    ``(M_pad, p)`` (padding rows 0), ``(l2_annot, l2d_annot)`` first.
    ``dot_dtype``: the contraction (:func:`make_idot`); under ``"bf16"`` it
    is a float32 product on the bf16 codes, not a library bf16 call, on
    either device.
    """
    from .ld_xla import band_pass, finalize_outputs  # noqa: PLC0415

    del blk_hi
    check_dot_dtype(dot_dtype, g.shape[1])
    l2_f, l2d_f, ws_f, wsd_f, wse_f, poi_f, *acc_a = band_pass(
        int8_tile(g, m, h, scal, n_samples, has_missing, dot_dtype), lo, hi,
        usable, dom_ok, add_sd_zero, blk_lo, rsq_thr, annot,
        block_size=block_size, band_k=band_k, n_samples=n_samples)
    fin = finalize_outputs(l2_f, l2d_f, ws_f, wsd_f, wse_f, poi_f, usable,
                           add_sd_zero)
    if annot is None:
        return fin
    return (*finalize_annot(*acc_a, annot, usable, add_sd_zero, poi_f,
                            wsd_f), *fin)


def sym_scan_segment(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                     rsq_thr: float, blk0: int = 0, annot=None, *,
                     block_size: int, right_k: int, n_samples: int,
                     n_scan_blocks: int, has_missing: bool,
                     dot_dtype: str = "int8"):
    """Credit accumulation of the symmetric pass over the pivot blocks
    ``[blk0, blk0 + n_scan_blocks)``: the plain twin of the CUDA kernel.

    Each pivot block multiplies only its right half-band; one tile
    credits both directions of every pair: row sums to the pivot rows
    (every j ≥ r0, j ≠ i) and mirrored column sums to the band rows
    (j ≥ r0 + B).  Returns the six un-finalized full-length credit
    vectors ``(l2, ws, poison, l2d, wsd, wse)``.

    ``annot``: float32 ``(M_pad, p)`` annotation matrix.  Adds the two
    ``(M_pad, p)`` accumulators ``(l2_annot, l2d_annot)`` to the return:
    four skinny float32 contractions per tile, the row direction with the
    band rows' annotations, the mirrored column direction (the tile
    transposed) with the pivot rows': each pair is weighted by its
    neighbour's annotation row.

    ``dot_dtype``: the contraction (:func:`make_idot`), as the kernel's
    int8 or bf16 instantiations compute it.
    """
    check_dot_dtype(dot_dtype, g.shape[1])
    return sym_scan(
        tile_products(g, m, h, has_missing, dot_dtype, symmetric=True),
        scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr, blk0, annot,
        block_size=block_size, right_k=right_k, n_samples=n_samples,
        n_pad=g.shape[1], n_scan_blocks=n_scan_blocks,
        has_missing=has_missing)


def sym_scan(dots, scal, lo, hi, usable, dom_ok, add_sd_zero,
             rsq_thr: float, blk0: int = 0, annot=None, *, block_size: int,
             right_k: int, n_samples: int, n_pad: int, n_scan_blocks: int,
             has_missing: bool):
    """:func:`sym_scan_segment` on a products function ``dots``
    (:func:`tile_products` with ``symmetric=True``, or its sum over
    shards of the samples) of ``n_pad`` padded samples; the rows are
    those of ``scal``."""
    m_pad = scal.shape[0]
    B = block_size
    right_rows = min(right_k * B, m_pad)
    n = float(n_samples)
    n_padf = float(n_pad)
    adj_c = adj_constant(n_samples)
    rsq = f32(rsq_thr)
    dev = scal.device

    l2_f = torch.zeros(m_pad, dtype=torch.float32, device=dev)
    l2d_f = torch.zeros_like(l2_f)
    ws_f, poi_f, wsd_f, wse_f = (torch.zeros(m_pad, dtype=torch.int32,
                                             device=dev) for _ in range(4))

    if annot is not None:
        l2a_f = torch.zeros((m_pad, annot.shape[1]), dtype=torch.float32,
                            device=dev)
        l2da_f = torch.zeros_like(l2a_f)

    def isum(mask, dim):
        return mask.sum(dim=dim, dtype=torch.int32)

    for b in range(blk0, blk0 + n_scan_blocks):
        r0 = b * B
        gi = r0 + torch.arange(B, device=dev)
        rows = slice(r0, r0 + B)
        lo_i, hi_i = lo[rows][:, None], hi[rows][:, None]
        usable_i = usable[rows][:, None]
        poison_i = add_sd_zero[rows][:, None]
        dom_ok_i = dom_ok[rows][:, None]
        sc_i = scal_views(scal[rows], "col")

        j0 = min(r0, m_pad - right_rows)
        cols = slice(j0, j0 + right_rows)
        gj = (j0 + torch.arange(right_rows, device=dev))[None, :]
        usable_j = usable[cols][None, :]
        poison_j = add_sd_zero[cols][None, :]
        dom_ok_j = dom_ok[cols][None, :]
        sc_j = scal_views(scal[cols], "row")

        r_add, r_dom_a, r_dom_b = corr_from_dots(
            dots(rows, cols), sc_i, sc_j, n, n_padf, has_missing,
            symmetric=True)

        adj_add = adj_r2(r_add, adj_c)
        adj_da = adj_r2(r_dom_a, adj_c)
        adj_db = adj_r2(r_dom_b, adj_c)

        upair = (gj >= lo_i) & (gj <= hi_i) & usable_j & usable_i
        fwd = gj >= r0
        row_base = upair & fwd & (gj != gi[:, None])
        col_base = upair & (gj >= r0 + B)
        dm_a = row_base & dom_ok_j
        dm_b = col_base & dom_ok_i
        rowf, colf = row_base.to(torch.float32), col_base.to(torch.float32)
        dmaf, dmbf = dm_a.to(torch.float32), dm_b.to(torch.float32)

        l2_f[rows] += (adj_add * rowf).sum(dim=1)
        l2_f[cols] += (adj_add * colf).sum(dim=0)
        ws_f[rows] += isum(row_base, 1)
        ws_f[cols] += isum(col_base, 0)
        poi_f[rows] += isum(upair & fwd & poison_j, 1)
        poi_f[cols] += isum(col_base & poison_i, 0)
        l2d_f[rows] += (adj_da * dmaf).sum(dim=1)
        l2d_f[cols] += (adj_db * dmbf).sum(dim=0)
        wsd_f[rows] += isum(dm_a, 1)
        wsd_f[cols] += isum(dm_b, 0)
        wse_f[rows] += isum((adj_da > rsq) & dm_a, 1)
        wse_f[cols] += isum((adj_db > rsq) & dm_b, 0)
        if annot is not None:
            aj, ai = annot[cols], annot[rows]
            l2a_f[rows] += annot_dot(adj_add * rowf, aj)
            l2a_f[cols] += annot_dot((adj_add * colf).t(), ai)
            l2da_f[rows] += annot_dot(adj_da * dmaf, aj)
            l2da_f[cols] += annot_dot((adj_db * dmbf).t(), ai)
    if annot is not None:
        return l2_f, ws_f, poi_f, l2d_f, wsd_f, wse_f, l2a_f, l2da_f
    return l2_f, ws_f, poi_f, l2d_f, wsd_f, wse_f


def sym_tile_values(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                    rsq_thr: float, *, tile: int, n_samples: int,
                    has_missing: bool, dot_dtype: str = "int8"):
    """The masked pair values of the symmetric pass in tiles of ``tile``
    rows, pivot tile by pivot tile: yields ``(x, K, vals, counts)`` for
    each pivot tile x whose rows' windows reach its K >= 1 tiles x ..
    x + K - 1, with ``vals[d]`` the two float32 ``(T, K·T)`` tiles that
    direction d adds (0, rows: the additive and the dominance value of
    each pair; 1, the mirrored columns: the same for the neighbours) and
    ``counts[d]`` its four masks (ws, wsd, wse, poison).  What the
    kernel's epilogue adds to its sums and contracts with the
    annotations."""
    rows_total, n_pad = g.shape
    T = tile
    nt = rows_total // T
    check_dot_dtype(dot_dtype, n_pad)
    dots = tile_products(g, m, h, has_missing, dot_dtype, symmetric=True)
    n = float(n_samples)
    adj_c = adj_constant(n_samples)
    rsq = f32(rsq_thr)
    dev = g.device
    tile_hi = block_hi(hi, T)
    for x, last in enumerate(tile_hi.tolist()):
        last = min(last, nt - 1)
        if last < x:
            continue
        K = last - x + 1
        r0 = x * T
        rows, cols = slice(r0, r0 + T), slice(r0, (last + 1) * T)
        sc_i, sc_j = scal_views(scal[rows], "col"), scal_views(scal[cols],
                                                                "row")
        r_add, r_dom_a, r_dom_b = corr_from_dots(
            dots(rows, cols), sc_i, sc_j, n, float(n_pad), has_missing,
            symmetric=True)
        adj_add = adj_r2(r_add, adj_c)
        adj_da = adj_r2(r_dom_a, adj_c)
        adj_db = adj_r2(r_dom_b, adj_c)

        gi = (r0 + torch.arange(T, device=dev))[:, None]
        gj = (r0 + torch.arange(K * T, device=dev))[None, :]
        upair = ((gj >= lo[rows][:, None]) & (gj <= hi[rows][:, None])
                 & usable[cols][None, :] & usable[rows][:, None])
        row_base = upair & (gj != gi)
        col_base = upair & (gj >= r0 + T)
        dm_a = row_base & dom_ok[cols][None, :]
        dm_b = col_base & dom_ok[rows][:, None]
        vals = {0: (adj_add * row_base, adj_da * dm_a),
                1: (adj_add * col_base, adj_db * dm_b)}
        counts = {0: (row_base, dm_a, (adj_da > rsq) & dm_a,
                      upair & add_sd_zero[cols][None, :]),
                  1: (col_base, dm_b, (adj_db > rsq) & dm_b,
                      col_base & add_sd_zero[rows][:, None])}
        yield x, K, vals, counts


def sym_tile_partials(g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero,
                      rsq_thr: float, annot=None, *, tile: int, band: int,
                      n_samples: int, has_missing: bool,
                      dot_dtype: str = "int8"):
    """The plain twin of the kernel's unfolded partials
    (``ld_pallas_sym.sym_partials``): the symmetric pass in tiles of
    ``tile`` rows, per pivot tile x and slot k < ``band`` the row credits
    that tile x + k gives tile x's rows and the column credits that tile
    x gives tile x + k's rows (k ≥ 1), as the pair algebra of
    :func:`sym_scan_segment`, each slot summed on its own
    (:func:`sym_tile_values`).

    Returns ``(fpart, ipart, apart)``: float32 ``(n_tiles, band, 2, 2,
    T)`` (l2, l2d), int32 ``(n_tiles, band, 2, 4, T)`` (ws, wsd, wse,
    poison) and, with ``annot``, float32 ``(n_tiles, band, 2, 2, T, p)``
    (else None); direction 0 holds the row credits, 1 the column credits.
    A pivot tile's slots past its rows' window ends, or past the rows,
    stay zero.  Every slot is computed from the rows of its two tiles
    alone, so a run split into shards of whole tiles gives each pivot
    tile the same partials.
    """
    T = tile
    nt = g.shape[0] // T
    dev = g.device
    depth = band_extent(hi, T)[1]
    if depth > band:
        raise ValueError(f"band {band} is below the rows' depth {depth}")
    fpart = torch.zeros((nt, band, 2, 2, T), dtype=torch.float32,
                        device=dev)
    ipart = torch.zeros((nt, band, 2, 4, T), dtype=torch.int32, device=dev)
    apart = (None if annot is None else torch.zeros(
        (nt, band, 2, 2, T, annot.shape[1]), dtype=torch.float32,
        device=dev))
    for x, K, vals, counts in sym_tile_values(
            g, m, h, scal, lo, hi, usable, dom_ok, add_sd_zero, rsq_thr,
            tile=T, n_samples=n_samples, has_missing=has_missing,
            dot_dtype=dot_dtype):

        def by_slot(v, direction):
            """(K, T) sums of a (T, K·T) tile per slot: over each slot's
            columns (row credits) or over the pivot rows (column ones)."""
            v = v.view(T, K, T)
            return v.sum(dim=2).t() if direction == 0 else v.sum(dim=0)

        for d in (0, 1):
            for q, v in enumerate(vals[d]):
                fpart[x, :K, d, q] = by_slot(v, d)
            for q, c in enumerate(counts[d]):
                ipart[x, :K, d, q] = by_slot(c.to(torch.int32), d)
        if annot is not None:
            p = annot.shape[1]
            r0 = x * T
            a_j = annot[r0:r0 + K * T].view(K, T, p)
            for q in range(2):
                row_v = vals[0][q].view(T, K, T).permute(1, 0, 2)
                col_v = vals[1][q].view(T, K, T).permute(1, 2, 0)
                apart[x, :K, 0, q] = annot_dot(row_v, a_j)
                apart[x, :K, 1, q] = annot_dot(col_v, annot[r0:r0 + T])
    return fpart, ipart, apart
