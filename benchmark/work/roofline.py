"""The work of the port's kernels K1 and K2 and its bound on one NVIDIA
H100, counted from a cell's inputs alone.

Frozen from the repository's smoke test (``chip_smoke.py``: ``bound``,
``k1_work``, ``annot_bound``, ``k1_annot_work``, ``k2_work``), so that a
later change to the program or to that script cannot move the yardstick.
A bound is the least time the card could take: the larger of the
operations at NVIDIA's published dense peak (SXM part, 700 W) and the
bytes at the HBM bandwidth, each input byte read once and each output
byte written once, on the inputs' own rows and samples (no padding).
``k2_work`` counts what the inputs need, not what the
program's plan of segments and tiles happens to read: where the original
took the plan's terms (a row read once per segment, the products of the
contaminated pairs written and read back, one slot of partials per
column tile), this copy takes their least (each row once, no
intermediate, each output once).
"""

from __future__ import annotations

import torch

INT8_OPS = 1979e12
BF16_OPS = 989e12
TF32_OPS = 495e12
FP32_OPS = 67e12
HBM_BYTES = 3.35e12
#: the tensor-core peak and the bytes per operand element of each
#: ``--dot-dtype``
DOT_PEAK = {"int8": (INT8_OPS, 1), "bf16": (BF16_OPS, 2)}
#: float32 operations of K2's fused epilogue per counted pair: pair_adj
#: twice (exact and clean, 70 each), the exact call's 7 masked sums, the 3
#: differences and the 6 row and column sums
EPI_OPS_PER_PAIR = 2 * 70 + 7 + 3 + 6


def bound(ops: float, nbytes: float, peak_ops: float = INT8_OPS) -> dict:
    """The least time the card could take for ``ops`` operations that
    must move ``nbytes``: the larger of the two times, and which it is."""
    t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_work(hi: torch.Tensor, n: int, has_missing: bool,
            dot_dtype: str = "int8") -> dict:
    """K1's work on ``n`` samples of rows with window ends ``hi`` (int32,
    one a row): ``ops``, the tensor-core operations of the in-window pairs
    i <= j (2 per sample per product: 3 products clean, 8 missing);
    ``bytes``, each input read once (g, h and m if missing, 1 byte a code,
    2 in bf16; the per-row scalars and flags) and the six credit vectors
    written once; and its ``bound`` at the peak of ``dot_dtype``'s
    operands."""
    peak, esize = DOT_PEAK[dot_dtype]
    m = hi.shape[0]
    rows = torch.arange(m, device=hi.device)
    pairs = int((hi.long() - rows + 1).clamp(min=0).sum())
    nprod = 8 if has_missing else 3
    ops = 2.0 * nprod * n * pairs
    nbytes = (3 if has_missing else 2) * esize * m * n + m * (
        9 * 4 + 2 * 4 + 3) + 6 * 4 * m
    return {"ops": ops, "pairs": pairs, "bytes": nbytes,
            **bound(ops, nbytes, peak)}


def annot_bound(work: dict, pairs: int, m: int, p: int,
                int8_ops: float, f32_ops: float = 0.0,
                peak: float = INT8_OPS, tensor_cores: bool = False) -> dict:
    """A kernel's work with its annotation epilogue: ``work`` (its plain
    ``bytes``) plus 4 contractions x 2 float32 operations x ``p`` per
    counted pair, the annotation matrix read once and the two (m, p)
    accumulators written once.  On the tensor cores (``tensor_cores``, K1
    and K2) each is three tf32 products (hi + lo split) at the tf32 rate;
    else those operations run at the float32 rate.  The operations' times
    add (the products, then the epilogue's); the bound is the larger of
    that and the bytes' time."""
    epi_ops = 4.0 * 2.0 * p * pairs
    t_epi = 3 * epi_ops / TF32_OPS if tensor_cores else epi_ops / FP32_OPS
    nbytes = work["bytes"] + 3 * 4 * m * p
    t_ops = int8_ops / peak + f32_ops / FP32_OPS + t_epi
    t_bytes = nbytes / HBM_BYTES
    return {"annot_f32_ops": epi_ops,
            "annot_rate": "3 tf32 products" if tensor_cores else "float32",
            "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_annot_work(work: dict, m: int, p: int,
                  dot_dtype: str = "int8") -> dict:
    """K1's work with ``p`` annotations, from ``k1_work``'s ``work`` on
    the same ``m`` rows (and ``dot_dtype``): the epilogue on the tensor
    cores."""
    return annot_bound(work, work["pairs"], m, p, work["ops"],
                       peak=DOT_PEAK[dot_dtype][0], tensor_cores=True)


def k2_work(lo: torch.Tensor, hi: torch.Tensor, usable: torch.Tensor,
            rowmiss: torch.Tensor, n: int, dot_dtype: str = "int8") -> dict:
    """K2's work in one split pass: the exact corrections of the pairs
    that touch a contaminated row, counted from the inputs.

    ``lo``, ``hi``: int (m,) inclusive window bounds of symmetric
    windows; ``usable``, ``rowmiss``: bool (m,), the usable rows and those
    of them that carry a missing genotype (the contaminated rows, K2's
    compact columns).  ``pairs``: the ordered
    pairs (r, c) of a contaminated column c and a usable row r != c in its
    window; ``d_pairs``: those whose row is contaminated too.
    ``int8_ops``: 2 per sample of each product they need (5 per pair:
    Sgg, Sgm, Sgh, Shg, Shm, and 3 more, d, per contaminated pair);
    ``f32_ops``: the fused epilogue's; ``bytes``: the rows some pair reads
    once, the compact operands g_c, m_c, h_c once, the per-row and
    per-column inputs once, and the three δ-credit vectors written once.
    """
    peak, esize = DOT_PEAK[dot_dtype]
    m = lo.shape[0]
    dev = lo.device
    cont = rowmiss & usable
    cols = torch.nonzero(cont).flatten()
    first = lo.long()[cols].clamp(min=0)
    last = hi.long()[cols].clamp(max=m - 1)

    def in_window(flags):
        c = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       flags.long().cumsum(0)])
        return (c[last + 1] - c[first]).clamp(min=0)

    pairs = int((in_window(usable) - 1).clamp(min=0).sum())
    d_pairs = int((in_window(cont) - 1).clamp(min=0).sum())
    reach = torch.zeros(m + 1, dtype=torch.long, device=dev)
    ok = last >= first
    reach.index_add_(0, first[ok], torch.ones_like(first[ok]))
    reach.index_add_(0, last[ok] + 1, -torch.ones_like(last[ok]))
    rows = int((reach.cumsum(0)[:m] > 0).sum())
    n_c = int(cols.numel())
    int8_ops = 2.0 * n * (5 * pairs + 3 * d_pairs)
    f32_ops = float(EPI_OPS_PER_PAIR * pairs)
    nbytes = (esize * (rows + 3 * n_c) * n
              + rows * (9 * 4 + 3 * 4 + 3) + n_c * (9 * 4 + 4 + 2)
              + 3 * 4 * m)
    t_ops = int8_ops / peak + f32_ops / FP32_OPS
    t_bytes = nbytes / HBM_BYTES
    return {"int8_ops": int8_ops, "pairs": pairs, "d_pairs": d_pairs,
            "rows": rows, "columns": n_c, "f32_ops": f32_ops,
            "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
