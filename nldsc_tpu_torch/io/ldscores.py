"""Writing .L2 score tables and .M / .M_5_50 sidecars with numpy.

Output contract (reference ``nldsc/ldscore/routine.py:32-48,97-100``):
tab-separated, ``%.5f`` floats, columns ``CHR SNP BP L2 L2D`` plus
``MAF WSA WSD WSDE RSTD`` with ``--extra``.  The text is byte-identical
to ``DataFrame.to_csv(sep="\\t", index=False, float_format="%.5f")``:
NaN is an empty field, integers print without decimals.

``.M`` counts all usable SNPs, ``.M_5_50`` those with MAF > 5%; ``MD``
is the reference's estimator ``M * mean(WSDE / WSA)``
(``nldsc/h2/common.py:128-131``) over the same SNP set.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.logging import log
from .plink import Table

L2_COLUMNS = ["CHR", "SNP", "BP", "L2", "L2D"]
EXTRA_COLUMNS = ["MAF", "WSA", "WSD", "WSDE", "RSTD"]


def make_output(bim: Table, result: dict, extra: bool = False) -> Table:
    """Assemble the .L2 table (reference make_output, routine.py:32-48)."""
    data = Table(CHR=bim["CHR"], SNP=bim["SNP"], BP=bim["BP"],
                 L2=result["l2"], L2D=result["l2d"])
    if extra:
        data["MAF"] = result["maf"]
        data["WSA"] = result["l2_ws"]
        data["WSD"] = result["l2d_ws"]
        data["WSDE"] = result["l2d_wse"]
        data["RSTD"] = result["residuals_std"]
    return data


def _format_column(col: np.ndarray, float_format: str) -> list[str]:
    col = np.asarray(col)
    if col.dtype.kind == "f":
        return ["" if v != v else float_format % v for v in col.tolist()]
    return [str(v) for v in col.tolist()]


def format_table(table: Table, float_format: str = "%.5f") -> str:
    """Tab-separated text of ``table`` with a header line; NaN prints as
    an empty field."""
    cols = [_format_column(c, float_format) for c in table.values()]
    lines = ["\t".join(table.keys())]
    lines += ["\t".join(row) for row in zip(*cols)]
    return "\n".join(lines) + "\n"


def write_l2(table: Table, out: str) -> None:
    with open(out, "w") as f:
        f.write(format_table(table))
    log.info("Wrote LD scores: %s", out)


def m_counts(result: dict, maf_floor: float | None = None) -> tuple[int, int]:
    """(M, MD) over usable SNPs, optionally restricted to MAF > maf_floor."""
    l2 = np.asarray(result["l2"], dtype=np.float64)
    maf = np.asarray(result["maf"], dtype=np.float64)
    wsa = np.asarray(result["l2_ws"], dtype=np.float64)
    wsde = np.asarray(result["l2d_wse"], dtype=np.float64)
    sel = ~np.isnan(l2)
    if maf_floor is not None:
        sel &= maf > maf_floor
    m = int(sel.sum())
    if m == 0:
        return 0, 0
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = wsde[sel] / wsa[sel]
    md = m * float(np.nanmean(ratio)) if np.isfinite(ratio).any() else 0.0
    return m, int(md)


def write_m_files(result: dict, l2_path: str) -> None:
    """Write the .M and .M_5_50 siblings of the .L2 file (``with_suffix``
    naming, which the h2 reader's sidecar lookup expects)."""
    base = Path(l2_path)
    for suffix, floor in ((".M", None), (".M_5_50", 0.05)):
        m, md = m_counts(result, floor)
        base.with_suffix(suffix).write_text(f"M\tMD\n{m}\t{md}\n")
    log.info("Wrote SNP counts: %s / %s",
             base.with_suffix(".M"), base.with_suffix(".M_5_50"))
