"""Reading and writing .L2 score tables and .M / .M_5_50 sidecars with
numpy.

Output contract (reference ``nldsc/ldscore/routine.py:32-48,97-100``):
tab-separated, ``%.5f`` floats, columns ``CHR SNP BP L2 L2D`` plus
``MAF WSA WSD WSDE RSTD`` with ``--extra``.  The text is byte-identical
to ``DataFrame.to_csv(sep="\\t", index=False, float_format="%.5f")``:
NaN is an empty field, integers print without decimals.

``.M`` counts all usable SNPs, ``.M_5_50`` those with MAF > 5%; ``MD``
is the reference's estimator ``M * mean(WSDE / WSA)``
(``nldsc/h2/common.py:128-131``) over the same SNP set.

The readers return the rows, in the order, that ``nldsc_tpu``'s pandas
readers give: each file sorted by (CHR, BP), rows with any NA dropped,
then duplicate SNPs (first kept); a directory's files concatenated and
sorted again.  The jackknife blocks follow that order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.logging import log
from .tables import (Table, concat, first_occurrences, na_rows,
                     read_delimited, sort_rows, typed_column)

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
    return ["" if v is None else str(v) for v in col.tolist()]


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


#: columns of an annotation file that are keys, not annotations
_ANNOT_KEYS = {"CHR", "BP", "CM", "SNP", "A1", "A2"}


def read_annot(path: str, bim: Table) -> tuple[np.ndarray, list[str]]:
    """Read a per-SNP annotation file for partitioned LD scores.

    Whitespace-separated with a ``SNP`` column and one column per
    annotation (continuous values allowed; the key columns ``CHR``,
    ``BP``, ``CM``, ``A1``, ``A2`` are ignored): the ldsc ``.annot``
    convention.  Rows follow the .bim's SNP order; of duplicate SNPs the
    first row counts; SNPs absent from the file, and NaN cells, get 0.

    Returns (annot float64 (M, p), annotation names).
    """
    tab = read_delimited(path)
    if "SNP" not in tab:
        raise ValueError(f"annotation file {path} needs a SNP column")
    names = [c for c in tab if c not in _ANNOT_KEYS]
    if not names:
        raise ValueError(f"annotation file {path} has no annotation columns")
    tab = tab.take(first_occurrences(tab["SNP"]))
    ours, theirs = ((col if col.dtype == object else col.astype(str)).tolist()
                    for col in (bim["SNP"], tab["SNP"]))
    row_of = dict(zip(theirs, range(len(theirs))))
    rows = np.fromiter((row_of.get(snp, -1) for snp in ours), np.int64,
                       count=len(ours))
    absent = rows < 0
    vals = np.stack([np.asarray(tab[c], dtype=np.float64) for c in names],
                    axis=1)[np.where(absent, 0, rows)]
    vals[absent] = 0.0
    if absent.any():
        log.warning("%d of %d bim SNPs absent from %s; their annotation "
                    "rows are set to 0", int(absent.sum()), len(rows), path)
    return np.nan_to_num(vals, nan=0.0), names


def make_output_annot(bim: Table, result: dict, names: list[str]) -> Table:
    """Assemble a partitioned .L2 table: per-annotation additive
    (``<name>.L2``) then dominance (``<name>.L2D``) score columns."""
    data = Table(CHR=bim["CHR"], SNP=bim["SNP"], BP=bim["BP"])
    for k, name in enumerate(names):
        data[f"{name}.L2"] = result["l2_annot"][:, k]
    for k, name in enumerate(names):
        data[f"{name}.L2D"] = result["l2d_annot"][:, k]
    return data


def write_m_files_annot(result: dict, annot: np.ndarray, names: list[str],
                        l2_path: str) -> None:
    """Per-annotation .M / .M_5_50 sidecars, columns named ``<name>.L2``
    as the partitioned .L2's annotation columns: the LDSC convention
    M_k = Σ_i annot[i, k] over the usable SNPs (all, and MAF > 5%)."""
    base = Path(l2_path)
    usable = ~np.isnan(np.asarray(result["l2"], dtype=np.float64))
    maf = np.asarray(result["maf"], dtype=np.float64)
    for suffix, floor in ((".M", None), (".M_5_50", 0.05)):
        sel = usable if floor is None else usable & (maf > floor)
        counts = annot[sel].sum(axis=0)
        base.with_suffix(suffix).write_text(
            "\t".join(f"{n}.L2" for n in names) + "\n"
            + "\t".join(repr(float(c)) for c in counts) + "\n")
    log.info("Wrote per-annotation SNP counts: %s / %s",
             base.with_suffix(".M"), base.with_suffix(".M_5_50"))


def read_m(path: str) -> tuple[int, int]:
    """(M, MD) of a headered ``.M``/``.M_5_50`` sidecar."""
    tab = read_delimited(path, sep="\t")
    return int(tab["M"][0]), int(tab["MD"][0])


def read_l2_file(path: str) -> Table:
    """One .L2 table, sorted by CHR,BP (SEs depend on it — common.py:137),
    rows with an NA dropped, then duplicate SNPs."""
    score = sort_rows(read_delimited(path, sep="\t"), ["CHR", "BP"])
    score = score.take(~na_rows(score))
    return score.take(first_occurrences(score["SNP"]))


def _sidecar(path: Path, use_m: bool) -> Path:
    """The .M_5_50 (``use_m``: .M) beside ``path``, else the .M."""
    sidecar = path.with_suffix(".M" if use_m else ".M_5_50")
    if not sidecar.exists() and not use_m:
        sidecar = path.with_suffix(".M")
    return sidecar


def _l2_files(path: Path) -> list[Path]:
    files = sorted(path.glob("*.L2")) if path.is_dir() else [path]
    if not files:
        raise FileNotFoundError(f"no *.L2 files in directory {path}")
    return files


def _read_one(path: Path, use_m: bool) -> tuple[Table, int, int]:
    sidecar = _sidecar(path, use_m)
    score = read_l2_file(str(path))
    if sidecar.exists():
        m, md = read_m(str(sidecar))
    else:
        if "WSDE" not in score or "WSA" not in score:
            raise ValueError(
                f"no .M/.M_5_50 sidecar for {path} and the .L2 lacks the "
                "--extra columns needed for the M/MD fallback")
        m = len(score)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = score["WSDE"] / score["WSA"]
        md = int(m * np.nanmean(ratio))
    return score, m, int(md)


def read_ld_scores(path: str, use_m: bool = False) -> tuple[Table, int, int]:
    """File-or-directory LD score reader (reference LDScoreReader).

    Returns (scores, M, MD).  M/MD per reference
    ``nldsc/h2/common.py:119-131``: the requested sidecar (.M with
    ``use_m``, else .M_5_50 falling back to .M), else ``M = #rows``,
    ``MD = M * mean(WSDE/WSA)`` from the ``--extra`` columns.
    """
    p = Path(path)
    if not p.is_dir():
        return _read_one(p, use_m)
    frames, m_tot, md_tot = [], 0, 0
    for f in _l2_files(p):
        score, m, md = _read_one(f, use_m)
        frames.append(Table((k, score[k]) for k in L2_COLUMNS))
        m_tot += m
        md_tot += md
    return sort_rows(concat(frames), ["CHR", "BP"]), m_tot, md_tot


# columns of a .L2 table that are never annotations
_NON_ANNOT = {"CHR", "SNP", "BP", "CM", "L2D", *EXTRA_COLUMNS}


def annotation_columns(score: Table) -> list[str]:
    """Annotation (per-category LD score) columns of a partitioned .L2
    table: every column that is not a key/extra column and not a
    per-annotation dominance column ``*.L2D``.  A plain file yields
    ``["L2"]``."""
    annots = [c for c in score
              if c not in _NON_ANNOT and not c.endswith(".L2D")]
    if not annots:
        raise ValueError("no LD-score annotation columns found "
                         "(expected `L2` or per-annotation columns)")
    return annots


def read_m_partitioned(path: str, annots: list[str]) -> np.ndarray:
    """A (1, p) SNP-count row: a headered sidecar (columns named as the
    annotations, or the single-annotation ``M``/``MD`` pair) or a
    headerless whitespace-separated row of p numbers (ldsc's
    ``.l2.M_5_50``)."""
    with open(path) as f:
        first = next(ln for ln in f if ln.strip()).split()
    if all(typed_column([t]).dtype.kind in "if" for t in first):
        vals = np.array([typed_column([t])[0] for t in first],
                        dtype=np.float64)
        if vals.size != len(annots):
            raise ValueError(
                f"M file {path} has {vals.size} counts but the .L2 has "
                f"{len(annots)} annotation columns")
        return vals.reshape(1, -1)
    tab = read_delimited(path)
    if len(annots) == 1 and "M" in tab:
        return np.array([[tab["M"][0]]], dtype=np.float64)
    missing = [a for a in annots if a not in tab]
    if missing:
        raise ValueError(f"M file {path} lacks counts for annotations "
                         f"{missing}")
    return np.array([[tab[a][0] for a in annots]], dtype=np.float64)


def read_ld_scores_partitioned(
    path: str, use_m: bool = False,
) -> tuple[Table, np.ndarray, list[str]]:
    """File-or-directory reader of partitioned (multi-annotation) scores.

    Returns ``(scores, M_annot, annot_names)``: ``scores`` has the
    columns SNP, CHR, BP and one LD-score column per annotation;
    ``M_annot`` is the (1, p) per-annotation SNP-count row summed across
    files.
    """
    frames, m_tot, annots = [], None, None
    for f in _l2_files(Path(path)):
        score = read_l2_file(str(f))
        cur = annotation_columns(score)
        if annots is None:
            annots = cur
        elif cur != annots:
            raise ValueError(
                f"annotation columns differ across files: {annots} vs "
                f"{cur} in {f}")
        sidecar = _sidecar(f, use_m)
        if sidecar.exists():
            m = read_m_partitioned(str(sidecar), annots)
        elif annots == ["L2"]:
            m = np.array([[len(score)]], dtype=np.float64)
        else:
            raise ValueError(
                f"no .M/.M_5_50 sidecar for partitioned file {f}; "
                "per-annotation SNP counts cannot be derived from rows")
        frames.append(Table((k, score[k]) for k in ("SNP", "CHR", "BP",
                                                     *annots)))
        m_tot = m if m_tot is None else m_tot + m
    return sort_rows(concat(frames), ["CHR", "BP"]), m_tot, annots
