"""LD-score format conversion between this package's ``.L2`` files and
the original ldsc toolchain's ``.l2.ldscore.gz`` / ``.l2.M`` /
``.l2.M_5_50`` files, with numpy and the standard library.

ldsc's conventions: ``<prefix>.l2.ldscore.gz`` is a tab-separated table
with columns ``CHR SNP BP L2``; ``<prefix>.l2.M`` and
``<prefix>.l2.M_5_50`` are single headerless whitespace-separated rows of
per-annotation SNP counts.  The files written are the ones
``nldsc_tpu.io.convert`` writes (gzip members aside, which carry a time).
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from ..core.logging import log
from .ldscores import format_table, read_m
from .tables import Table, read_delimited

LDSC_COLS = ["CHR", "SNP", "BP", "L2"]


def _write_gz(path: str, table: Table) -> None:
    with gzip.open(path, "wb") as f:
        f.write(format_table(table).encode())


def to_ldsc(l2_path: str, out_prefix: str) -> None:
    """Convert a ``.L2`` (+ ``.M``/``.M_5_50``) to ldsc files.

    Writes ``<out>.l2.ldscore.gz`` with the additive scores and, when the
    input carries dominance scores, ``<out>.d.l2.ldscore.gz`` with L2D in
    the L2 column.  SNP counts go to headerless ``<out>.l2.M`` /
    ``<out>.l2.M_5_50`` (and ``.d.l2.*`` twins using MD).
    """
    score = read_delimited(l2_path, sep="\t")
    missing = [c for c in LDSC_COLS if c not in score]
    if missing:
        raise ValueError(f"{l2_path} lacks required columns {missing}")
    out = Path(out_prefix)
    _write_gz(f"{out}.l2.ldscore.gz", Table((k, score[k]) for k in LDSC_COLS))
    m = md = None
    for suffix in (".M", ".M_5_50"):
        sidecar = Path(l2_path).with_suffix(suffix)
        if sidecar.exists():
            m, md = read_m(str(sidecar))
        elif m is None:
            m, md = len(score), 0
        Path(f"{out}.l2{suffix}").write_text(f"{m}\n")
        if "L2D" in score:
            Path(f"{out}.d.l2{suffix}").write_text(f"{md}\n")
    if "L2D" in score:
        _write_gz(f"{out}.d.l2.ldscore.gz",
                  Table(CHR=score["CHR"], SNP=score["SNP"], BP=score["BP"],
                        L2=score["L2D"]))
    log.info("Wrote ldsc-format scores: %s.l2.ldscore.gz", out)


def from_ldsc(prefix: str, out_l2: str) -> None:
    """Convert ldsc ``<prefix>.l2.ldscore[.gz]`` (+ ``.l2.M*``) to ``.L2``.

    ldsc has no dominance scores, so ``L2D`` is written as 0.0: the
    additive h2 estimate on the converted file is exact, the dominance
    partition degenerate (flagged in the log).
    """
    src = next((c for c in (f"{prefix}.l2.ldscore.gz", f"{prefix}.l2.ldscore")
                if Path(c).exists()), None)
    if src is None:
        raise FileNotFoundError(f"no {prefix}.l2.ldscore[.gz]")
    score = read_delimited(src)
    missing = [c for c in LDSC_COLS if c not in score]
    if missing:
        raise ValueError(f"{src} lacks required columns {missing}")
    table = Table((k, score[k]) for k in LDSC_COLS)
    table["L2D"] = np.zeros(len(table))
    Path(out_l2).write_text(format_table(table))
    for suffix in (".M", ".M_5_50"):
        m_file = Path(f"{prefix}.l2{suffix}")
        m = (int(np.loadtxt(m_file, ndmin=1).sum()) if m_file.exists()
             else len(table))
        Path(out_l2).with_suffix(suffix).write_text(f"M\tMD\n{m}\t0\n")
    log.warning("ldsc scores carry no dominance component: L2D/MD set to "
                "0 in %s (additive h2 is exact; ignore the dominance "
                "partition)", out_l2)
