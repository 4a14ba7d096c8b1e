"""GWAS summary-statistics reader (reference: ``nldsc/h2/common.py:29-66``),
with numpy.

Whitespace-delimited with a header and the columns ``SNP Z N`` (plus
``A1 A2`` with ``alleles``); other columns are ignored.  ``.`` is NA, as
are pandas' default NA spellings.  Rows with an NA field are dropped,
then duplicate SNPs (the first row of each is kept).  Compression is
chosen from the extension (``.gz``, ``.bz2``, ``.xz``, ``.zip``).
"""

from __future__ import annotations

import numpy as np

from ..core.errors import NLDSCDataError
from ..core.logging import log
from .tables import (NA_VALUES, Table, first_occurrences, na_rows,
                     read_delimited)


def read_sumstats(path: str, alleles: bool = False,
                  dropna: bool = True) -> Table:
    """``SNP`` and the alleles as str (object) columns, ``Z`` and ``N``
    as float64."""
    columns = ["SNP", "Z", "N"] + (["A1", "A2"] if alleles else [])
    raw = read_delimited(path, na_values=NA_VALUES | {"."},
                         text=("SNP", "A1", "A2"), usecols=columns)
    missing = [c for c in columns if c not in raw]
    if missing:
        raise NLDSCDataError(f"{path} lacks the columns {missing}")
    data = Table((c, raw[c]) for c in columns)
    for c in ("Z", "N"):
        if data[c].dtype == object:
            raise NLDSCDataError(f"{path}: column {c} is not numeric")
        data[c] = data[c].astype(np.float64)
    if dropna:
        data = data.take(~na_rows(data))
    n_snp = len(data)
    data = data.take(first_occurrences(data["SNP"]))
    if n_snp > len(data):
        log.info("Dropped %d SNPs with duplicated rs numbers.",
                 n_snp - len(data))
    return data
