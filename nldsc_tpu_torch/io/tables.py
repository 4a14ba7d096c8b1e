"""Delimited text tables with numpy: the reading, row selection and
joining that the ``ld``, ``h2`` and ``convert`` commands need, with the
results ``pandas`` gives.

* :class:`Table` holds the columns: an ordered mapping of name to 1-D
  numpy array.
* :func:`read_delimited` types each column as ``pandas.read_csv`` would
  (int64 when every field is an integer, float64 when every field is a
  number or NA, object otherwise, with ``None`` for NA) and picks the
  decompressor from the file name, as ``compression="infer"`` does.
  Floats are parsed correctly rounded; pandas' default C parser can
  differ from that near 1e-13 relative.
* :func:`sort_rows` is pandas' multi-key ``sort_values``: a stable
  lexicographic sort, NaN last.
* :func:`inner_join` is ``pd.merge(left, right, how="inner", on=key)``:
  the left table's row order, and for each left row its matches in the
  right table's order.
"""

from __future__ import annotations

import bz2
import gzip
import io
import itertools
import lzma
import operator
import os
import zipfile

import numpy as np

from ..core.errors import NLDSCDataError, NLDSCParameterError

#: field spellings that pandas reads as NaN
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                        "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A",
                        "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})

#: text read and typed at a time: bounds the fields held at once
BLOCK_BYTES = 1 << 24

#: compressed formats ``pandas.read_csv(compression="infer")`` would
#: accept but this reader does not
_UNSUPPORTED = (".tar", ".tar.gz", ".tar.bz2", ".tar.xz", ".tgz", ".zst")


class Table(dict):
    """Ordered column name -> 1-D numpy array, all of one length."""

    def __len__(self) -> int:  # number of rows, like a DataFrame
        return len(next(iter(self.values()))) if dict.__len__(self) else 0

    def take(self, rows) -> "Table":
        """The rows ``rows`` (indices or a boolean mask) of every column."""
        return Table((k, v[rows]) for k, v in self.items())


def open_text(path: str | os.PathLike):
    """A text stream of ``path``, decompressed by its extension."""
    name = str(path).lower()
    if name.endswith(_UNSUPPORTED):
        raise NLDSCParameterError(
            f"{path}: compression {name[name.rindex('.'):]!r} is not "
            "supported; use plain text, .gz, .bz2, .xz or .zip")
    if name.endswith(".gz"):
        return gzip.open(path, "rt")
    if name.endswith(".bz2"):
        return bz2.open(path, "rt")
    if name.endswith(".xz"):
        return lzma.open(path, "rt")
    if name.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            members = zf.namelist()
            if len(members) != 1:
                raise NLDSCDataError(
                    f"{path}: a .zip must hold exactly one file, found "
                    f"{len(members)}")
            return io.StringIO(zf.read(members[0]).decode(),
                               newline=None)
    return open(path)


def typed_column(fields, na_values=NA_VALUES,
                 text: bool = False) -> np.ndarray:
    """One column of str fields typed as ``pandas.read_csv`` would
    (``text``: kept as str, its ``dtype=str``).

    The float cast is tried before any NA lookup: the NA spellings that
    ``float`` accepts are the NaN spellings, which give NaN either way.
    Fields are looked up one by one only in a column that holds an NA.
    """
    n = len(fields)
    if not text:
        for conv, dtype in ((int, np.int64), (float, np.float64)):
            try:
                return np.fromiter(map(conv, fields), dtype, count=n)
            except (ValueError, OverflowError):
                pass
    has_na = not na_values.isdisjoint(fields)
    if has_na and not text:
        try:
            return np.fromiter((np.nan if f in na_values else float(f)
                                for f in fields), np.float64, count=n)
        except ValueError:
            pass
    out = np.empty(n, dtype=object)
    out[:] = ([None if f in na_values else f for f in fields] if has_na
              else fields)
    return out


def _joined(parts: list[np.ndarray]) -> np.ndarray | None:
    """The typed blocks of one column as one array, typed as the whole
    column would be; None when numeric and text blocks mix (the column
    is then text, and its numeric fields are needed as written)."""
    kinds = {p.dtype.kind for p in parts}
    if len(kinds) > 1 and kinds != {"i", "f"}:
        return None
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def read_delimited(path: str | os.PathLike, sep: str | None = None,
                   na_values=NA_VALUES, text=(), usecols=None,
                   names=None, block_bytes: int = BLOCK_BYTES) -> Table:
    """A table from a file with a header line, or with none when the
    column ``names`` are given; ``sep=None`` splits on whitespace
    (pandas' ``sep=r"\\s+"``).  Blank lines are skipped; the columns named
    in ``text`` stay str; ``usecols`` keeps only those columns.

    The file is read ``block_bytes`` of text at a time, and of each block
    only the fields of the kept columns are typed and kept.
    """
    def split(lines):  # a blank line gives []
        if sep is None:
            return list(map(str.split, lines))
        return [ln.rstrip("\n").split(sep) if ln.rstrip("\n") else []
                for ln in lines]

    with open_text(path) as f:
        lineno, header = 0, names
        while header is None:
            line = f.readline()
            if not line:
                raise NLDSCDataError(f"{path}: no header line")
            lineno += 1
            header = split([line])[0] or None
        keep = [j for j, name in enumerate(header)
                if usecols is None or name in usecols]
        if len(keep) == len(header):
            pick = None
        elif len(keep) < 2:
            pick = lambda r: tuple(r[j] for j in keep)  # noqa: E731
        else:
            pick = operator.itemgetter(*keep)
        parts = [[] for _ in keep]
        while block := f.readlines(block_bytes):
            rows = split(block)
            ok = list(filter(None, rows))
            if set(map(len, ok)) - {len(header)}:
                bad = next(i for i, r in enumerate(rows)
                           if r and len(r) != len(header))
                raise NLDSCDataError(
                    f"{path}: line {lineno + bad + 1} has {len(rows[bad])} "
                    f"fields, {'the header' if names is None else 'expected'}"
                    f" {len(header)}")
            lineno += len(block)
            cols = (list(zip(*(ok if pick is None else map(pick, ok))))
                    or [()] * len(keep))
            for j, col in enumerate(cols):
                parts[j].append(typed_column(col, na_values,
                                             header[keep[j]] in text))
    out = Table((header[j], _joined(p) if p else typed_column((), na_values,
                                                             header[j] in text))
                for j, p in zip(keep, parts))
    mixed = [k for k, v in out.items() if v is None]
    if mixed:
        # a text column whose first blocks were numbers: type it again
        # from its fields as written, in one block
        again = read_delimited(path, sep, na_values, text, mixed, names,
                               block_bytes=-1)
        out.update(again)
    return out


def na_rows(table: Table) -> np.ndarray:
    """Boolean mask of the rows with an NA field in any column."""
    mask = np.zeros(len(table), dtype=bool)
    for col in table.values():
        if col.dtype.kind == "f":
            mask |= np.isnan(col)
        elif col.dtype == object:
            mask |= np.equal(col, None)
    return mask


def first_occurrences(keys: np.ndarray) -> np.ndarray:
    """Sorted indices of the first row of each distinct key
    (``drop_duplicates(keep="first")``)."""
    n = len(keys)
    first = dict(zip(keys[::-1].tolist(), range(n - 1, -1, -1)))
    return np.sort(np.fromiter(first.values(), dtype=np.int64,
                               count=len(first)))


def _sort_key(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind in "iuf":
        return col
    return np.unique(col.astype(str), return_inverse=True)[1]


def sort_rows(table: Table, by: list[str]) -> Table:
    """Rows stably sorted by the columns ``by``, first key first."""
    order = np.lexsort([_sort_key(table[k]) for k in reversed(by)])
    return table.take(order)


def concat(tables: list[Table]) -> Table:
    """Rows of ``tables`` one after another (same columns, in order)."""
    names = list(tables[0])
    return Table((k, np.concatenate([t[k] for t in tables]))
                 for k in names)


def inner_join(left: Table, right: Table, on: str = "SNP") -> Table:
    """``pd.merge(left, right, how="inner", on=on)``: the left rows in
    their order, each followed by its matches in the right table's
    order; the right table's other columns appended."""
    lk, rk = ((col if col.dtype == object else col.astype(str)).tolist()
              for col in (left[on], right[on]))
    # every key -> its first right row; rows of one key share that code
    first = dict(zip(rk[::-1], range(len(rk) - 1, -1, -1)))
    code = np.fromiter(map(first.get, rk), np.int64, count=len(rk))
    order = np.argsort(code, kind="stable")
    lcode = np.fromiter(map(first.get, lk, itertools.repeat(-1)), np.int64,
                        count=len(lk))
    found = lcode >= 0
    count = np.where(found, np.bincount(code, minlength=len(rk) + 1)[lcode],
                     0)
    lo = np.searchsorted(code[order], lcode)
    li = np.repeat(np.arange(len(lk)), count)
    ri = order[np.repeat(lo - (np.cumsum(count) - count), count)
               + np.arange(len(li))]
    out = left.take(li)
    for k, v in right.items():
        if k != on:
            out[k] = v[ri]
    return out
