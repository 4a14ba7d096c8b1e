"""PLINK .bed/.bim/.fam IO with numpy and the standard library only.

Genotype codes (counting A2 alleles, reference ``encoder.h:11-16,34-40``):
hom-A1 -> 0, het -> 1, hom-A2 -> 2, missing -> -1.  Bitpairs are
unpacked low-to-high per the PLINK spec.  The main path ships the packed
rows to the device (:meth:`BedReader.read_raw`) and unpacks them there
(:func:`nldsc_tpu_torch.ld.preprocess.unpack_bed`).

The .bim/.fam readers return a :class:`~.tables.Table` typed the way
``pandas.read_csv`` would type it (:func:`~.tables.read_delimited`), so
that written tables print identically.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core.errors import NLDSCDataError, NLDSCParameterError
from .tables import Table, read_delimited

PLINK_MAGIC = bytes([0x6C, 0x1B, 0x01])

BIM_COLUMNS = ("CHR", "SNP", "CM", "BP", "A1", "A2")
FAM_COLUMNS = ("FID", "IID", "FATHER", "MOTHER", "SEX", "TRAIT")


def encode_bed_bytes(genotypes: np.ndarray) -> np.ndarray:
    """Additive codes (n_snp, n_samples) -> packed .bed rows (uint8)."""
    codes = np.asarray(genotypes, dtype=np.int8)
    n_snp, n_samples = codes.shape
    to_bits = np.zeros_like(codes, dtype=np.uint8)
    to_bits[codes == -1] = 0b01
    to_bits[codes == 1] = 0b10
    to_bits[codes == 2] = 0b11
    n_bytes = (n_samples + 3) // 4
    padded = np.zeros((n_snp, n_bytes * 4), dtype=np.uint8)
    padded[:, :n_samples] = to_bits
    padded = padded.reshape(n_snp, n_bytes, 4)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    return (padded << shifts).sum(axis=2, dtype=np.uint8)


def _read_exact(f, n: int) -> np.ndarray:
    """Read exactly ``n`` bytes from an unbuffered file (a single
    ``read(2)`` is capped near 2 GiB, so loop on ``readinto``)."""
    out = np.empty(n, dtype=np.uint8)
    _fill(f, out)
    return out


def _fill(f, out: np.ndarray) -> None:
    """Fill the contiguous uint8 array ``out`` from the file ``f``."""
    view = memoryview(out.reshape(-1))
    got = 0
    while got < len(view):
        r = f.readinto(view[got:])
        if not r:
            raise NLDSCDataError(
                f".bed read truncated: wanted {len(view)} bytes, got {got}")
        got += r


class BedReader:
    """Reader of the packed rows of a SNP-major .bed file."""

    def __init__(self, path: str | os.PathLike, n_snp: int, n_samples: int):
        self.path = str(path)
        self.n_snp = int(n_snp)
        self.n_samples = int(n_samples)
        self.bytes_per_snp = (self.n_samples + 3) // 4
        with open(self.path, "rb") as f:
            magic = f.read(3)
        if magic != PLINK_MAGIC:
            raise NLDSCDataError(
                "Invalid PLINK magic number in BED file. The file is incorrect, "
                "or it was created using an incompatible version of PLINK."
            )
        expected = 3 + self.bytes_per_snp * self.n_snp
        actual = os.path.getsize(self.path)
        if actual < expected:
            raise NLDSCDataError(
                f".bed file too small: {actual} bytes, expected {expected} "
                f"(n_snp={self.n_snp}, n_samples={self.n_samples})"
            )

    def read_raw(self, start: int = 0, count: int | None = None) -> "PackedBed":
        """Packed 2-bit rows [start, start+count) without decoding."""
        count = self.n_snp - start if count is None else count
        if start < 0 or start + count > self.n_snp:
            raise ValueError(f"block [{start}, {start + count}) out of range")
        with open(self.path, "rb", buffering=0) as f:
            f.seek(3 + start * self.bytes_per_snp)
            raw = _read_exact(f, count * self.bytes_per_snp)
        arr = raw.reshape(count, self.bytes_per_snp)
        return PackedBed(arr, count, self.n_samples,
                         _packed_has_missing(arr, self.n_samples))

    def read_into(self, start: int, out: np.ndarray) -> None:
        """Packed rows [start, start + len(out)) into ``out``, a C-contiguous
        uint8 (rows, bytes_per_snp) array (a page-locked staging buffer on
        the streaming route), without decoding."""
        count = out.shape[0]
        if start < 0 or start + count > self.n_snp:
            raise ValueError(f"block [{start}, {start + count}) out of range")
        if out.dtype != np.uint8 or out.shape[1:] != (self.bytes_per_snp,) \
                or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous uint8 "
                             f"(rows, {self.bytes_per_snp})")
        with open(self.path, "rb", buffering=0) as f:
            f.seek(3 + start * self.bytes_per_snp)
            _fill(f, out)


def _miss_bytes(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """uint8 array, nonzero where a byte holds a valid missing (01)
    bitpair: pair = b1 b0 is missing iff b0 and not b1, so
    ``raw & 0x55 & ~(raw >> 1)`` lights bit 2i of pair i."""
    miss = (raw & np.uint8(0x55)) & ~(raw >> 1)
    tail_pairs = n_samples - (raw.shape[1] - 1) * 4
    if tail_pairs < 4:
        # pad bitpairs in the last byte are ignored
        miss[:, -1] &= np.uint8((1 << (2 * tail_pairs)) - 1)
    return miss


#: bytes of packed rows per step of the missing-genotype tests: their
#: four uint8 temporaries stay small and in the CPU's caches
MISS_STEP_BYTES = 1 << 20
#: bytes of packed rows per read of :func:`scan_rowmiss`
SCAN_BLOCK_BYTES = 64 << 20


def _row_steps(raw: np.ndarray, step_bytes: int = MISS_STEP_BYTES):
    """Slices of ``raw``'s rows, each about ``step_bytes`` bytes (at least
    one row)."""
    rows = max(1, step_bytes // max(raw.shape[1], 1))
    return (slice(s, s + rows) for s in range(0, raw.shape[0], rows))


def _packed_has_missing(raw: np.ndarray, n_samples: int) -> bool:
    """True iff any valid bitpair is the missing code (in steps of rows,
    so that the temporaries stay small at any width)."""
    return any(_miss_bytes(raw[s], n_samples).any() for s in _row_steps(raw))


def packed_rowmiss(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """Per-row missing flags from packed 2-bit rows (bool (rows,)): one
    bitwise pass over the raw bytes, no decode, in steps of rows."""
    out = np.zeros(raw.shape[0], dtype=bool)
    for s in _row_steps(raw):
        out[s] = _miss_bytes(raw[s], n_samples).any(axis=1)
    return out


def scan_rowmiss(bed: BedReader, block_rows: int | None = None) -> np.ndarray:
    """Per-row missing flags of a whole .bed (bool (n_snp,)): one
    sequential pass over the file's bytes in reads of ``block_rows`` rows
    (default: :data:`SCAN_BLOCK_BYTES` of them), which lets the streaming
    route pick the split-missing engine before any chunk runs.  Host
    memory stays one read and its small temporaries at any width: a
    fixed 65,536-row read held 4-5x the .bed of a UK Biobank-width
    chromosome (ROADMAP F6)."""
    m, bps = bed.n_snp, bed.bytes_per_snp
    if block_rows is None:
        block_rows = max(1, SCAN_BLOCK_BYTES // bps)
    out = np.zeros(m, dtype=bool)
    buf = np.empty((min(block_rows, m), bps), dtype=np.uint8)
    with open(bed.path, "rb", buffering=0) as f:
        f.seek(3)
        for s in range(0, m, block_rows):
            c = min(block_rows, m - s)
            _fill(f, buf[:c])
            out[s:s + c] = packed_rowmiss(buf[:c], bed.n_samples)
    return out


@dataclass
class PackedBed:
    """Un-decoded SNP-major .bed rows (device-decode input)."""

    raw: np.ndarray        # (n_snp, bytes_per_snp) uint8
    n_snp: int
    n_samples: int
    has_missing: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_snp, self.n_samples)

    @property
    def bytes_per_snp(self) -> int:
        return self.raw.shape[1]


def read_bim(path: str | os.PathLike, single_chromosome: bool = True) -> Table:
    """Read a .bim file (reference: ``nldsc/ldscore/common.py:76-117``).

    Enforces a single chromosome per file like the reference does.
    """
    bim = read_delimited(path, names=BIM_COLUMNS)
    n_chr = len(np.unique(bim["CHR"].astype(str)))
    if single_chromosome and n_chr != 1:
        raise NLDSCParameterError(
            "Expected a single-chromosome bfile, but the .bim lists "
            f"{n_chr} chromosomes — split the input per "
            "chromosome (same constraint as the reference)."
        )
    return bim


def read_fam(path: str | os.PathLike) -> Table:
    return read_delimited(path, names=FAM_COLUMNS)


@dataclass
class PlinkDataset:
    """A resolved .bed/.bim/.fam triple (reference ``PLINKFile.parse``)."""

    bed_path: str
    bim: Table
    fam: Table
    bed: BedReader

    @classmethod
    def parse(cls, bfile: str | os.PathLike) -> "PlinkDataset":
        path = Path(bfile).resolve()
        if path.suffix in (".bed", ".bim", ".fam"):
            path = path.with_suffix("")
        elif path.is_dir():
            raise NLDSCParameterError(f"'{bfile}' is a directory, expected a file prefix")
        bed_path, bim_path, fam_path = (str(path) + s for s in (".bed", ".bim", ".fam"))
        for p in (bed_path, bim_path, fam_path):
            if not os.path.exists(p):
                raise FileNotFoundError(f'No such file: "{p}"')
        bim = read_bim(bim_path)
        fam = read_fam(fam_path)
        bed = BedReader(bed_path, n_snp=len(bim), n_samples=len(fam))
        return cls(bed_path=bed_path, bim=bim, fam=fam, bed=bed)

    @property
    def n_snp(self) -> int:
        return len(self.bim)

    @property
    def n_samples(self) -> int:
        return len(self.fam)

    def positions(self, metric: str) -> np.ndarray:
        """Window coordinates: BP for 'bp' metric, CM for 'cm' (float64)."""
        col = {"bp": "BP", "cm": "CM"}[metric]
        return np.asarray(self.bim[col], dtype=np.float64)


def write_plink(prefix: str | os.PathLike, genotypes: np.ndarray,
                chrom: int = 22, bp: np.ndarray | None = None,
                cm: np.ndarray | None = None) -> str:
    """Write a synthetic .bed/.bim/.fam triple (test and tool helper).

    ``genotypes``: int8 (n_snp, n_samples), codes {0,1,2,-1}.  The .bim
    and .fam text matches what ``nldsc_tpu.io.plink.write_plink`` writes.
    """
    prefix = str(prefix)
    codes = np.asarray(genotypes, dtype=np.int8)
    n_snp, n_samples = codes.shape

    with open(prefix + ".bed", "wb") as f:
        f.write(PLINK_MAGIC)
        f.write(encode_bed_bytes(codes).tobytes())
    write_bim_fam(prefix, n_snp, n_samples, chrom, bp, cm)
    return prefix


def write_bim_fam(prefix: str, n_snp: int, n_samples: int, chrom: int = 22,
                  bp: np.ndarray | None = None,
                  cm: np.ndarray | None = None) -> None:
    """The .bim and .fam of :func:`write_plink` (positions ``bp``, by
    default 1 kb apart; ``cm`` by default ``bp · 1e-6``), for a .bed
    written elsewhere."""
    if bp is None:
        bp = np.arange(1, n_snp + 1) * 1000
    if cm is None:
        cm = np.asarray(bp, dtype=np.float64) * 1e-6
    bp = np.asarray(bp)
    cm = np.asarray(cm, dtype=np.float64)
    with open(prefix + ".bim", "w") as f:
        f.writelines(f"{chrom}\trs{i + 1}\t{c!r}\t{p}\tA\tG\n"
                     for i, (c, p) in enumerate(zip(cm.tolist(),
                                                    bp.tolist())))
    with open(prefix + ".fam", "w") as f:
        f.writelines(f"F{i}\tI{i}\t0\t0\t0\t-9\n" for i in range(n_samples))
