"""The port's pandas-free ``h2`` readers, row joins and ``convert`` against
the JAX package's pandas versions, on the same files."""

import bz2
import gzip
import lzma
import zipfile

import numpy as np
import pandas as pd
import pytest

from nldsc_tpu.io import convert as jax_convert
from nldsc_tpu.io import ldscores as jax_ldscores
from nldsc_tpu.io import sumstats as jax_sumstats
from nldsc_tpu_torch.core.errors import NLDSCDataError, NLDSCParameterError
from nldsc_tpu_torch.io import convert, ldscores, sumstats, tables
from nldsc_tpu_torch.io.plink import Table

SUMSTATS_TEXT = (
    "SNP\tA1\tA2\tZ\tN\tP INFO\n"
    "rs3\tA\tG\t1.25\t5000\t0.2 0.9\n"
    "rs1  C T  -0.3333333333333333 4999.5 0.7\t1\n"
    "rs7\tA\tG\t.\t5000\t0.1\t1\n"            # NA Z
    "rs2\tA\t.\t2.5e-3\t5000\t0.9\t1\n"         # NA allele only
    "rs3\tA\tG\t9.0\t4000\t0.3\t1\n"            # duplicate SNP
    "rs9\tA\tG\t-1.7\tNA\t0.3\t1\n"             # NA N
    "\n"
    "rs4\tA\tG\t0.1\t5001\t.\t1\n"              # NA in an ignored column
    "rs5\tA\tG\t-2.0\t5002\t0.5\t1\n"
)


def _write(path, text: str):
    opener = {".gz": gzip.open, ".bz2": bz2.open, ".xz": lzma.open}
    if path.suffix in opener:
        with opener[path.suffix](path, "wt") as f:
            f.write(text)
    elif path.suffix == ".zip":
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("trait.sumstats", text)
    else:
        path.write_text(text)
    return str(path)


def _assert_table_equal(ours: Table, theirs: pd.DataFrame, columns):
    assert len(ours) == len(theirs)
    for c in columns:
        want = theirs[c].to_numpy()
        got = np.asarray(ours[c])
        if want.dtype.kind in "fi":
            np.testing.assert_allclose(got.astype(np.float64),
                                       want.astype(np.float64), rtol=1e-15,
                                       atol=0, equal_nan=True, err_msg=c)
        else:
            assert list(got) == list(want), c


@pytest.mark.parametrize("suffix", ["", ".gz", ".bz2", ".xz", ".zip"])
@pytest.mark.parametrize("alleles", [False, True])
def test_read_sumstats_matches_jax(tmp_path, suffix, alleles):
    path = _write(tmp_path / f"trait.sumstats{suffix}", SUMSTATS_TEXT)
    ours = sumstats.read_sumstats(path, alleles=alleles)
    theirs = jax_sumstats.read_sumstats(path, alleles=alleles)
    cols = ["SNP", "Z", "N"] + (["A1", "A2"] if alleles else [])
    assert list(ours) == cols
    _assert_table_equal(ours, theirs, cols)
    assert ours["Z"].dtype == np.float64 and ours["N"].dtype == np.float64


def test_read_delimited_rejects_ragged_rows(tmp_path):
    path = tmp_path / "bad.sumstats"
    path.write_text("SNP Z N\nrs1 0.5 100\nrs2 0.1\n")
    with pytest.raises(NLDSCDataError, match="line 3 has 2 fields"):
        sumstats.read_sumstats(str(path))


def test_read_sumstats_never_types_unused_columns(tmp_path, monkeypatch,
                                                  rng):
    """A sumstats file with many more columns than the reader uses: only
    the fields of SNP, Z and N reach the typer, and the rows equal the
    JAX reader's."""
    junk = [f"J{i}" for i in range(9)]
    lines = ["\t".join(["SNP", *junk[:4], "Z", *junk[4:], "N"])]
    for i in range(500):
        lines.append("\t".join([f"rs{i % 450}", *(f"junk{i}_{j}" for j in
                                                  range(4)),
                                f"{rng.normal():.6f}",
                                *(f"junk{i}_{j}" for j in range(4, 9)),
                                str(int(rng.integers(1000, 2000)))]))
    path = tmp_path / "wide.sumstats.gz"
    _write(path, "\n".join(lines) + "\n")
    seen = []
    typed = tables.typed_column
    monkeypatch.setattr(tables, "typed_column",
                        lambda fields, *a, **k: seen.extend(fields) or
                        typed(fields, *a, **k))
    ours = sumstats.read_sumstats(str(path))
    assert seen and not any(f.startswith("junk") for f in seen)
    _assert_table_equal(ours, jax_sumstats.read_sumstats(str(path)),
                        ["SNP", "Z", "N"])


@pytest.mark.parametrize("block_bytes", [1, 200, -1])
def test_read_delimited_blocks_type_as_pandas(tmp_path, block_bytes):
    """Columns typed a block of lines at a time are typed as pandas types
    the whole column: ints that turn float, numbers that turn text, NA
    fields, and a blank line."""
    rows = ["ID INT FLT MIX NAS"]
    for i in range(60):
        rows.append(f"r{i} {i - 30} {i if i < 40 else i + 0.25} "
                    f"{i if i < 50 else f'x{i}'} {'NA' if i < 45 else i}")
        if i == 20:
            rows.append("")
    path = tmp_path / "t.txt"
    path.write_text("\n".join(rows) + "\n")
    ours = tables.read_delimited(path, block_bytes=block_bytes)
    theirs = pd.read_csv(path, sep=r"\s+")
    assert list(ours) == list(theirs.columns)
    assert [c.dtype.kind for c in ours.values()] == ["O", "i", "f", "O", "f"]
    _assert_table_equal(ours, theirs, list(theirs.columns))


@pytest.mark.parametrize("name", ["t.sumstats.zst", "t.sumstats.tar.gz"])
def test_read_sumstats_refuses_unsupported_compression(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(b"\x00")
    with pytest.raises(NLDSCParameterError, match="not supported"):
        sumstats.read_sumstats(str(path))


def _l2_frame(rng, chrom, m, extra=False, start=0):
    bp = np.sort(rng.integers(1, 50 * m, m))
    bp[10:14] = bp[10]                                   # BP ties
    df = pd.DataFrame({"CHR": chrom,
                       "SNP": [f"rs{chrom}_{i + start}" for i in range(m)],
                       "BP": bp, "L2": rng.uniform(1, 30, m),
                       "L2D": rng.uniform(0, 3, m)})
    if extra:
        df["MAF"] = rng.uniform(0.01, 0.5, m)
        df["WSA"] = rng.integers(50, 100, m)
        df["WSD"] = rng.integers(40, 50, m)
        df["WSDE"] = rng.integers(1, 40, m)
        df["RSTD"] = rng.uniform(0.1, 1, m)
    df.loc[[3, 17], "L2"] = np.nan                       # NaN rows
    df.loc[25, "L2D"] = np.nan
    df.loc[30, "SNP"] = df.loc[31, "SNP"]                # duplicate SNP
    return df.sample(frac=1.0, random_state=int(rng.integers(1 << 30)))


def _write_l2(df, path, m=None, m_5_50=None):
    df.to_csv(path, sep="\t", index=False, float_format="%.5f")
    for suffix, val in ((".M", m), (".M_5_50", m_5_50)):
        if val is not None:
            pd.DataFrame({"M": [val[0]], "MD": [val[1]]}).to_csv(
                path.with_suffix(suffix), sep="\t", index=False)


def _ld_dir(rng, tmp_path):
    d = tmp_path / "ld"
    d.mkdir()
    # sidecars: both, .M only (the .M_5_50 falls back to it), none (M/MD
    # from the --extra columns)
    _write_l2(_l2_frame(rng, 2, 300), d / "chr2.L2", (300, 150), (280, 140))
    _write_l2(_l2_frame(rng, 1, 250), d / "chr1.L2", (250, 120))
    shared = _l2_frame(rng, 3, 200, extra=True)
    shared.iloc[0, shared.columns.get_loc("SNP")] = "rs1_5"   # in chr1 too
    _write_l2(shared, d / "chr3.L2")
    return d


@pytest.mark.parametrize("use_m", [False, True])
def test_read_ld_scores_directory_matches_jax(rng, tmp_path, use_m):
    d = _ld_dir(rng, tmp_path)
    ours, m, md = ldscores.read_ld_scores(str(d), use_m=use_m)
    theirs, jm, jmd = jax_ldscores.read_ld_scores(str(d), use_m=use_m)
    assert (m, md) == (jm, jmd)
    assert list(ours) == list(theirs.columns)
    _assert_table_equal(ours, theirs, list(theirs.columns))


@pytest.mark.parametrize("name", ["chr2.L2", "chr3.L2"])
def test_read_ld_scores_file_matches_jax(rng, tmp_path, name):
    path = str(_ld_dir(rng, tmp_path) / name)
    ours, m, md = ldscores.read_ld_scores(path)
    theirs, jm, jmd = jax_ldscores.read_ld_scores(path)
    assert (m, md) == (jm, jmd)
    assert list(ours) == list(theirs.columns)
    _assert_table_equal(ours, theirs, list(theirs.columns))


def _partitioned_dir(rng, tmp_path, names, headerless):
    d = tmp_path / "part"
    d.mkdir()
    for chrom, m in ((1, 200), (2, 150)):
        df = _l2_frame(rng, chrom, m).drop(columns=["L2", "L2D"])
        for nm in names:
            df[nm] = rng.uniform(0, 10, m)
        df.loc[df.index[4], names[0]] = np.nan
        df[f"{names[0][:-3]}.L2D"] = 1.0                 # carried, not an annot
        df.to_csv(d / f"chr{chrom}.L2", sep="\t", index=False,
                  float_format="%.5f")
        counts = rng.integers(10, 100, len(names))
        with open(d / f"chr{chrom}.M_5_50", "w") as f:
            if not headerless:
                f.write("\t".join(names) + "\n")
            f.write("\t".join(str(c) for c in counts) + "\n")
    return d


@pytest.mark.parametrize("n_annot", [2, 3])
@pytest.mark.parametrize("headerless", [False, True])
def test_read_ld_scores_partitioned_matches_jax(rng, tmp_path, n_annot,
                                                headerless):
    names = ["base.L2", "coding.L2", "enhancer.L2"][:n_annot]
    d = _partitioned_dir(rng, tmp_path, names, headerless)
    ours, m, annots = ldscores.read_ld_scores_partitioned(str(d))
    theirs, jm, jannots = jax_ldscores.read_ld_scores_partitioned(str(d))
    assert annots == jannots == names
    np.testing.assert_array_equal(m, jm)
    assert list(ours) == list(theirs.columns)
    _assert_table_equal(ours, theirs, list(theirs.columns))
    with open(d / "chr1.M_5_50", "w") as f:
        f.write("1\t2\t3\t4\n")
    with pytest.raises(ValueError, match="counts"):
        ldscores.read_ld_scores_partitioned(str(d))


def test_read_m_partitioned_single_annotation_legacy(tmp_path):
    p = tmp_path / "x.M"
    p.write_text("M\tMD\n123\t45\n")
    np.testing.assert_array_equal(ldscores.read_m_partitioned(str(p), ["L2"]),
                                  jax_ldscores.read_m_partitioned(str(p),
                                                                  ["L2"]))


def test_inner_join_matches_pandas(rng):
    left = pd.DataFrame({"SNP": ["c", "a", "d", "b", "a2", "z"],
                         "Z": np.arange(6.0)})
    right = pd.DataFrame({"SNP": ["a", "b", "c", "e", "c", "a2"],
                          "L2": np.arange(6.0) + 10})
    want = pd.merge(left, right, how="inner", on="SNP")
    got = tables.inner_join(Table(SNP=left["SNP"].to_numpy(),
                                  Z=left["Z"].to_numpy()),
                            Table(SNP=right["SNP"].to_numpy(),
                                  L2=right["L2"].to_numpy()))
    assert list(got["SNP"]) == list(want["SNP"]) == ["c", "c", "a", "b", "a2"]
    np.testing.assert_array_equal(got["L2"], want["L2"])
    empty = Table(SNP=np.array([], dtype=object), L2=np.array([]))
    assert len(tables.inner_join(Table(SNP=left["SNP"].to_numpy()),
                                 empty)) == 0
    # a larger shuffled join with SNPs missing on either side
    keys = np.array([f"rs{i}" for i in rng.permutation(5000)], dtype=object)
    left = pd.DataFrame({"SNP": keys[:4000], "Z": rng.normal(size=4000)})
    right = pd.DataFrame({"SNP": keys[500:][rng.permutation(4500)],
                          "L2": rng.uniform(size=4500)})
    want = pd.merge(left, right, how="inner", on="SNP")
    got = tables.inner_join(Table(SNP=left["SNP"].to_numpy(),
                                  Z=left["Z"].to_numpy()),
                            Table(SNP=right["SNP"].to_numpy(),
                                  L2=right["L2"].to_numpy()))
    assert list(got["SNP"]) == list(want["SNP"])
    np.testing.assert_array_equal(got["L2"], want["L2"])


def test_sort_rows_matches_pandas(rng):
    df = pd.DataFrame({"CHR": rng.integers(1, 4, 20000),
                       "BP": rng.integers(0, 300, 20000),
                       "i": np.arange(20000)})
    want = df.sort_values(by=["CHR", "BP"])["i"].to_numpy()
    got = tables.sort_rows(Table((k, df[k].to_numpy()) for k in df),
                           ["CHR", "BP"])["i"]
    np.testing.assert_array_equal(got, want)


def _l2_with_sidecars(rng, tmp_path):
    df = _l2_frame(rng, 22, 120, extra=True)
    path = tmp_path / "in.L2"
    _write_l2(df, path, (120, 60), (100, 50))
    return path


def test_to_ldsc_matches_jax(rng, tmp_path):
    src = _l2_with_sidecars(rng, tmp_path)
    (tmp_path / "o").mkdir()
    (tmp_path / "j").mkdir()
    convert.to_ldsc(str(src), str(tmp_path / "o" / "x"))
    jax_convert.to_ldsc(str(src), str(tmp_path / "j" / "x"))
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == names
    for nm in names:
        a, b = ((tmp_path / d / nm).read_bytes() for d in ("o", "j"))
        if nm.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, nm


@pytest.mark.parametrize("gz, with_m", [(True, True), (False, False)])
def test_from_ldsc_matches_jax(rng, tmp_path, gz, with_m):
    df = _l2_frame(rng, 5, 90).drop(columns=["L2D"]).dropna()
    df["CM"] = 0.5
    name = tmp_path / ("in.l2.ldscore.gz" if gz else "in.l2.ldscore")
    df.to_csv(name, sep=" " if not gz else "\t", index=False,
              float_format="%.6f")
    if with_m:
        (tmp_path / "in.l2.M").write_text("80 10\n")
        (tmp_path / "in.l2.M_5_50").write_text("70\n")
    prefix = str(tmp_path / "in")
    convert.from_ldsc(prefix, str(tmp_path / "ours.L2"))
    jax_convert.from_ldsc(prefix, str(tmp_path / "theirs.L2"))
    for suffix in (".L2", ".M", ".M_5_50"):
        assert ((tmp_path / f"ours{suffix}").read_bytes()
                == (tmp_path / f"theirs{suffix}").read_bytes()), suffix
