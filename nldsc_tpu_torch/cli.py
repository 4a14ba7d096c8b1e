"""Command-line interface of the port: the ``ld``, ``ld-genome``, ``h2``
and ``convert`` commands.

Flag-compatible with ``nldsc_tpu``'s CLI (``ld`` and ``ld-genome`` in
core or streaming, plain or partitioned by ``--annot``, every
``--engine``, ``--dot-dtype`` and ``--symmetric/--no-symmetric``, on one
device or sharded with ``--n-devices`` and ``--shard-axis``,
``ld --profile-dir``, ``ld --pallas`` (an alias of ``--engine pallas``)
and the group flag ``--log-file``), plus ``--device`` on ``ld``,
``ld-genome`` and ``h2``.  Needs only the standard library (argparse)
and numpy until a command runs.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

from .core.errors import NLDSCParameterError
from .core.logging import enable_file_logging, log
from .version import __version__

__header__ = (
    f"\n==============================================================\n"
    f"* Non-additive LD Score Regression (nldsc-tpu-torch)\tv{__version__}\n"
    f"* PyTorch/CUDA port of nldsc-tpu (bayarpark/nldsc)\n"
    f"* GNU General Public License v3\n"
    f"==============================================================\n"
)

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="nldsc-tpu-torch", allow_abbrev=False,
        description="Additive and non-additive LD scores on PyTorch/CUDA")
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("--log-file", action="store_true",
                        help="Also write the log to ./nldsc.log")
    sub = parser.add_subparsers(dest="command", required=True)

    ld = sub.add_parser("ld", allow_abbrev=False,
                        help="Estimate additive and non-additive LD Scores")
    ld.add_argument("--bfile", metavar="FILE", required=True,
                    help="Path prefix for PLINK .bed/.bim/.fam file or path "
                         "to one of them")
    ld.add_argument("-o", "--out", metavar="FILE",
                    help="Path prefix for output. If not specified the "
                         "table is printed")
    ld.add_argument("-kb", "--ld-wind-kb", metavar="W", type=float,
                    help="Window size in kilo-base pairs (kb)")
    ld.add_argument("-cm", "--ld-wind-cm", metavar="W", type=float,
                    help="Window size in centi-morgans (cM)")
    ld.add_argument("-maf", "--maf-thr", metavar="F", type=float,
                    default=1e-5, help="Minor allele frequency threshold")
    ld.add_argument("-std", "--std-thr", metavar="F", type=float,
                    default=1e-4,
                    help="Standard deviation threshold for regression "
                         "residuals")
    ld.add_argument("-rsq", "--rsq-thr", metavar="F", type=float,
                    default=None,
                    help="R-squared threshold for regression residuals. "
                         "Default: 1/n_snp")
    ld.add_argument("--extra", action="store_true",
                    help="Include MAF WSA WSD WSDE RSTD in the .L2 file")
    ld.add_argument("--block-size", metavar="B", type=int, default=512,
                    help="SNP rows per pivot block of the CPU path (the "
                         "CUDA kernel tiles by its own size)")
    ld.add_argument("--pallas", action="store_true",
                    help="Alias for --engine pallas")
    ld.add_argument("--engine", choices=["int8", "f32", "pallas"],
                    default=None,
                    help="int8 (default) and pallas both run the fused "
                         "symmetric kernels; pallas never takes the "
                         "split-missing route; f32 runs standardized "
                         "float32 rows through float32 products (full band "
                         "when streamed)")
    ld.add_argument("--dot-dtype", choices=["int8", "bf16"], default="int8",
                    help="Tensor-core operand type of the integer engines: "
                         "int8, or bf16 (the same exact sums, at most "
                         "4,194,304 padded samples)")
    ld.add_argument("--split-missing", dest="split_missing",
                    action="store_true", default=None,
                    help="Per-row missing-data specialization: clean-rate "
                         "pass + exact compact corrections (default: auto, "
                         "on when <=25%% of rows carry missing genotypes)")
    ld.add_argument("--no-split-missing", dest="split_missing",
                    action="store_false")
    ld.add_argument("--symmetric", dest="symmetric", action="store_true",
                    default=None,
                    help="Symmetric engine (the fused kernels on a GPU): "
                         "the default, except on the CPU for clean --annot "
                         "data")
    ld.add_argument("--no-symmetric", dest="symmetric", action="store_false",
                    help="Full-band engine in plain PyTorch ops, in core or "
                         "streamed")
    _add_annot_flag(ld, "compute partitioned LD scores (<name>.L2 / "
                        "<name>.L2D per annotation)")
    ld.add_argument("--progress", dest="progress", action="store_true",
                    default=None, help="Log progress of the LD pass "
                                       "(default: on above 20k SNPs)")
    ld.add_argument("--no-progress", dest="progress", action="store_false")
    _add_streaming_flags(ld)
    ld.add_argument("--resume", dest="resume_path", metavar="DIR",
                    default=None,
                    help="Checkpoint directory for chunk-granular resume "
                         "(streaming; one shard file per completed chunk)")
    ld.add_argument("--profile-dir", metavar="DIR", default=None,
                    help="Capture a torch.profiler trace of the compute pass "
                         "(CPU, and CUDA on a GPU) into DIR/ld_trace.json "
                         "(Chrome trace format)")
    ld.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; the CUDA kernel) or "
                         "cpu (the plain PyTorch path)")
    _add_device_flags(ld)
    ld.add_argument("--display", action="store_true",
                    help="Display traceback")

    genome = sub.add_parser(
        "ld-genome", allow_abbrev=False,
        help="Run `ld` over many single-chromosome bfiles (glob or comma "
             "list), one .L2 per bfile")
    genome.add_argument("--bfiles", metavar="GLOB", required=True,
                        help="Glob or comma-separated list of bfile prefixes "
                             "(or paths to their .bed files)")
    genome.add_argument("--out-dir", metavar="DIR", required=True,
                        help="Directory for the per-chromosome .L2/.M "
                             "outputs (named <prefix-basename>.L2)")
    genome.add_argument("-kb", "--ld-wind-kb", metavar="W", type=float,
                        help="Window size in kilo-base pairs (kb)")
    genome.add_argument("-cm", "--ld-wind-cm", metavar="W", type=float,
                        help="Window size in centi-morgans (cM)")
    genome.add_argument("-maf", "--maf-thr", metavar="F", type=float,
                        default=1e-5)
    genome.add_argument("-std", "--std-thr", metavar="F", type=float,
                        default=1e-4)
    genome.add_argument("-rsq", "--rsq-thr", metavar="F", type=float,
                        default=None)
    genome.add_argument("--extra", action="store_true",
                        help="Include MAF WSA WSD WSDE RSTD columns")
    _add_streaming_flags(genome)
    _add_annot_flag(genome, "partitioned LD, matched to each bfile by SNP "
                            "id (a genome-wide file works: SNPs absent from "
                            "a chromosome get zero rows)")
    genome.add_argument("--resume-dir", metavar="DIR", default=None,
                        help="Checkpoint root for chunk-granular resume: "
                             "each chromosome checkpoints into "
                             "<DIR>/<bfile-basename>/ (streaming)")
    genome.add_argument("--bucket-shapes", dest="bucket_shapes",
                        action="store_true", default=True,
                        help="Accepted and ignored: it shares XLA compiles "
                             "across chromosome sizes in nldsc_tpu, and the "
                             "CUDA kernels do not recompile per shape")
    genome.add_argument("--no-bucket-shapes", dest="bucket_shapes",
                        action="store_false", help=argparse.SUPPRESS)
    genome.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    _add_device_flags(genome)
    genome.add_argument("--display", action="store_true",
                        help="Display traceback")

    h2 = sub.add_parser("h2", allow_abbrev=False,
                        help="Estimate additive and non-additive heritability")
    h2.add_argument("--sumstats", metavar="FILE", required=True,
                    help="Path to the GWAS sumstats file")
    h2.add_argument("--ref-ld", metavar="PTH", required=True,
                    help="File/path with LD Scores used as regression "
                         "predictors")
    h2.add_argument("--w-ld", metavar="PTH", required=True,
                    help="LD Scores for regression weights (may differ from "
                         "--ref-ld)")
    h2.add_argument("--strategy", choices=["one-stg", "two-stg"],
                    default="two-stg", help="Heritability estimation method")
    h2.add_argument("--chisq-max", metavar="F", type=float, default=None,
                    help="Drop SNPs with chi-square above this "
                         "(default: max(1e-3*N_max, 80))")
    h2.add_argument("--n-blocks", metavar="N", type=int, default=200,
                    help="Number of jackknife blocks")
    h2.add_argument("--intercept-h2", metavar="F", type=float, default=None,
                    help="Constrain the additive LD-score regression "
                         "intercept")
    h2.add_argument("--two-step", metavar="F", type=float, default=None,
                    help="Two-step estimator chi-square cutoff (default: 30 "
                         "when the intercept is free, disabled with "
                         "--intercept-h2)")
    h2.add_argument("--use-M", dest="use_m", action="store_true",
                    help="Use .M file instead of .M_5_50")
    h2.add_argument("--partitioned", action="store_true",
                    help="Partitioned (multi-annotation) h2: --ref-ld "
                         "columns other than CHR/SNP/BP are per-annotation "
                         "LD scores (with per-annotation .M/.M_5_50 "
                         "sidecars); --w-ld may differ from --ref-ld")
    h2.add_argument("--device", default=None,
                    help="torch device of the float64 regression: cuda "
                         "(default) or cpu")
    h2.add_argument("--on-device", action="store_true",
                    help="Same as --device cuda (float64 on the GPU)")
    h2.add_argument("--samp-prev", metavar="P", type=float, default=None,
                    help="Sample prevalence (with --pop-prev: report "
                         "liability-scale h2)")
    h2.add_argument("--pop-prev", metavar="K", type=float, default=None,
                    help="Population prevalence")
    h2.add_argument("-s", "--save-to-json", metavar="W", default=None,
                    help="Path to file where to write results")
    h2.add_argument("--display", action="store_true",
                    help="Display traceback")

    conv = sub.add_parser(
        "convert", allow_abbrev=False,
        help="Convert LD scores between .L2 and ldsc .l2.ldscore.gz formats")
    conv.add_argument("--to-ldsc", metavar="OUT_PREFIX", default=None,
                      help="Write ldsc-format files at this prefix")
    conv.add_argument("--from-ldsc", metavar="PREFIX", default=None,
                      help="Read ldsc-format files from this prefix")
    conv.add_argument("-i", "--input", metavar="FILE", default=None,
                      help="Input .L2 file (with --to-ldsc)")
    conv.add_argument("-o", "--out", metavar="FILE", default=None,
                      help="Output .L2 file (with --from-ldsc)")
    conv.add_argument("--display", action="store_true",
                      help="Display traceback")
    return parser


def _add_streaming_flags(parser) -> None:
    parser.add_argument("--streaming", dest="streaming", action="store_true",
                        default=None,
                        help="Force the out-of-core engine on (default: "
                             "auto by memory footprint)")
    parser.add_argument("--no-streaming", dest="streaming",
                        action="store_false",
                        help="Force the out-of-core engine off")
    parser.add_argument("--chunk-rows", metavar="R", type=int, default=8192,
                        help="Pivot rows per streaming chunk")


def _add_device_flags(parser) -> None:
    parser.add_argument("--n-devices", metavar="N", type=int, default=None,
                        help="Shard the run over N devices (default: every "
                             "visible CUDA device, one on the CPU; on the "
                             "CPU N runs N CPU shards)")
    parser.add_argument("--shard-axis", choices=["snp", "samples", "grid"],
                        default="snp",
                        help="Multi-device axis: snp (SNP rows with halo "
                             "exchange, default), samples (per-tile sums "
                             "over sample shards; composes with "
                             "--streaming), or grid (2-D snp x sample; "
                             "streamed, chunks round-robin over the grid's "
                             "rows, each row sample-sharding its chunk)")


def _add_annot_flag(parser, what: str) -> None:
    parser.add_argument("--annot", metavar="FILE", default=None,
                        help="Per-SNP annotation file (a SNP column and one "
                             f"column per annotation): {what}")


def _window(args) -> tuple[str, float]:
    if sum(map(bool, [args.ld_wind_kb, args.ld_wind_cm])) != 1:
        raise RuntimeError("Please, specify exactly one --ld-wind option")
    if args.ld_wind_kb:
        return "kbp", args.ld_wind_kb
    return "cm", args.ld_wind_cm


def genome_prefixes(bfiles: str) -> list[str]:
    """The bfile prefixes of ``ld-genome --bfiles``: a comma list, a glob
    or one path, with any .bed/.bim/.fam suffix dropped, sorted and
    unique.  Refuses two prefixes with one basename: their outputs in
    ``--out-dir`` would overwrite each other."""
    if "," in bfiles:
        paths = [p.strip() for p in bfiles.split(",") if p.strip()]
    elif glob.has_magic(bfiles):
        paths = sorted(glob.glob(bfiles))
        if not paths:
            raise RuntimeError(f"No bfiles match {bfiles!r}")
    else:
        paths = [bfiles]
    prefixes = sorted({re.sub(r"\.(bed|bim|fam)$", "", p) for p in paths})
    names = [os.path.basename(p) for p in prefixes]
    if len(set(names)) != len(names):
        dups = sorted({n for n in names if names.count(n) > 1})
        raise RuntimeError(
            "bfile prefixes with identical basenames would overwrite each "
            f"other's outputs in --out-dir: {dups}")
    return prefixes


def run_ld(args) -> None:
    wind_metric, ld_wind = _window(args)

    from .ld.pipeline import estimate_lds  # noqa: PLC0415

    table = estimate_lds(
        args.bfile, ld_wind=ld_wind, wind_metric=wind_metric,
        maf_thr=args.maf_thr, std_thr=args.std_thr, rsq_thr=args.rsq_thr,
        out=args.out, extra=args.extra, summary=True,
        block_size=args.block_size, int8_dot_dtype=args.dot_dtype,
        split_missing=args.split_missing,
        use_pallas=args.pallas or args.engine == "pallas",
        use_int8=None if args.engine is None else args.engine != "f32",
        progress=args.progress,
        streaming=args.streaming, chunk_rows=args.chunk_rows,
        resume_path=args.resume_path, annot=args.annot,
        symmetric=args.symmetric, profile_dir=args.profile_dir,
        **_device_kwargs(args))
    if table is not None and args.out is None:
        from .io.ldscores import format_table  # noqa: PLC0415

        print(format_table(table), end="")


def _device_kwargs(args) -> dict:
    """``estimate_lds``'s device arguments of ``--device``, ``--n-devices``
    and ``--shard-axis``."""
    return {"device": args.device, "n_devices": args.n_devices,
            "shard_samples": args.shard_axis == "samples",
            "shard_grid": args.shard_axis == "grid"}


def run_ld_genome(args) -> None:
    """``ld`` over every bfile of ``--bfiles``, into ``--out-dir``; in a
    process group the chromosomes go round-robin over its processes
    (``parallel.distributed.assign_chromosomes``), else this process takes
    them all (``nldsc_tpu/cli.py:207-256``)."""
    wind_metric, ld_wind = _window(args)
    prefixes = genome_prefixes(args.bfiles)

    from .ld.pipeline import estimate_lds  # noqa: PLC0415
    from .parallel.distributed import assign_chromosomes  # noqa: PLC0415

    mine = assign_chromosomes(prefixes)
    os.makedirs(args.out_dir, exist_ok=True)
    log.info("ld-genome: %d bfiles total, %d in this process",
             len(prefixes), len(mine))
    for i, prefix in enumerate(mine):
        name = os.path.basename(prefix)
        out = os.path.join(args.out_dir, name + ".L2")
        log.info("[%d/%d] %s -> %s", i + 1, len(mine), prefix, out)
        estimate_lds(
            prefix, ld_wind=ld_wind, wind_metric=wind_metric,
            maf_thr=args.maf_thr, std_thr=args.std_thr, rsq_thr=args.rsq_thr,
            out=out, extra=args.extra, streaming=args.streaming,
            chunk_rows=args.chunk_rows,
            resume_path=(os.path.join(args.resume_dir, name)
                         if args.resume_dir else None),
            annot=args.annot, **_device_kwargs(args))
    log.info("ld-genome: %d chromosomes done", len(mine))


def run_h2(args) -> None:
    device = args.device or "cuda"
    if args.on_device and not device.startswith("cuda"):
        raise NLDSCParameterError(
            f"--on-device runs on the GPU; it contradicts --device {device}")
    from .h2.pipeline import estimate_h2, estimate_h2_partitioned  # noqa: PLC0415

    if args.partitioned:
        estimate_h2_partitioned(
            sumstats=args.sumstats, ref_ld=args.ref_ld, w_ld=args.w_ld,
            n_blocks=args.n_blocks, intercept_h2=args.intercept_h2,
            chisq_max=args.chisq_max, use_m=args.use_m,
            save_to_json=args.save_to_json, device=device)
        return
    estimate_h2(
        sumstats=args.sumstats, ldscore=args.ref_ld, n_blocks=args.n_blocks,
        intercept_h2=args.intercept_h2, chisq_max=args.chisq_max,
        use_m=args.use_m, two_step=args.two_step, strategy=args.strategy,
        save_to_json=args.save_to_json, samp_prev=args.samp_prev,
        pop_prev=args.pop_prev,
        w_ldscore=args.w_ld if args.w_ld != args.ref_ld else None,
        device=device)


def run_convert(args) -> None:
    from .io.convert import from_ldsc, to_ldsc  # noqa: PLC0415

    if (args.to_ldsc is None) == (args.from_ldsc is None):
        raise RuntimeError("Specify exactly one of --to-ldsc / --from-ldsc")
    if args.to_ldsc is not None:
        if args.input is None:
            raise RuntimeError("--to-ldsc requires -i/--input <file.L2>")
        to_ldsc(args.input, args.to_ldsc)
    else:
        if args.out is None:
            raise RuntimeError("--from-ldsc requires -o/--out <file.L2>")
        from_ldsc(args.from_ldsc, args.out)


def main(argv: list[str] | None = None) -> None:
    """Entry point; exits with status 1 on any error (``--display``
    shows the traceback)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    print(__header__)
    log_file = None
    try:
        args = build_parser().parse_args(argv)
        if args.log_file:
            log_file = enable_file_logging()
        {"ld": run_ld, "ld-genome": run_ld_genome, "h2": run_h2,
         "convert": run_convert}[args.command](args)
    except Exception as ex:
        log.critical("The program crashed with %s, what: %s\n"
                     "Use `--display` flag for traceback",
                     ex.__class__.__name__, ex,
                     exc_info="--display" in argv)
        raise SystemExit(1) from ex
    finally:
        if log_file is not None:
            log.removeHandler(log_file)
            log_file.close()


if __name__ == "__main__":
    main()
