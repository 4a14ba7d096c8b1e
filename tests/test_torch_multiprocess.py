"""One chromosome across the processes of a ``gloo`` process group:
``parallel.distributed.estimate_lds_mesh`` on two ranks of two CPU shards
each, and ``estimate_lds_multihost``.

One pair of ranks (a module fixture) runs every case and writes its
outputs; the tests then hold each case byte for byte against the port's
single-process run on the same four shards, and within the golden
tolerances (counters under ``tests/contract.py``) against the JAX
package's single-process ``estimate_lds_mesh`` / ``estimate_lds_multihost``
on four of its virtual CPU devices.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from nldsc_tpu.parallel import snp_mesh
from nldsc_tpu.parallel import distributed as jax_distributed
from nldsc_tpu_torch.config import LDConfig
from nldsc_tpu_torch.io.plink import write_plink
from nldsc_tpu_torch.ld import pipeline
from nldsc_tpu_torch.parallel import distributed, sharded

from contract import assert_counters_equal
from utils import make_positions, random_genotypes

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = dict(rtol=2e-5, atol=2e-4, equal_nan=True)
#: shards per rank; two ranks
K = 2
M, N, SPACING = 250, 150, 700
RUN = dict(wind_metric="kbp", maf_thr=0.01, std_thr=1e-4, block_size=16,
           extra=True)
#: case -> (bfile, window kb, annotation file); "deep": the window (about
#: 143 SNPs) is deeper than a rank's 128 rows
CASES = {
    "clean": ("clean", 6.0, False),
    "missing_on_rank_1": ("miss1", 6.0, False),
    "annot": ("clean", 6.0, True),
    "deep": ("miss1", 100.0, False),
}
CHROMS = ["chr1", "chr2", "1000G.EUR.22"]

WORKER = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, sys.argv[4])
    from nldsc_tpu_torch.parallel import distributed, mesh
    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cases, run, chroms = (json.loads(sys.argv[i]) for i in (5, 6, 7))
    distributed.init_distributed(f"127.0.0.1:{port}", 2, rank, "gloo",
                                 timeout_s=60)
    mesh.RECV_TIMEOUT_S = 30
    report = {"bytes": {}}
    for name, (bfile, kb, annot) in cases.items():
        mesh.exchange_bytes = 0
        out = distributed.estimate_lds_mesh(
            os.path.join(work, bfile), kb, out=os.path.join(work, f"mp_{name}.L2"),
            annot=os.path.join(work, "two.annot") if annot else None,
            devices=["cpu"] * 2, device="cpu", **run)
        assert out is None
        report["bytes"][name] = mesh.exchange_bytes
    run = {k: v for k, v in run.items() if k != "wind_metric"}
    report["multihost"] = distributed.estimate_lds_multihost(
        [os.path.join(work, c) for c in chroms],
        os.path.join(work, f"mh{rank}", "{stem}.L2"), ld_wind=6.0,
        wind_metric="kbp", device="cpu", **run)
    report["imported"] = sorted({k.split(".")[0] for k in sys.modules}
                                & {"jax", "nldsc_tpu", "pandas"})
    # a rank that dies before the halo exchange: the other one must fail
    # in its receive, not wait forever
    if rank == 1:
        json.dump(report, open(os.path.join(work, "rank1.json"), "w"))
        mesh.exchange = lambda *a, **k: os._exit(3)
    t0 = time.time()
    try:
        distributed.estimate_lds_mesh(
            os.path.join(work, "clean"), 6.0, "kbp", devices=["cpu"] * 2,
            device="cpu", **run)
        report["failed"] = None
    except RuntimeError as ex:
        report["failed"] = [type(ex).__name__, time.time() - t0]
    json.dump(report, open(os.path.join(work, "rank0.json"), "w"))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multiprocess")
    rng = np.random.default_rng(2611)
    bp = make_positions(M, spacing=SPACING, jitter_rng=rng).astype(np.int64)
    clean = random_genotypes(rng, M, N, missing_rate=0.0)
    miss1 = clean.copy()
    for r in (150, 171, 203, 249):                  # rank 1's rows only
        miss1[r, rng.random(N) < 0.2] = -1
    data = {"clean": clean, "miss1": miss1}
    for name, g in data.items():
        write_plink(work / name, g, bp=bp)
    snps = [line.split()[1] for line in open(work / "clean.bim")]
    with open(work / "two.annot", "w") as f:
        f.write("SNP\tbase\tcat\n")
        f.writelines(f"{s}\t1\t{int(rng.random() < 0.3)}\n" for s in snps)
    for c, name in enumerate(CHROMS):
        g = random_genotypes(rng, 120, N, missing_rate=0.01)
        write_plink(work / name, g, bp=np.arange(1, 121) * 600, chrom=c + 1)
        data[name] = g
    for d in ("mh0", "mh1", "jax_mh"):
        (work / d).mkdir()
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    port = _free_port()
    args = [json.dumps(CASES), json.dumps(RUN), json.dumps(CHROMS)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(port), str(work),
         str(ROOT), *args], env=env) for r in range(2)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 3]
    reports = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(2)]
    return {"work": work, "data": data, "bp": bp.astype(np.float64),
            "reports": reports}


def _read_l2(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    return {h: np.array([float(r[i]) if r[i] else np.nan for r in rows])
            for i, h in enumerate(header) if h != "SNP"}


def _hold_to_jax(ours, theirs, g, bp, kb, counters=True):
    assert set(ours) == set(theirs)
    for k in ours:
        if k not in ("WSA", "WSD", "WSDE"):
            np.testing.assert_allclose(ours[k], theirs[k], err_msg=k,
                                       **GOLDEN)
    if counters:
        keys = {"l2_ws": "WSA", "l2d_ws": "WSD", "l2d_wse": "WSDE"}
        a = {k: ours[c].astype(np.int64) for k, c in keys.items()}
        b = {k: theirs[c].astype(np.int64) for k, c in keys.items()}
        assert_counters_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_across_processes_equals_one_process(runs, case):
    # two ranks x two shards, byte for byte the one-process run on four
    work = runs["work"]
    bfile, kb, annot = CASES[case]
    distributed.estimate_lds_mesh(
        str(work / bfile), kb, out=str(work / f"one_{case}.L2"),
        annot=str(work / "two.annot") if annot else None,
        devices=["cpu"] * 4, device="cpu", **RUN)
    for suffix in (".L2", ".M", ".M_5_50"):
        assert (work / f"mp_{case}{suffix}").read_bytes() == \
            (work / f"one_{case}{suffix}").read_bytes(), suffix
    # each rank moves rows: copies between its shards, and rank 1 its
    # halo rows and results to rank 0
    assert all(r["bytes"][case] > 0 for r in runs["reports"])
    g = runs["data"][bfile]
    if case == "missing_on_rank_1":
        # rank 0's rows hold no missing genotype: the agreed state did
        assert not (g[:128] < 0).any() and (g[128:] < 0).any()
    if case == "deep":
        geo = sharded.sharded_geometry(
            M, N, runs["bp"], LDConfig(ld_wind=kb * 1000, block_size=16),
            2 * K, "cpu", True)
        assert geo.halo > K * geo.rows           # wider than a rank


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_across_processes_matches_jax(runs, case):
    work = runs["work"]
    bfile, kb, annot = CASES[case]
    out = work / f"jax_{case}.L2"
    jax_distributed.estimate_lds_mesh(
        str(work / bfile), kb, out=str(out), mesh=snp_mesh(2 * K),
        annot=str(work / "two.annot") if annot else None, **RUN)
    _hold_to_jax(_read_l2(work / f"mp_{case}.L2"), _read_l2(out),
                 runs["data"][bfile], runs["bp"], kb, counters=not annot)


def test_multihost_deals_chromosomes_as_the_reference(runs):
    work = runs["work"]
    reports = runs["reports"]
    # round-robin over the ranks; {stem} is Path.stem: 1000G.EUR.22 ->
    # 1000G.EUR
    assert reports[0]["multihost"] == [str(work / "mh0" / "chr1.L2"),
                                       str(work / "mh0" / "1000G.EUR.L2")]
    assert reports[1]["multihost"] == [str(work / "mh1" / "chr2.L2")]
    theirs = jax_distributed.estimate_lds_multihost(
        [str(work / c) for c in CHROMS], str(work / "jax_mh" / "{stem}.L2"),
        ld_wind=6.0, n_devices=1, **RUN)
    assert theirs == [str(work / "jax_mh" / f"{s}.L2")
                      for s in ("chr1", "chr2", "1000G.EUR")]
    run = {k: v for k, v in RUN.items() if k != "wind_metric"}
    for name, path in (("chr1", reports[0]["multihost"][0]),
                       ("1000G.EUR.22", reports[0]["multihost"][1]),
                       ("chr2", reports[1]["multihost"][0])):
        one = work / f"one_{name}.L2"
        pipeline.estimate_lds(str(work / name), 6.0, "kbp", out=str(one),
                              device="cpu", **run)
        for suffix in (".L2", ".M", ".M_5_50"):
            assert Path(path).with_suffix(suffix).read_bytes() == \
                one.with_suffix(suffix).read_bytes(), (name, suffix)
        stem = Path(name).stem
        _hold_to_jax(_read_l2(path), _read_l2(work / "jax_mh" / f"{stem}.L2"),
                     runs["data"][name], np.arange(1, 121) * 600.0, 6.0)


def test_ranks_import_no_jax_and_fail_together(runs):
    rank0, rank1 = runs["reports"]
    assert rank0["imported"] == rank1["imported"] == []
    # rank 1 died before its halo exchange: rank 0's receive raised
    name, seconds = rank0["failed"]
    assert name == "RuntimeError" and seconds < 60
