"""The multi-device user surface of the port: ``--n-devices`` and
``--shard-axis`` on ``ld`` and ``ld-genome`` routed as the JAX package
routes them (on repeated CPU devices against its virtual ones), the
device layouts of ``parallel.mesh``, and ``parallel.distributed``:
``assign_chromosomes`` without and with a process group (two ``gloo``
processes on this machine) and ``estimate_lds_mesh`` in its single-process
form (``test_torch_multiprocess.py`` runs it across processes)."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from nldsc_tpu.cli import main as jax_cli
from nldsc_tpu_torch import cli
from nldsc_tpu_torch.core.errors import NLDSCParameterError
from nldsc_tpu_torch.core.logging import log
from nldsc_tpu_torch.io.plink import write_plink
from nldsc_tpu_torch.ld import pipeline
from nldsc_tpu_torch.parallel import distributed, mesh

from contract import assert_counters_equal
from utils import make_positions, random_genotypes

ROOT = Path(__file__).resolve().parents[1]


def _read_l2(path):
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f]
    return {h: np.array([float(r[i]) if r[i] else np.nan for r in rows])
            for i, h in enumerate(header) if h != "SNP"}


@pytest.fixture()
def bfile(rng, tmp_path):
    g = random_genotypes(rng, 240, 160, missing_rate=0.02)
    bp = make_positions(240, spacing=700, jitter_rng=rng).astype(np.int64)
    return write_plink(tmp_path / "chr7", g, bp=bp), g, bp


@pytest.fixture()
def port_log(caplog):
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level("INFO", logger=log.name):
            yield caplog
    finally:
        log.removeHandler(caplog.handler)


FLAGS = ["-kb", "6", "-maf", "0.01", "--extra"]
#: the .L2 columns of the counters l2_ws, l2d_ws, l2d_wse
COLS = ("WSA", "WSD", "WSDE")


@pytest.mark.parametrize("argv, route", [
    (["--n-devices", "4"], "4 cpu devices (SNP axis)"),
    (["--n-devices", "4", "--shard-axis", "samples"],
     "4 cpu devices (SAMPLES axis)"),
    (["--n-devices", "4", "--shard-axis", "grid"], "2x2 snp-x-sample grid"),
    (["--n-devices", "2", "--shard-axis", "grid"],
     "2 cpu devices (SNP axis)"),
    (["--n-devices", "2", "--streaming", "--chunk-rows", "64"],
     ": 2 devices, "),
    (["--n-devices", "2", "--shard-axis", "samples", "--streaming",
      "--chunk-rows", "64"], "samples over 2 devices"),
    (["--n-devices", "4", "--shard-axis", "grid", "--streaming",
      "--chunk-rows", "64"], "2x2 grid"),
], ids=["snp", "samples", "grid", "grid-fallback", "snp-streamed",
        "samples-streamed", "grid-streamed"])
def test_cli_routes_as_jax(bfile, tmp_path, port_log, argv, route):
    prefix, g, bp = bfile
    ours, theirs = tmp_path / "ours.L2", tmp_path / "theirs.L2"
    cli.main(["ld", "--bfile", prefix, *FLAGS, "--device", "cpu",
              "--block-size", "16", *argv, "-o", str(ours)])
    assert route in port_log.text
    res = CliRunner().invoke(jax_cli, ["ld", "--bfile", prefix, *FLAGS,
                                       "--block-size", "16", *argv, "-o",
                                       str(theirs)])
    assert res.exit_code == 0, res.output
    a, b = _read_l2(ours), _read_l2(theirs)
    for k in ("L2", "L2D", "MAF"):
        np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                   equal_nan=True, err_msg=k)
    keys = ("l2_ws", "l2d_ws", "l2d_wse")
    counters = {k: a[c].astype(np.int64) for k, c in zip(keys, COLS)}
    ref = {k: b[c].astype(np.int64) for k, c in zip(keys, COLS)}
    assert_counters_equal(counters, ref)
    fallback = "grid" in argv and argv[1] == "2"
    assert ("no 2-D factorization" in port_log.text) == fallback


def test_grid_shape_and_device_counts(monkeypatch):
    assert pipeline.grid_shape(4) == (2, 2)
    assert pipeline.grid_shape(8) == (4, 2)
    assert pipeline.grid_shape(9) == (3, 3)
    assert pipeline.grid_shape(7) is None and pipeline.grid_shape(2) is None
    cpu = torch.device("cpu")
    assert pipeline.resolve_n_devices(None, cpu) == 1
    assert pipeline.resolve_n_devices(3, cpu) == 3
    with pytest.raises(NLDSCParameterError, match=">= 1"):
        pipeline.resolve_n_devices(0, cpu)
    # a one-card machine: every visible device by default, and no more
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda")
    assert pipeline.resolve_n_devices(None, cuda) == 1
    with pytest.raises(NLDSCParameterError, match="exceeds the 1 visible"):
        pipeline.resolve_n_devices(2, cuda)


def test_device_layouts(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.snp_devices(3, "cpu") == [cpu] * 3
    assert mesh.grid_devices(2, 3, "cpu") == [[cpu] * 3] * 2
    with pytest.raises(NLDSCParameterError):
        mesh.snp_devices(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert mesh.snp_devices(2, "cuda") == [d0, d1]
    with pytest.raises(NLDSCParameterError, match="distinct devices"):
        mesh.snp_devices(3, "cuda")
    assert mesh.snp_devices(3, "cuda", share=True) == [d0, d1, d0]
    assert mesh.grid_devices(2, 2, "cuda", share=True) == [[d0, d1],
                                                            [d0, d1]]
    assert mesh.visible_devices("cuda:1") == [d1]


def test_assign_chromosomes_without_a_group():
    files = [f"chr{i}" for i in range(1, 23)]
    assert distributed.assign_chromosomes(files) == files
    assert distributed.shard_rows_for_process(800, ["cpu"] * 4) == (0, 800)
    assert distributed.device_row_ranges(800, ["a", "b"]) == [
        (0, 400, "a"), (400, 800, "b")]
    distributed.init_distributed(num_processes=1)       # a no-op


def test_assign_chromosomes_in_a_gloo_group(tmp_path):
    # two processes on this machine join one gloo group; each takes every
    # other chromosome and its contiguous share of the rows
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        from nldsc_tpu_torch.parallel import distributed
        rank = int(sys.argv[1])
        distributed.init_distributed("127.0.0.1:{port}", 2, rank, "gloo")
        mine = distributed.assign_chromosomes([f"chr{{i}}" for i in range(5)])
        rows = distributed.shard_rows_for_process(800, ["cpu"])
        json.dump([mine, list(rows)], open(sys.argv[2], "w"))
        import torch.distributed as dist
        dist.destroy_process_group()
    """)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(tmp_path / f"r{r}.json")], env=env)
             for r in range(2)]
    assert [p.wait(timeout=60) for p in procs] == [0, 0]
    import json
    got = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in range(2)]
    assert got[0] == [["chr0", "chr2", "chr4"], [0, 400]]
    assert got[1] == [["chr1", "chr3"], [400, 800]]


def test_estimate_lds_mesh_single_process(bfile, tmp_path):
    # per-device byte-range reads, then the SNP-sharded engine: the .L2 of
    # `ld --n-devices 4` on the same devices, byte for byte
    prefix, _, _ = bfile
    out = tmp_path / "mesh.L2"
    distributed.estimate_lds_mesh(prefix, 6, "kbp", maf_thr=0.01,
                                  std_thr=1e-4, block_size=16, extra=True,
                                  devices=mesh.snp_devices(4, "cpu"),
                                  out=str(out), device="cpu")
    cli.main(["ld", "--bfile", prefix, *FLAGS, "--device", "cpu",
              "--block-size", "16", "--n-devices", "4", "-o",
              str(tmp_path / "ld.L2")])
    for suffix in (".L2", ".M", ".M_5_50"):
        assert out.with_suffix(suffix).read_bytes() == \
            (tmp_path / "ld").with_suffix(suffix).read_bytes(), suffix
    table = distributed.estimate_lds_mesh(
        prefix, 6, "kbp", maf_thr=0.01, std_thr=1e-4, block_size=16,
        device="cpu")
    assert len(table["L2"]) == 240


@pytest.mark.parametrize("axis", ["samples", "grid"])
def test_ld_genome_shards_each_chromosome_as_jax(rng, tmp_path, axis):
    # ld-genome passes --n-devices/--shard-axis to every chromosome's run
    data = {}
    for c in (1, 2):
        g = random_genotypes(rng, 150 + 40 * c, 120, missing_rate=0.02)
        bp = np.arange(1, 151 + 40 * c) * 600
        write_plink(tmp_path / f"chr{c}", g, bp=bp, chrom=c)
        data[c] = g, bp.astype(np.float64)
    flags = ["--bfiles", f"{tmp_path}/chr*.bed", "-kb", "6", "-maf", "0.01",
             "--extra", "--n-devices", "4", "--shard-axis", axis]
    cli.main(["ld-genome", *flags, "--out-dir", str(tmp_path / "ours"),
              "--device", "cpu"])
    res = CliRunner().invoke(jax_cli, ["ld-genome", *flags, "--out-dir",
                                       str(tmp_path / "theirs")])
    assert res.exit_code == 0, res.output
    for c in (1, 2):
        a = _read_l2(tmp_path / "ours" / f"chr{c}.L2")
        b = _read_l2(tmp_path / "theirs" / f"chr{c}.L2")
        for k in ("L2", "L2D", "MAF"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-4,
                                       equal_nan=True, err_msg=k)
        keys = ("l2_ws", "l2d_ws", "l2d_wse")
        assert_counters_equal(
            {k: a[c_].astype(np.int64) for k, c_ in zip(keys, COLS)},
            {k: b[c_].astype(np.int64) for k, c_ in zip(keys, COLS)})
