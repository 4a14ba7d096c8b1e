"""Multi-process scaffolding on ``torch.distributed``, and the mesh-level
``ld`` run of one chromosome across devices and processes.

Port of ``nldsc_tpu/parallel/distributed.py``:

1. **Job-level scale-out**: :func:`assign_chromosomes` deals the
   chromosome files round-robin over the processes of an initialized
   process group (``ld-genome`` takes its chromosomes through it); without
   one, this process is rank 0 of 1 and takes them all.
   :func:`estimate_lds_multihost` runs this process's chromosomes through
   ``pipeline.estimate_lds``.
2. **Mesh-level (one chromosome across devices and processes)**:
   :func:`estimate_lds_mesh` reads each local device's own byte range of
   the SNP-major .bed (a SNP range is a contiguous byte range), sends it
   to that device and runs the SNP-sharded engine
   (``sharded.ld_scores_sharded_global``) on the rows where they lie: no
   step holds the whole unpacked matrix.  In a process group each rank
   reads only its own rows (:func:`shard_rows_for_process`), the halo
   rows and the partials cross the ranks (``mesh.exchange``), and rank 0
   writes the outputs.

Not ported: ``make_global_genotypes`` and ``global_snp_mesh``, which
build JAX global arrays; the port keeps per-device tensors.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np
import torch

from ..core.errors import NLDSCParameterError
from ..core.logging import log
from .mesh import on_device, visible_devices


def _group() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float = 600.0) -> None:
    """Join a process group of ``num_processes`` (no-op for one): the
    coordinator's ``host:port``, this process's rank ``process_id``, the
    backend ``nccl`` with a card, else ``gloo``.  A collective waits at
    most ``timeout_s`` seconds for the other ranks."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise NLDSCParameterError("a process group needs the coordinator's "
                                  "address and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("distributed: process %d/%d (%s)", process_id, num_processes,
             backend)


def assign_chromosomes(bfiles: list) -> list:
    """This process's chromosome files: round-robin over the processes of
    the process group (all of them without one)."""
    rank, world = _group()
    return [b for i, b in enumerate(bfiles) if i % world == rank]


def shard_rows_for_process(m_pad: int, devices) -> tuple[int, int]:
    """Global rows ``[start, stop)`` of this process: every row of the
    ``devices`` layout in one process; in a group, the rank's contiguous
    share of the rows."""
    rank, world = _group()
    per = m_pad // world
    return rank * per, (rank + 1) * per


def device_row_ranges(m_pad: int, devices) -> list:
    """Per device of the layout, its contiguous global rows ``(r0, r1,
    device)``."""
    per = m_pad // len(devices)
    return [(i * per, (i + 1) * per, d) for i, d in enumerate(devices)]


def _gathered(value: int, dev: torch.device) -> list[int]:
    """``value`` of every rank of the process group, in rank order."""
    x = torch.tensor([value], dtype=torch.int64, device=dev)
    out = [torch.zeros_like(x) for _ in range(_group()[1])]
    with on_device(dev):
        torch.distributed.all_gather(out, x)
    return [int(v) for v in out]


def _any_rank(flag: bool, dev: torch.device) -> bool:
    """Whether ``flag`` holds on any rank: one all-reduce (MAX)."""
    x = torch.tensor([int(flag)], device=dev)
    with on_device(dev):
        torch.distributed.all_reduce(x, torch.distributed.ReduceOp.MAX)
    return bool(x.item())


def estimate_lds_mesh(bfile: str, ld_wind: float, wind_metric: str,
                      maf_thr: float = 1e-5, std_thr: float = 1e-5,
                      rsq_thr: float | None = None, *, out: str | None = None,
                      extra: bool = False, block_size: int = 512,
                      devices=None, write_m: bool = True,
                      annot: str | None = None, device="cuda"):
    """One chromosome over the devices of ``devices`` (default: every
    visible device of ``device``): each device's rows read as their own
    byte range of the .bed and unpacked on it, then the SNP-sharded
    engine.  Returns the .L2 table, or writes ``out`` (with .M/.M_5_50)
    as ``pipeline.estimate_lds`` does.

    In a process group of W ranks, ``devices`` are this rank's k devices
    (every rank passes as many: the run has W·k SNP shards, rank r's the
    r-th contiguous k) and each rank reads only its rows of the .bed
    (:func:`shard_rows_for_process`) and keeps only its rows of the
    annotation file, which every rank reads.  The ranks agree on the
    missing state (any rank's missing genotype runs the 8-product branch
    on every shard).  Rank 0 returns the table or writes ``out``; the
    other ranks write nothing and return None.  The results are bitwise
    those of one process on W·k shards of the same device type."""
    from ..config import LDConfig  # noqa: PLC0415
    from ..io.ldscores import (make_output, make_output_annot,  # noqa: PLC0415
                               read_annot, write_l2, write_m_files,
                               write_m_files_annot)
    from ..io.plink import PlinkDataset, _packed_has_missing  # noqa: PLC0415
    from ..ld.preprocess import unpack_bed  # noqa: PLC0415
    from .sharded import ld_scores_sharded_global, sharded_geometry  # noqa: PLC0415

    ds = PlinkDataset.parse(bfile)
    m, n = ds.n_snp, ds.n_samples
    config = LDConfig(
        ld_wind=ld_wind, wind_metric=wind_metric, maf_thr=maf_thr,
        std_thr=std_thr, rsq_thr=rsq_thr, block_size=block_size,
    ).resolve_rsq(m)
    positions = ds.positions(config.wind_metric)
    devices = [torch.device(d) for d in (
        visible_devices(device) if devices is None else devices)]
    rank, world = _group()
    # collectives run on host tensors under gloo, on the card under nccl
    coll = (devices[0] if world > 1
            and torch.distributed.get_backend() == "nccl"
            else torch.device("cpu"))
    if world > 1:
        counts = _gathered(len(devices), coll)
        if len(set(counts)) != 1:
            raise NLDSCParameterError(
                f"every process needs as many devices: {counts}")
    annot_mat = annot_names = None
    if annot is not None:
        annot_mat, annot_names = read_annot(annot, ds.bim)

    # the row layout (independent of the missing state), then one read
    # per local device: byte ranges of the .bed; rows past it are padding
    n_shards = world * len(devices)
    geo = sharded_geometry(m, n, positions, config, n_shards,
                           devices[0].type, annot=annot is not None)
    start, stop = shard_rows_for_process(geo.m_pad, devices)
    reads = []
    for r0, r1, _ in device_row_ranges(stop - start, devices):
        r0, s1 = start + r0, min(start + r1, m)
        reads.append(ds.bed.read_raw(r0, s1 - r0).raw if s1 > r0 else
                     np.zeros((0, ds.bed.bytes_per_snp), np.uint8))
    has_missing = any(_packed_has_missing(r, n) for r in reads)
    if world > 1:
        has_missing = _any_rank(has_missing, coll)
        log.info("mesh-level: process %d/%d reads rows [%d, %d)", rank,
                 world, start, stop)
    geo = sharded_geometry(m, n, positions, config, n_shards,
                           devices[0].type, has_missing, annot is not None)
    codes = [None] * n_shards
    for j, (raw, dev) in enumerate(zip(reads, devices)):
        rows = np.full((geo.rows, ds.bed.bytes_per_snp),
                       0x55 if geo.pad_val == -1 else 0x00, np.uint8)
        rows[:len(raw)] = raw
        codes[rank * len(devices) + j] = unpack_bed(
            torch.from_numpy(rows).to(dev), n, geo.n_pad, geo.pad_val)
    del reads
    log.info("mesh-level: %d devices, %d rows each", n_shards, geo.rows)
    result = ld_scores_sharded_global(codes, positions, config, m, n,
                                      has_missing, annot_mat)
    if result is None:
        return None
    if annot is not None:
        table = make_output_annot(ds.bim, result, annot_names)
    else:
        table = make_output(ds.bim, result, extra=extra)
    if not out:
        return table
    write_l2(table, out)
    if write_m and annot is None:
        write_m_files(result, out)
    elif write_m:
        write_m_files_annot(result, annot_mat, annot_names, out)
    return None


def estimate_lds_multihost(bfiles: list, out_template: str = "{stem}.L2",
                           **kwargs) -> list:
    """Job-level driver: this process's chromosomes of ``bfiles`` (the
    same list on every process; :func:`assign_chromosomes`), each through
    ``pipeline.estimate_lds(bfile, out=out_template.format(stem=...),
    **kwargs)`` with ``stem`` the bfile's ``Path.stem`` (for ``1000G.EUR.22``
    that is ``1000G.EUR``, as in the reference).  Returns the output
    paths this process wrote."""
    from ..ld.pipeline import estimate_lds  # noqa: PLC0415

    rank = _group()[0]
    outs = []
    for bfile in assign_chromosomes(bfiles):
        out = out_template.format(stem=Path(bfile).stem)
        log.info("host %d: chromosome %s -> %s", rank, bfile, out)
        estimate_lds(bfile, out=out, **kwargs)
        outs.append(out)
    return outs
