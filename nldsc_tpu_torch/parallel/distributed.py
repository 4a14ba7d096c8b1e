"""Multi-process scaffolding on ``torch.distributed``, and the mesh-level
``ld`` run in its single-process form.

Port of the single-process part of ``nldsc_tpu/parallel/distributed.py``
(``:32-190``):

1. **Job-level scale-out**: :func:`assign_chromosomes` deals the
   chromosome files round-robin over the processes of an initialized
   process group (``ld-genome`` takes its chromosomes through it); without
   one, this process is rank 0 of 1 and takes them all.
2. **Mesh-level (one chromosome across devices)**:
   :func:`estimate_lds_mesh` reads each device's own byte range of the
   SNP-major .bed (a SNP range is a contiguous byte range), sends it to
   that device and runs the SNP-sharded engine
   (``sharded.ld_scores_sharded_global``) on the rows where they lie: no
   step holds the whole unpacked matrix.  Its multi-process form (halos
   across processes) is not ported: it raises with more than one process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import NLDSCParameterError
from ..core.logging import log
from .mesh import visible_devices


def _group() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join a process group of ``num_processes`` (no-op for one): the
    coordinator's ``host:port``, this process's rank ``process_id``, the
    backend ``nccl`` with a card, else ``gloo``."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise NLDSCParameterError("a process group needs the coordinator's "
                                  "address and this process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
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
    as ``pipeline.estimate_lds`` does."""
    from ..config import LDConfig  # noqa: PLC0415
    from ..io.ldscores import (make_output, make_output_annot,  # noqa: PLC0415
                               read_annot, write_l2, write_m_files,
                               write_m_files_annot)
    from ..io.plink import PlinkDataset, _packed_has_missing  # noqa: PLC0415
    from ..ld.preprocess import unpack_bed  # noqa: PLC0415
    from .sharded import ld_scores_sharded_global, sharded_geometry  # noqa: PLC0415

    if _group()[1] > 1:
        raise NLDSCParameterError(
            "estimate_lds_mesh across processes is not ported (ROADMAP "
            "queue 1, slice 10b); run one process per host")
    ds = PlinkDataset.parse(bfile)
    m, n = ds.n_snp, ds.n_samples
    config = LDConfig(
        ld_wind=ld_wind, wind_metric=wind_metric, maf_thr=maf_thr,
        std_thr=std_thr, rsq_thr=rsq_thr, block_size=block_size,
    ).resolve_rsq(m)
    positions = ds.positions(config.wind_metric)
    devices = [torch.device(d) for d in (
        visible_devices(device) if devices is None else devices)]
    annot_mat = annot_names = None
    if annot is not None:
        annot_mat, annot_names = read_annot(annot, ds.bim)

    # the row layout (independent of the missing state), then one read
    # per device: byte ranges of the .bed; rows past it are padding
    geo = sharded_geometry(m, n, positions, config, len(devices),
                           devices[0].type, annot=annot is not None)
    reads = []
    for r0, r1, _ in device_row_ranges(geo.m_pad, devices):
        s1 = min(r1, m)
        reads.append(ds.bed.read_raw(r0, s1 - r0).raw if s1 > r0 else
                     np.zeros((0, ds.bed.bytes_per_snp), np.uint8))
    has_missing = any(_packed_has_missing(r, n) for r in reads)
    geo = sharded_geometry(m, n, positions, config, len(devices),
                           devices[0].type, has_missing, annot is not None)
    codes = []
    for raw, dev in zip(reads, devices):
        rows = np.full((geo.rows, ds.bed.bytes_per_snp),
                       0x55 if geo.pad_val == -1 else 0x00, np.uint8)
        rows[:len(raw)] = raw
        codes.append(unpack_bed(torch.from_numpy(rows).to(dev), n,
                                geo.n_pad, geo.pad_val))
    del reads
    log.info("mesh-level: %d devices, %d rows each", len(devices), geo.rows)
    result = ld_scores_sharded_global(codes, positions, config, m, n,
                                      has_missing, annot_mat)
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
