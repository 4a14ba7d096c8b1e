"""2-D (SNP x sample) sharded LD scores.

Port of ``nldsc_tpu/parallel/grid_sharded.py``: a grid is a list of rows
of devices (``mesh.grid_devices``).  It composes the two axes: the rows
of the grid shard the SNPs as the full-band body of
:mod:`.sharded` does (each row receives its neighbours' halo rows, column
by column: device (r, q) from devices (r ± k, q)), and the devices of a
row shard the samples as :mod:`.sample_sharded` does (class counts and
every tile's products summed exactly on the row's first device, which
runs the epilogue).  Every output row is computed by one row of the
grid; the result is bitwise invariant in the grid's shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io.plink import PackedBed
from ..ld import ld_int8
from . import sample_sharded, sharded


def ld_scores_grid_sharded(genotypes, positions: np.ndarray, config, grid,
                           annot=None) -> dict:
    """In-core LD scores over a grid of devices, rows x columns
    (``nldsc_tpu/parallel/grid_sharded.py:207``): the integer full band.
    ``genotypes``: int8 (M, N) codes or a
    :class:`~nldsc_tpu_torch.io.plink.PackedBed`; ``annot``: optional
    (M, p) annotation matrix (rows sharded with the SNPs).  The result
    contract of ``pipeline.compute_ld_scores``."""
    grid = [[torch.device(d) for d in row] for row in grid]
    if len({len(row) for row in grid}) != 1:
        raise ValueError("every row of the grid needs as many devices")
    m, n = genotypes.shape
    has_missing = (genotypes.has_missing if isinstance(genotypes, PackedBed)
                   else bool((np.asarray(genotypes) < 0).any()))
    cfg = dataclasses.replace(config, use_int8=True, symmetric=False)
    geo = sharded.sharded_geometry(m, n, positions, cfg, len(grid), "cpu",
                                   has_missing)
    rows, n_pad, packed = sample_sharded.host_rows(genotypes, geo.m_pad,
                                                   len(grid[0]))
    dot_dtype = config.int8_dot_dtype
    ld_int8.check_dot_dtype(dot_dtype, n_pad)
    a_host = sharded.annot_rows(annot, m, geo.m_pad)
    L = geo.rows
    shards = []
    for s, devs in enumerate(grid):
        lead = devs[0]
        span = slice(s * L, (s + 1) * L)
        mats, pre = sample_sharded.sample_preprocess(
            sample_sharded.scatter_columns(rows[span], packed, n, devs),
            torch.from_numpy(geo.pos_ok[span]).to(lead), config.maf_thr, n,
            n_pad, has_missing)
        shard_rows = {
            "scal": ld_int8.stack_scalars(pre), "usable": pre["usable"],
            "dom_ok": pre["usable"] & (pre["rstd"]
                                       > ld_int8.f32(config.std_thr)),
            "add_sd_zero": pre["add_sd_zero"]}
        if a_host is not None:
            shard_rows["annot"] = torch.from_numpy(a_host[span]).to(lead)
        shards.append({"devices": devs, "mats": mats, "rows": shard_rows,
                       "stats": (pre["maf"], pre["rstd"])})
    del rows

    def tile(mats, shard_rows, lead):
        for x in mats:
            ld_int8.to_operands(x, dot_dtype)
        return ld_int8.dots_tile(
            sample_sharded.summed_products(mats, lead, has_missing,
                                           dot_dtype),
            shard_rows["scal"], n, n_pad, has_missing)

    accs = sharded.full_band_pass(shards, geo, cfg, tile)
    return sharded.finish_shards(accs, shards, a_host, m)
