"""Drop-in compatibility surface for users of the reference's native API.

Port of ``nldsc_tpu/compat.py``.  The reference exposes a low-level API
(``nldsc/ldscore/_ldscore.pyi``): ``LDScoreParams`` (constructed with
``bfile, n_snp, n_org, ld_wind, maf, std_thr, rsq_thr, positions``),
``LDScoreResult`` (7 per-SNP vectors) and ``calculate(params)``.  This
module gives the same names and fields on top of the port's engines, so
code written against ``from ldscore import _ldscore as lds`` ports by
changing one import.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .config import LDConfig
from .io.plink import BedReader
from .ld import pipeline, streaming


@dataclass
class LDScoreParams:
    """Reference ``LDScoreParams`` (data.h:33-66)."""

    bfile: str = ""
    n_snp: int = 0
    n_org: int = 0
    ld_wind: float = 0.0
    maf: float = 0.0
    std_thr: float = 0.0
    rsq_thr: float = 0.0
    positions: list = field(default_factory=list)


@dataclass
class LDScoreResult:
    """Reference ``LDScoreResult`` (data.h:21-31)."""

    l2: list = field(default_factory=list)
    l2d: list = field(default_factory=list)
    maf: list = field(default_factory=list)
    residuals_std: list = field(default_factory=list)
    l2_ws: list = field(default_factory=list)
    l2d_ws: list = field(default_factory=list)
    l2d_wse: list = field(default_factory=list)


def calculate(params: LDScoreParams, *, device="cuda",
              **engine_kwargs) -> LDScoreResult:
    """Reference ``lds.calculate`` on the port's engines.

    ``positions`` already carry bp or cM values and ``ld_wind`` is in the
    same unit, as in the reference C++ layer, which knows no metric
    ('bp' has the wider validation bound, so cM windows pass too).
    ``engine_kwargs`` are :class:`~.config.LDConfig` fields
    (``block_size``, ``use_int8``, ``symmetric``, ...).  The packed
    ``.bed`` is read whole and unpacked on ``device``, unless
    :func:`~.ld.pipeline.wants_streaming` says that the engine's in-core
    working set would not fit (the reference's 8 GiB rule on the CPU, the
    free device memory on CUDA): then it streams.  ``device`` defaults to
    ``cuda`` and raises without a GPU.
    """
    dev = pipeline.resolve_device(device)
    reader = BedReader(params.bfile, n_snp=params.n_snp,
                       n_samples=params.n_org)
    positions = np.asarray(params.positions, dtype=np.float64)
    config = LDConfig(ld_wind=params.ld_wind, wind_metric="bp",
                      maf_thr=params.maf, std_thr=params.std_thr,
                      rsq_thr=params.rsq_thr, **engine_kwargs)
    engine = "f32" if config.use_int8 is False else config.int8_dot_dtype
    if pipeline.wants_streaming(params.n_snp, params.n_org, dev, engine):
        res = streaming.compute_ld_scores_streaming(reader, positions,
                                                    config, device=dev)
    else:
        res = pipeline.compute_ld_scores(reader.read_raw(), positions,
                                         config, device=dev)
    return LDScoreResult(
        l2=list(res["l2"]), l2d=list(res["l2d"]), maf=list(res["maf"]),
        residuals_std=list(res["residuals_std"]),
        l2_ws=list(res["l2_ws"]), l2d_ws=list(res["l2d_ws"]),
        l2d_wse=list(res["l2d_wse"]),
    )
