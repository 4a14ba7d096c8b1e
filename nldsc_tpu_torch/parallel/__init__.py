"""Multi-device LD scores: the SNP axis (:mod:`.sharded`), the sample
axis (:mod:`.sample_sharded`), the 2-D grid (:mod:`.grid_sharded`) on
explicit device layouts (:mod:`.mesh`), and the process-group scaffolding
(:mod:`.distributed`)."""

from .grid_sharded import ld_scores_grid_sharded
from .mesh import grid_devices, snp_devices
from .sample_sharded import ld_scores_sample_sharded
from .sharded import ld_scores_sharded

__all__ = ["grid_devices", "ld_scores_grid_sharded",
           "ld_scores_sample_sharded", "ld_scores_sharded", "snp_devices"]
