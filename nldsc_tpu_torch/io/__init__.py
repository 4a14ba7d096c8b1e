from .plink import BedReader, PlinkDataset, read_bim, read_fam, write_plink

__all__ = ["PlinkDataset", "BedReader", "read_bim", "read_fam", "write_plink"]
