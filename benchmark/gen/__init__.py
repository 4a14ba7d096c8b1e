"""Input generators: one general generator that every cell's parameters
drive (``chromosome.py``)."""
