"""The plain reference of the LD-score pass (``ld.py``): float64 PyTorch,
independent of the program under test."""
