"""The frozen roofline arithmetic of the port's kernels (``roofline.py``)."""
