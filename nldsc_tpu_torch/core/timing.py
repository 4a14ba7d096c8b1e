from __future__ import annotations

import time
from datetime import timedelta
from functools import wraps

from .logging import log

#: stage decomposition of the LAST ``estimate_lds`` call (seconds):
#: ``disk_s`` (.bim/.fam parse and .bed read), ``transfer_s`` (host to
#: device copy of the packed bytes), ``device_s`` (unpack, preprocess,
#: LD pass and the fetch of the results), ``write_s`` (.L2 and sidecars).
STAGE_TIMES: dict[str, float] = {}


def stage_add(key: str, t0: float) -> None:
    STAGE_TIMES[key] = STAGE_TIMES.get(key, 0.0) + (time.time() - t0)


def elapsed_time(func):
    """Wall-clock logging decorator."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        log.info("Elapsed time: %s", timedelta(seconds=time.time() - start))
        return result

    return wrapper
