from .errors import NLDSCDataError, NLDSCError, NLDSCParameterError
from .logging import get_logger, log
from .timing import STAGE_TIMES, elapsed_time

__all__ = ["NLDSCError", "NLDSCParameterError", "NLDSCDataError",
           "get_logger", "log", "STAGE_TIMES", "elapsed_time"]
