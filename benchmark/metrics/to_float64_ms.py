"""``to_float64_ms``: the conversion of the fetched outputs to float64
and int64 on the host (the program's span ``ld.to_float64``): the wall
time of the trace's ``nldsc.ld.to_float64`` ranges per traced call."""

from .program_spans import host_range_ms


def read(ctx: dict) -> float | None:
    return host_range_ms(ctx, "ld.to_float64")
