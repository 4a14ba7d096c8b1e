"""``annot_prep_ms``: the annotations' float32 conversion and padding on
the host before their upload (the program's span ``ld.annot_prep``): the
wall time of the trace's ``nldsc.ld.annot_prep`` ranges per traced
call."""

from .program_spans import host_range_ms


def read(ctx: dict) -> float | None:
    return host_range_ms(ctx, "ld.annot_prep")
