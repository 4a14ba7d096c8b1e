"""``operands_ms``: the program's span ``ld.operands`` (the split
route's compact missing rows or the global route's full indicators, and
``ld_int8.to_operands``); its ``device_ms``, the span's length on the
card's stream, idle time included, mean over the traced calls."""

from .program_spans import span_device_ms


def read(ctx: dict) -> float | None:
    return span_device_ms(ctx, "ld.operands")
