"""``unpack_ms``: the program's span ``ld.unpack``
(``preprocess.unpack_bed``: the packed rows' 2-bit codes to int8 on the
card); its ``device_ms``, the span's length on the card's stream, idle
time included, mean over the traced calls."""

from .program_spans import span_device_ms


def read(ctx: dict) -> float | None:
    return span_device_ms(ctx, "ld.unpack")
