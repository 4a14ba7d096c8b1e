"""``finalize_ms``: the program's span ``ld.finalize`` (the
δ-credits' adds, ``finalize_outputs`` and ``finalize_annot``); its
``device_ms``, the span's length on the card's stream, idle time
included, mean over the traced calls."""

from .program_spans import span_device_ms


def read(ctx: dict) -> float | None:
    return span_device_ms(ctx, "ld.finalize")
