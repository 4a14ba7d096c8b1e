"""``preprocess_ms``: the program's span ``ld.preprocess``
(``ld_int8.preprocess_int8``: class counts, per-SNP scalars and the
operands' masks; ``dom_ok`` and ``stack_scalars``); its ``device_ms``,
the span's length on the card's stream, idle time included, mean over the
traced calls."""

from .program_spans import span_device_ms


def read(ctx: dict) -> float | None:
    return span_device_ms(ctx, "ld.preprocess")
