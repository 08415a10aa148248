"""``encoder_ms.<kind>``: the text encoder's self device ms a step, the
phase spans ``text`` (its forward) and ``text_backward`` (stage 1's
backward through it; stage 2 has none), by launch correlation
(``spans.reduce``, ``tracing.phase_ms``)."""

from portbench.tracing import phase_ms


def read(ctx):
    return phase_ms(ctx["trace"], ("text", "text_backward"))
