"""``generator_ms.<kind>``: the generator side's self device ms a step,
the phase span ``generator`` (its forward, the critic's score of its
images, the KL term and the gradients of its loss, in stage 1 down to
the text embedding), by launch correlation (``tracing.phase_ms``)."""

from portbench.tracing import phase_ms


def read(ctx):
    return phase_ms(ctx["trace"], ("generator",))
