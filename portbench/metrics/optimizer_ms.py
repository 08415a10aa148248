"""``optimizer_ms.<kind>``: the optimizers' device ms a step, every
``optimizer`` span (each Adam or AdamW update, wherever it runs), by
launch correlation (``tracing.phase_ms``)."""

from portbench.tracing import phase_ms


def read(ctx):
    return phase_ms(ctx["trace"], ("optimizer",))
