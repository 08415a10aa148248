"""``toy_step_ms.<kind>``: the toy step's device ms a step, its one phase
span."""

from portbench.tracing import phase_ms


def read(ctx):
    return phase_ms(ctx["trace"], ("toy_step",))
