"""``critic_ms.<kind>``: the critic's self device ms a step, the phase
span ``critic`` (its ``n_critic`` iterations with the gradient penalty,
less the nested ``optimizer``), by launch correlation
(``tracing.phase_ms``)."""

from portbench.tracing import phase_ms


def read(ctx):
    return phase_ms(ctx["trace"], ("critic",))
