"""``launches_per_step.<kind>``: kernels launched on the card per step in
the traced stretch: the host's launch cost that CUDA graphs or fusion
would cut."""


def read(ctx):
    r = ctx["trace"]
    return sum(n for n, _ in r["kernels"].values()) / r["steps"]
