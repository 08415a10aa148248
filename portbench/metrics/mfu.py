"""``mfu.<kind>``: the whole step's share of the card's dense bf16 peak.
Model FLOPs of one step, counted over the plain reference's step at the
cell's shapes (``System.flops_per_step``, never over the program's own
step, so that moving work into a kernel cannot change the count), times
the steps of the run's measured window, over its seconds and the card's peak."""


def read(ctx):
    peak = ctx["peaks"].get("bf16_flops")
    w = ctx["window"]
    if not peak or not w["steps"]:
        return None
    return 100.0 * ctx["flops_per_step"] * w["steps"] / w["seconds"] / peak
