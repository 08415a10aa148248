"""``device_idle_pct.<kind>``: the share of an untraced step in which no
kernel, copy or fill ran on the card: one less the device's busy seconds
a step, from the traced stretch, over the measured window's seconds a
step. The traced stretch's own wall time is not used: recording slows a
launch-bound step's host, which would count as idle."""


def read(ctx):
    r, w = ctx["trace"], ctx["window"]
    if not w["steps"]:
        return None
    return 100.0 * (1.0 - (r["busy_s"] / r["steps"]) / (w["seconds"] / w["steps"]))
