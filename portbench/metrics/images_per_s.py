"""``images_per_s.<kind>``: the run's measured rate, images of every
rank's steps in the window over its seconds (the same number as the
one-card cells' end-to-end rate), read in the traced run of a cell whose
host-bound rate spreads too widely between runs to hold a bound."""


def read(ctx):
    w = ctx["window"]
    if not w["steps"]:
        return None
    return ctx["images_per_step"] * w["steps"] / w["seconds"]
